"""Threshold selection: the histogram-CDF selection and the exact radix select.

Port of ``repro/kernels/threshold_select.py``:

- ``histogram_select`` (B2 and B3 in one kernel, with the CDF walks and
  the masks of ``repro/core/planops.py::histogram_masks``): one persistent
  CUDA kernel in ``csrc/threshold_select.cu`` takes the range of the valid
  losses (B2's function), their ``bins``-bin histogram (B3's), walks the
  histogram's CDF to ``floor(F * N)`` from the bottom (and, for DropTop,
  from the top) and writes the masks.  Its plain version
  ``histogram_select_plain`` composes the per-stage specs ``range_plain``
  (the *raw* ``[lo, hi]``: ``[BIG, -BIG]`` when nothing is valid),
  ``count_plain`` and ``walk_plain`` (over ``bin_index`` and ``cdf_walk``).
  The same stages are kernels of their own too (``histogram_range``,
  ``histogram_count``, ``histogram_walk``), for a plan whose rows are split
  over ranks, which reduces the range and the histogram between them;
- ``rank_select`` (B4 and B5 in one kernel), the exact count-then-select
  that replaces a stable argsort where a plan needs only a rank window
  (FORGET's prune, DropTop's top tail): one persistent CUDA kernel in
  ``csrc/rank_select.cu`` builds the order keys, runs the four byte
  histograms (B4's function) with the bucket search between them, and
  writes the mask (B5's function).  Its plain version ``rank_select_plain``
  composes the per-pass specs ``order_key_bits``, ``byte_histogram_plain``,
  ``radix_threshold`` and ``select_mask_plain``.

Each kernel's plain PyTorch version (``*_plain``) sits beside it.

The radix keys are the uint32 float-order keys of the reference.  PyTorch's
uint32 support is partial (no shifts or comparisons on the CPU), so the keys
travel as their bits in an int32 tensor (``order_key_bits``), and the plain
versions widen them to int64 (0 .. 2**32 - 1) before comparing.  Prefixes
and thresholds are 0-d int64 tensors holding the uint32 value.  Nothing here
waits on the device.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.kernels import backend

#: Sentinel of the masked min/max (finite, so lo - hi stays finite).
BIG = 3.4e38
#: Histogram resolution of the threshold paths.
HIST_BINS = 512


def minmax_plain(loss: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(2,) f32 raw ``[lo, hi]`` of the valid losses."""
    big = torch.tensor(BIG, dtype=torch.float32, device=loss.device)
    lo = torch.where(valid, loss, big).amin()
    hi = torch.where(valid, loss, -big).amax()
    return torch.stack([lo, hi])


def bin_index(loss: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              bins: int) -> torch.Tensor:
    """``clip(int((loss - lo) / max(hi - lo, 1e-12) * bins), 0, bins - 1)``
    in the reference's order of operations (f32 throughout)."""
    span = torch.clamp(hi - lo, min=1e-12)
    return torch.clamp(((loss - lo) / span * bins).to(torch.int32), 0, bins - 1)


def _count_bins(idx: torch.Tensor, valid: torch.Tensor, bins: int) -> torch.Tensor:
    hist = torch.zeros(bins, dtype=torch.int32, device=idx.device)
    return hist.index_add_(0, idx, valid.to(torch.int32))


def histogram_plain(loss: torch.Tensor, valid: torch.Tensor,
                    lo_hi: torch.Tensor, bins: int = HIST_BINS) -> torch.Tensor:
    """(bins,) i32 count of the valid losses over the raw ``[lo, hi]``."""
    hi = lo_hi[1]
    return _count_bins(bin_index(loss, torch.minimum(lo_hi[0], hi), hi, bins),
                       valid, bins)


def device_scalar(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (a Python number or a tensor) as a 0-d ``dtype`` tensor on
    ``device``.  A Python number is written there by a fill kernel:
    ``torch.as_tensor`` would copy it from host memory, which waits for the
    device's stream to drain."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def fraction_count(fraction, n: int, device: torch.device) -> torch.Tensor:
    """``floor(f32(fraction) * f32(n))`` as a 0-d int32 tensor, as the
    reference computes a count from a fraction (``f32(n)`` rounds above
    2**24)."""
    f = device_scalar(fraction, torch.float32, device).reshape(())
    return torch.floor(f * n).to(torch.int32)


def cdf_walk(hist: torch.Tensor, count: torch.Tensor):
    """Boundary bin ``b`` of the CDF walk to ``count`` samples, and whether
    to include it: only if leaving it out would under-fill by more than half
    its population."""
    bins = hist.shape[0]
    cdf = torch.cumsum(hist, 0)
    b = torch.clamp(torch.searchsorted(cdf, count.reshape(1).to(cdf.dtype),
                                       side="left")[0], 0, bins - 1)
    below = torch.where(b > 0, cdf[torch.clamp(b - 1, min=0)],
                        torch.zeros_like(cdf[0]))
    return b, (count - below) * 2 >= hist[b]


def range_plain(loss: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """B2's stage of the histogram-CDF selection: the (2,) f32 raw ``[lo,
    hi]`` of the valid and finite losses."""
    return minmax_plain(loss, valid & torch.isfinite(loss))


def count_plain(loss: torch.Tensor, valid: torch.Tensor, lo_hi: torch.Tensor,
                bins: int = HIST_BINS) -> torch.Tensor:
    """B3's stage: the (bins,) i32 count of the valid and finite losses over
    the raw ``lo_hi``."""
    return histogram_plain(loss, valid & torch.isfinite(loss), lo_hi, bins)


def walk_plain(loss: torch.Tensor, valid: torch.Tensor, hist: torch.Tensor,
               lo_hi: torch.Tensor, n_count: int, low_fraction,
               high_fraction: float = 0.0):
    """The last stage: the CDF walks over ``hist`` to ``floor(F *
    n_count)`` (``n_count`` the rows ``hist`` counts, over every rank) and
    this rank's masks, ``(low_mask, high_mask, walk)`` as
    ``histogram_select_plain`` gives them."""
    dev = loss.device
    bins = hist.shape[0]
    valid = valid & torch.isfinite(loss)
    num_hide = fraction_count(low_fraction, n_count, dev)
    hi = lo_hi[1]
    idx = bin_index(loss, torch.minimum(lo_hi[0], hi), hi, bins)
    b, include_b = cdf_walk(hist, num_hide)
    low_mask = torch.where(include_b, idx <= b, idx < b) & valid
    high_mask = None
    top = (torch.zeros((), dtype=torch.int64, device=dev),) * 3
    if high_fraction > 0.0:
        num_top = fraction_count(high_fraction, n_count, dev)
        bt, include_bt = cdf_walk(hist.flip(0), num_top)
        b_top = bins - 1 - bt
        high_mask = torch.where(include_bt, idx >= b_top, idx > b_top) & valid
        top = (num_top, b_top, include_bt)
    walk = torch.stack([t.to(torch.int64)
                        for t in (num_hide, b, include_b, *top)])
    return low_mask, high_mask, walk


def histogram_select_plain(loss: torch.Tensor, valid: torch.Tensor,
                           low_fraction, high_fraction: float = 0.0,
                           bins: int = HIST_BINS):
    """The histogram-CDF selection's plain version, on the loss's device:
    ``(low_mask, high_mask, hist, lo_hi, walk)``, its three stages
    (``range_plain``, ``count_plain``, ``walk_plain``) on one rank's rows.

    ``low_mask`` holds the lowest-loss candidates for ``low_fraction``;
    ``high_mask`` the mirrored top tail for ``high_fraction > 0`` (else
    ``None``).  ``hist`` is the (bins,) i32 histogram of the valid losses,
    ``lo_hi`` their raw (2,) f32 range, ``walk`` the (6,) int64 ``(num_hide,
    b, include_b, num_top, b_top, include_bt)`` (the last three 0 without a
    top tail).  Non-finite losses count as invalid.
    """
    lo_hi = range_plain(loss, valid)
    hist = count_plain(loss, valid, lo_hi, bins)
    low_mask, high_mask, walk = walk_plain(loss, valid, hist, lo_hi,
                                           loss.shape[0], low_fraction,
                                           high_fraction)
    return low_mask, high_mask, hist, lo_hi, walk


#: Scratch of the histogram-select kernel, in int32 words
#: (``csrc/threshold_select.cu`` lays it out): the (6,) int64 walk, the (2,)
#: f32 raw range, the (bins,) histogram, then a (lo, hi) pair per block.
_HS_LOHI_WORD = 12
_HS_HIST_WORD = 14
#: (lo, hi) slots in the scratch: more than the blocks the kernel runs (at
#: most the co-resident ones: 132 on an H100's shared-memory path).
_HS_MAX_BLOCKS = 4096
#: Most bins the kernel takes (12 bytes each of shared memory).
HS_MAX_BINS = 8192


def _fraction_argument(f, dev: torch.device) -> tuple[int | None, float]:
    """``(pointer, value)`` of ``low_fraction`` for the kernel: a float32
    CUDA tensor is read on the device, a number or a CPU tensor is passed by
    value (rounded to float32, as the plain version rounds it)."""
    if isinstance(f, torch.Tensor):
        if f.numel() != 1 or not f.is_floating_point():
            raise ValueError("histogram_select: low_fraction must be one float "
                             f"value; got {tuple(f.shape)} {f.dtype}")
        if f.device.type != "cpu":
            if f.device != dev or f.dtype != torch.float32:
                raise ValueError("histogram_select: a device low_fraction must "
                                 f"be float32 on {dev}; got {f.dtype} on {f.device}")
            return f.data_ptr(), 0.0
        f = f.item()
    return None, float(f)


def _on_cpu(loss, valid, *device_args) -> bool:
    """A wrapper's choice: the plain version when every tensor is on the
    CPU (a device-resident fraction sends it to the kernel)."""
    return all(not isinstance(t, torch.Tensor) or t.device.type == "cpu"
               for t in (loss, valid, *device_args))


def _check_losses(name: str, loss: torch.Tensor, valid: torch.Tensor,
                  **more: torch.Tensor) -> torch.device:
    """The histogram wrappers' checks: (N,) float32 loss and bool valid,
    contiguous, on one CUDA device with ``more``; 1 <= N < 2**31."""
    if loss.dim() != 1 or valid.shape != loss.shape:
        raise ValueError(f"{name}: want loss (N,) and valid (N,); got "
                         f"{tuple(loss.shape)} and {tuple(valid.shape)}")
    dev = backend.check_cuda(name, {"loss": loss, "valid": valid, **more})
    if loss.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"{name}: want float32 loss and bool valid; got "
                         f"{loss.dtype} and {valid.dtype}")
    if not 1 <= loss.numel() < 2 ** 31:
        raise ValueError(f"{name}: N={loss.numel()} outside [1, 2**31)")
    return dev


def _check_bins(name: str, bins: int) -> None:
    if not 1 <= bins <= HS_MAX_BINS:
        raise ValueError(f"{name}: bins={bins} outside [1, {HS_MAX_BINS}]")


def histogram_select(loss: torch.Tensor, valid: torch.Tensor, low_fraction,
                     high_fraction: float = 0.0, bins: int = HIST_BINS):
    """Kernel B2+B3: the histogram-CDF selection in one launch,
    ``(low_mask, high_mask, hist, lo_hi, walk)`` as
    ``histogram_select_plain`` gives them.

    ``loss`` (N,) float32 and ``valid`` (N,) bool, contiguous;
    ``low_fraction`` a number, a CPU tensor or a one-element float32 tensor
    on the loss's device (read there, never copied to the host);
    ``high_fraction`` a number.  A call is two CUDA launches, the memset of
    the histogram and the kernel.  CPU tensors take the plain version.
    """
    if _on_cpu(loss, valid, low_fraction):
        return histogram_select_plain(loss, valid, low_fraction, high_fraction,
                                      bins)
    dev = _check_losses("histogram_select", loss, valid)
    _check_bins("histogram_select", bins)
    n = loss.numel()
    f_ptr, f_value = _fraction_argument(low_fraction, dev)
    scratch = torch.empty(_HS_HIST_WORD + bins + 2 * _HS_MAX_BLOCKS,
                          dtype=torch.int32, device=dev)
    low = torch.empty(n, dtype=torch.bool, device=dev)
    high = (torch.empty(n, dtype=torch.bool, device=dev)
            if high_fraction > 0.0 else None)
    backend.launch("hs_histogram_select", "histogram_select", dev,
                   loss.data_ptr(), valid.data_ptr(), f_ptr, f_value,
                   float(high_fraction), bins, scratch.data_ptr(),
                   scratch.numel(), low.data_ptr(),
                   None if high is None else high.data_ptr(), n)
    walk = scratch[:_HS_LOHI_WORD].view(torch.int64)
    lo_hi = scratch[_HS_LOHI_WORD:_HS_HIST_WORD].view(torch.float32)
    hist = scratch[_HS_HIST_WORD:_HS_HIST_WORD + bins]
    return low, high, hist, lo_hi, walk


# The staged path: the same selection as three launches, for rows split
# over ranks.  ``core/planops.py::histogram_masks`` reduces the range (min,
# max) and the histogram (sum) over the ranks between them; at one rank
# the three stages give ``histogram_select``'s bits.

def histogram_range(loss: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Kernel B2, staged: the (2,) f32 raw ``[lo, hi]`` of the valid and
    finite losses (``range_plain``), one cooperative launch.  CPU tensors
    take the plain version."""
    if _on_cpu(loss, valid):
        return range_plain(loss, valid)
    dev = _check_losses("histogram_range", loss, valid)
    out = torch.empty(2 + 2 * _HS_MAX_BLOCKS, dtype=torch.float32, device=dev)
    lo_hi = out[:2]
    backend.launch("hs_range", "histogram_range", dev, loss.data_ptr(),
                   valid.data_ptr(), out[2:].data_ptr(), _HS_MAX_BLOCKS,
                   lo_hi.data_ptr(), loss.numel())
    return lo_hi


def histogram_count(loss: torch.Tensor, valid: torch.Tensor,
                    lo_hi: torch.Tensor, bins: int = HIST_BINS) -> torch.Tensor:
    """Kernel B3, staged: the (bins,) i32 count of the valid and finite
    losses over the raw ``lo_hi`` (2,) f32 read from the device
    (``count_plain``), one cooperative launch that zeroes the histogram
    itself.  CPU tensors take the plain version."""
    if _on_cpu(loss, valid, lo_hi):
        return count_plain(loss, valid, lo_hi, bins)
    dev = _check_losses("histogram_count", loss, valid, lo_hi=lo_hi)
    _check_bins("histogram_count", bins)
    if lo_hi.shape != (2,) or lo_hi.dtype != torch.float32:
        raise ValueError("histogram_count: want lo_hi (2,) float32; got "
                         f"{tuple(lo_hi.shape)} {lo_hi.dtype}")
    hist = torch.empty(bins, dtype=torch.int32, device=dev)
    backend.launch("hs_count", "histogram_count", dev, loss.data_ptr(),
                   valid.data_ptr(), lo_hi.data_ptr(), hist.data_ptr(), bins,
                   loss.numel())
    return hist


def histogram_walk(loss: torch.Tensor, valid: torch.Tensor, hist: torch.Tensor,
                   lo_hi: torch.Tensor, n_count: int, low_fraction,
                   high_fraction: float = 0.0):
    """The staged path's last launch: both CDF walks over ``hist`` (the
    ranks' summed counts, read from the device) to ``floor(F * n_count)``,
    then this rank's masks; ``(low_mask, high_mask, walk)`` as
    ``walk_plain`` gives them.  CPU tensors take the plain version."""
    if _on_cpu(loss, valid, hist, lo_hi, low_fraction):
        return walk_plain(loss, valid, hist, lo_hi, n_count, low_fraction,
                          high_fraction)
    dev = _check_losses("histogram_walk", loss, valid, hist=hist, lo_hi=lo_hi)
    bins = hist.numel()
    _check_bins("histogram_walk", bins)
    if hist.dtype != torch.int32 or lo_hi.shape != (2,):
        raise ValueError("histogram_walk: want hist int32 and lo_hi (2,); got "
                         f"{hist.dtype} and {tuple(lo_hi.shape)}")
    if not 1 <= n_count < 2 ** 31:
        raise ValueError(f"histogram_walk: n_count={n_count} outside [1, 2**31)")
    n = loss.numel()
    f_ptr, f_value = _fraction_argument(low_fraction, dev)
    walk = torch.empty(6, dtype=torch.int64, device=dev)
    low = torch.empty(n, dtype=torch.bool, device=dev)
    high = (torch.empty(n, dtype=torch.bool, device=dev)
            if high_fraction > 0.0 else None)
    backend.launch("hs_walk", "histogram_walk", dev, loss.data_ptr(),
                   valid.data_ptr(), hist.data_ptr(), lo_hi.data_ptr(), f_ptr,
                   f_value, float(high_fraction), bins, int(n_count),
                   walk.data_ptr(), low.data_ptr(),
                   None if high is None else high.data_ptr(), n)
    return low, high, walk


# ---------------------------------------------------------------------------
# Exact count-then-select (radix select)
# ---------------------------------------------------------------------------

#: Radix passes walk the uint32 key one byte at a time, MSB first.
RADIX_SHIFTS = (24, 16, 8, 0)
_U32 = 0xFFFFFFFF


def order_key_bits(scores: torch.Tensor, high: bool = False) -> torch.Tensor:
    """The float-order keys' bits as (N,) int32: ``a < b`` iff
    ``key(a) < key(b)`` as uint32 (complemented with ``high``, so the
    largest scores get the smallest keys).

    The sign-flip map of the reference: negative floats get their bits
    inverted, the others the sign bit set.  ``-0.0`` is collapsed onto
    ``+0.0`` first by a select on ``x == 0`` (a stable argsort treats signed
    zeros as ties).  +/-inf order correctly; NaN carries payload bits, so
    callers that may see NaN mask it first.
    """
    x = scores.to(torch.float32).contiguous()
    b = torch.where(x == 0, 0, x.view(torch.int32))
    keys = torch.where(b < 0, ~b, b | -(2 ** 31))
    return ~keys if high else keys


def float_order_keys(scores: torch.Tensor) -> torch.Tensor:
    """The uint32 keys of ``order_key_bits`` as (N,) int64 values."""
    return _widen(order_key_bits(scores))


def _widen(keys: torch.Tensor) -> torch.Tensor:
    return keys.to(torch.int64) & _U32


def _prefix_mask(shift: int) -> int:
    """Key bits fixed by the radix passes before the one at ``shift``."""
    return (_U32 << (shift + 8)) & _U32 if shift < 24 else 0


def byte_histogram_plain(keys: torch.Tensor, prefix: torch.Tensor,
                         shift: int) -> torch.Tensor:
    """(256,) i32 count of byte ``shift`` among the keys whose higher bytes
    equal ``prefix`` (keys as int32 bits, prefix a 0-d int64)."""
    k = _widen(keys)
    match = (k & _prefix_mask(shift)) == prefix
    bucket = (k >> shift) & 0xFF
    hist = torch.zeros(256, dtype=torch.int32, device=keys.device)
    return hist.index_add_(0, bucket, match.to(torch.int32))


def select_mask_plain(keys: torch.Tensor, thresh: torch.Tensor,
                      tie_lo: torch.Tensor, tie_hi: torch.Tensor
                      ) -> torch.Tensor:
    """(N,) bool: ``key < thresh``, plus the ties whose 1-based running
    count in index order lies in ``(tie_lo, tie_hi]`` (the stable-argsort
    tie break)."""
    k = _widen(keys)
    tie = k == thresh
    cum = torch.cumsum(tie.to(torch.int64), 0)
    return (k < thresh) | (tie & (cum > tie_lo) & (cum <= tie_hi))


def radix_threshold(keys: torch.Tensor, k, hist_fn):
    """The exact k-th smallest key by four MSB-first byte-histogram passes.

    Returns 0-d int64 tensors ``(thresh, needed, total_ties)``: the k-th
    order statistic (for k <= 0 the all-zero key: nothing selected), how
    many of the ties at it the mask still needs, and their total count.
    ``hist_fn(keys, prefix, shift)`` is ``byte_histogram_plain`` or a
    function that returns what it returns; the bucket search between passes
    stays on the device.
    """
    dev = keys.device
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    remaining = device_scalar(k, torch.int64, dev).reshape(())
    for shift in RADIX_SHIFTS:
        hist = hist_fn(keys, prefix, shift)
        cdf = torch.cumsum(hist, 0, dtype=torch.int64)
        # bucket holding the remaining-th smallest key of the prefix subset
        b = torch.clamp(torch.searchsorted(cdf, remaining.reshape(1),
                                           side="left")[0], 0, 255)
        below = torch.where(b > 0, cdf[torch.clamp(b - 1, min=0)], 0)
        remaining = remaining - below
        prefix = prefix | (b << shift)
    # the last pass's bucket holds the exact-key matches: the ties at thresh
    return prefix, remaining, hist[b].to(torch.int64)


#: Scratch of the rank-select kernel, in int32 words (``csrc/rank_select.cu``
#: lays it out): the (4, 256) pass histograms, the int64 (thresh, needed,
#: total), then one tie count per block.
_RS_TRIPLE_WORD = len(RADIX_SHIFTS) * 256
_RS_TIE_WORD = _RS_TRIPLE_WORD + 6
#: Tie-count slots in the scratch: more than the blocks the kernel runs
#: (at most the co-resident ones, one a SM: 132 on an H100).
_RS_MAX_BLOCKS = 4096


def rank_select_plain(scores: torch.Tensor, k, high: bool = False):
    """The rank-select's plain version: ``(mask, hists, triple)``.

    ``mask`` is the (N,) bool mask of ``rank_select_mask``; ``hists`` the
    (4, 256) int32 byte histograms of the four radix passes, MSB first;
    ``triple`` the (3,) int64 ``(thresh, needed, total)`` of
    ``radix_threshold``.  Runs on the scores' device.
    """
    keys = order_key_bits(scores, high)
    hists = []

    def hist_fn(keys, prefix, shift):
        hists.append(byte_histogram_plain(keys, prefix, shift))
        return hists[-1]

    thresh, needed, total = radix_threshold(keys, k, hist_fn)
    if high:
        tie_lo, tie_hi = total - needed, total
    else:
        tie_lo, tie_hi = torch.zeros_like(needed), needed
    mask = select_mask_plain(keys, thresh, tie_lo, tie_hi)
    return mask, torch.stack(hists), torch.stack([thresh, needed, total])


def _k_argument(k, dev: torch.device) -> tuple[int, int, int]:
    """``(pointer, bytes, value)`` of ``k`` for the kernel: a CUDA tensor is
    read on the device (int32 or int64), a number or a CPU tensor is passed
    by value."""
    if isinstance(k, torch.Tensor):
        if k.numel() != 1 or k.dtype not in (torch.int32, torch.int64):
            raise ValueError("rank_select: k must be one int32 or int64 value; "
                             f"got {tuple(k.shape)} {k.dtype}")
        if k.device.type != "cpu":
            if k.device != dev:
                raise ValueError(f"rank_select: k on {k.device}, scores on {dev}")
            return k.data_ptr(), k.element_size(), 0
        k = k.item()
    k = operator.index(k)
    if abs(k) >= 2 ** 62:
        raise ValueError(f"rank_select: k={k} out of range")
    return 0, 0, k


def rank_select(scores: torch.Tensor, k, high: bool = False):
    """Kernel B4+B5: the rank-select in one launch, ``(mask, hists, triple)``
    as ``rank_select_plain`` gives them.

    ``scores`` (N,) float32, contiguous; ``k`` a number, a CPU tensor or a
    one-element int32/int64 tensor on the scores' device (read there, never
    copied to the host).  A call is two CUDA launches, the scratch's memset
    and the kernel.  CPU scores take the plain version.
    """
    if scores.device.type == "cpu" and not (
            isinstance(k, torch.Tensor) and k.device.type != "cpu"):
        return rank_select_plain(scores, k, high)
    if scores.dim() != 1:
        raise ValueError(f"rank_select: want (N,) scores; got {tuple(scores.shape)}")
    dev = backend.check_cuda("rank_select", {"scores": scores})
    if scores.dtype != torch.float32:
        raise ValueError(f"rank_select: want float32 scores; got {scores.dtype}")
    n = scores.numel()
    if n >= 2 ** 31:
        raise ValueError(f"rank_select: N={n} too large")
    k_ptr, k_bytes, k_value = _k_argument(k, dev)
    scratch = torch.empty(_RS_TIE_WORD + _RS_MAX_BLOCKS, dtype=torch.int32,
                          device=dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    backend.launch("rs_rank_select", "rank_select", dev, scores.data_ptr(),
                   k_ptr, k_bytes, k_value, int(high), scratch.data_ptr(),
                   scratch.numel(), mask.data_ptr(), n)
    hists = scratch[:_RS_TRIPLE_WORD].view(len(RADIX_SHIFTS), 256)
    triple = scratch[_RS_TRIPLE_WORD:_RS_TRIPLE_WORD + 6].view(torch.int64)
    return mask, hists, triple


def rank_select_mask(scores: torch.Tensor, k, high: bool = False,
                     use_kernel: bool = True) -> torch.Tensor:
    """Exact (N,) bool mask of the ``k`` smallest (``high``: largest) scores.

    Equal to the stable-argsort masks it replaces (non-NaN inputs):
    ``high=False`` is ``stable_rank_order(scores) < k`` (ties at the
    threshold go to the smaller indices, the first ``needed`` ties);
    ``high=True`` is rank ``>= N - k`` of a stable ascending argsort (the
    last ``needed`` ties: the window ``(total - needed, total]``).

    Five O(N) passes: four byte histograms and the mask.  ``k`` may be a
    device scalar.  ``use_kernel`` goes through ``rank_select`` (the kernel
    on a CUDA tensor, the plain version on a CPU one); ``False`` runs the
    plain version on any device.
    """
    return (rank_select if use_kernel else rank_select_plain)(scores, k, high)[0]
