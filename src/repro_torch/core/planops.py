"""Device-resident epoch-planning ops (the subset of this slice).

Port of ``repro/core/planops.py``: the lowest-loss candidate masks
(``sort_low_mask``, ``histogram_masks``), ``threshold_mask`` over them, and
``masked_order``.  Everything stays on the state's device and never waits on
it; the plan crosses to the host once per epoch, in the sampler.

The JAX ops draw their shuffle from a ``jax.random`` key (threefry), which
has no PyTorch counterpart, so here the permutation is an input: the sampler
draws it from a ``torch.Generator``, and the parity tests hand in the
reference's.  Single-device only: the mesh's ``axis_names`` psum belongs to
a later slice.
"""
from __future__ import annotations

import zlib

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import threshold_select as ts

#: Histogram resolution of the threshold paths (shared with core/selection).
HIST_BINS = 512


def strategy_seed(seed: int, name: str) -> int:
    """The ``torch.Generator`` seed of strategy ``name`` at ``seed``: a
    stable hash of the name folded into the seed, so strategies sharing one
    config seed draw from different streams (``strategy_key``'s convention;
    the numbers differ from threefry's)."""
    return ((seed & 0xFFFFFFFF) << 32) | (zlib.crc32(name.encode()) & 0x7FFFFFFF)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def masked_order(perm: torch.Tensor, mask: torch.Tensor):
    """``(order, num_masked)``: ``perm`` stable-sorted by ``mask`` so the
    kept (False) entries come first, in shuffled order."""
    order = perm[torch.argsort(mask[perm].to(torch.uint8), stable=True)]
    return order, mask.sum().to(torch.int32)


def sort_low_mask(loss: torch.Tensor, fraction) -> torch.Tensor:
    """Mask of the ``floor(fraction * N)`` lowest losses (stable argsort,
    ``jnp.argsort``'s default).  The paper-faithful O(N log N) path."""
    n = loss.shape[0]
    num_hide = torch.floor(_f32(fraction, loss.device) * n).to(torch.int32)
    order = torch.argsort(loss, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=loss.device)
    rank[order] = torch.arange(n, device=loss.device)
    return rank < num_hide


def _cdf_walk(hist: torch.Tensor, count: torch.Tensor):
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


def histogram_masks(loss: torch.Tensor, valid: torch.Tensor, low_fraction,
                    high_fraction: float = 0.0, *, bins: int = HIST_BINS,
                    use_kernel: bool = False):
    """Histogram-CDF threshold masks ``(low_mask, high_mask)``.

    One pass builds the histogram of the valid losses (with kernels B2/B3
    when ``use_kernel``); the CDF walk gives the lowest-loss candidate mask
    for ``low_fraction`` and, when ``high_fraction > 0``, the mirrored
    top-tail mask (DropTop).  The boundary bin is included only if leaving it
    out would under-fill by more than half its population, so the count can
    pass ``floor(F * N)`` by at most half a bin.  Non-finite losses count as
    invalid.
    """
    dev = loss.device
    n = loss.shape[0]
    valid = valid & torch.isfinite(loss)
    num_hide = torch.floor(_f32(low_fraction, dev) * n).to(torch.int32)
    if use_kernel:
        lo, hi = kernel_ops.loss_minmax(loss, valid)
    else:
        lo, hi = ts.minmax_plain(loss, valid)
    lo = torch.minimum(lo, hi)          # degenerate all-invalid input
    idx = ts.bin_index(loss, lo, hi, bins)
    if use_kernel:
        hist = kernel_ops.loss_histogram(loss, valid, lo, hi, bins)
    else:
        hist = ts.histogram_plain(loss, valid, torch.stack([lo, hi]), bins)
    b, include_b = _cdf_walk(hist, num_hide)
    low_mask = torch.where(include_b, idx <= b, idx < b) & valid

    high_mask = None
    if high_fraction > 0.0:
        num_top = torch.floor(_f32(high_fraction, dev) * n).to(torch.int32)
        bt, include_bt = _cdf_walk(hist.flip(0), num_top)
        b_top = bins - 1 - bt
        high_mask = torch.where(include_bt, idx >= b_top, idx > b_top) & valid
    return low_mask, high_mask


def threshold_mask(loss: torch.Tensor, valid: torch.Tensor, fraction, *,
                   method: str = "sort", bins: int = HIST_BINS,
                   use_kernel: bool = False) -> torch.Tensor:
    """Lowest-loss candidate mask, by any selection method."""
    if method == "sort":
        return sort_low_mask(loss, fraction)
    if method in ("histogram", "histogram_pallas"):
        low, _ = histogram_masks(
            loss, valid, fraction, bins=bins,
            use_kernel=use_kernel or method == "histogram_pallas")
        return low
    raise ValueError(f"unknown selection method {method!r}")
