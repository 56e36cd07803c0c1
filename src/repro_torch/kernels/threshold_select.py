"""Range and histogram passes of the histogram-CDF selection.

Port of ``minmax_kernel``, ``histogram_kernel`` and ``histogram_with_range``
of ``repro/kernels/threshold_select.py`` (the radix rank-select pair of that
module belongs to a later slice).  The CUDA kernels live in
``csrc/threshold_select.cu``; ``minmax_plain`` and ``histogram_plain`` are
their plain PyTorch versions.  Both return *raw* reductions: ``minmax`` gives
``[BIG, -BIG]`` when nothing is valid, and callers fold ``lo = min(lo, hi)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend

#: Sentinel of the masked min/max (finite, so lo - hi stays finite).
BIG = 3.4e38
#: Partial results of the min/max range pass: at most this many blocks.
_MINMAX_BLOCKS = 1024
_THREADS = 256


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


def histogram_plain(loss: torch.Tensor, valid: torch.Tensor,
                    lo_hi: torch.Tensor, bins: int = 512) -> torch.Tensor:
    """(bins,) i32 count of the valid losses over the raw ``[lo, hi]``."""
    hi = lo_hi[1]
    lo = torch.minimum(lo_hi[0], hi)
    idx = bin_index(loss, lo, hi, bins)
    hist = torch.zeros(bins, dtype=torch.int32, device=loss.device)
    return hist.index_add_(0, idx, valid.to(torch.int32))


def _check(name: str, loss: torch.Tensor, valid: torch.Tensor,
           **extra: torch.Tensor) -> torch.device:
    if loss.dim() != 1 or valid.shape != loss.shape:
        raise ValueError(f"{name}: want loss (N,) and valid (N,); got "
                         f"{tuple(loss.shape)} and {tuple(valid.shape)}")
    dev = backend.check_cuda(name, {"loss": loss, "valid": valid, **extra})
    if loss.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"{name}: want float32 loss and bool valid; got "
                         f"{loss.dtype} and {valid.dtype}")
    if loss.numel() >= 2 ** 31:
        raise ValueError(f"{name}: N={loss.numel()} too large")
    return dev


def minmax(loss: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Kernel B2: (2,) f32 raw ``[lo, hi]`` on the loss's device."""
    if loss.device.type == "cpu" and valid.device.type == "cpu":
        return minmax_plain(loss, valid)
    dev = _check("minmax", loss, valid)
    n = loss.numel()
    blocks = max(1, min(_MINMAX_BLOCKS, -(-n // (_THREADS * 4))))
    partial = torch.empty(2 * blocks, dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    backend.launch("ts_minmax", "minmax", dev, loss.data_ptr(),
                   valid.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
                   blocks)
    return out


def histogram(loss: torch.Tensor, valid: torch.Tensor, lo_hi: torch.Tensor,
              bins: int = 512) -> torch.Tensor:
    """Kernel B3: (bins,) i32 histogram over the (2,) f32 raw ``[lo, hi]``
    device array (``lo = min(lo, hi)`` is folded inside, as
    ``histogram_with_range`` does)."""
    if all(t.device.type == "cpu" for t in (loss, valid, lo_hi)):
        return histogram_plain(loss, valid, lo_hi, bins)
    dev = _check("histogram", loss, valid, lo_hi=lo_hi)
    if lo_hi.shape != (2,) or lo_hi.dtype != torch.float32:
        raise ValueError("histogram: lo_hi must be a (2,) float32 tensor")
    if not 1 <= bins <= 8192:
        raise ValueError(f"histogram: bins={bins} outside [1, 8192]")
    out = torch.empty(bins, dtype=torch.int32, device=dev)
    backend.launch("ts_histogram", "histogram", dev, loss.data_ptr(),
                   valid.data_ptr(), lo_hi.data_ptr(), out.data_ptr(),
                   loss.numel(), bins)
    return out


def histogram_with_range(loss: torch.Tensor, valid: torch.Tensor,
                         bins: int = 512):
    """Both passes chained on the device: ``(hist, lo_raw, hi_raw)``."""
    mm = minmax(loss, valid)
    return histogram(loss, valid, mm, bins), mm[0], mm[1]
