"""Device-resident epoch-planning ops.

Port of ``repro/core/planops.py``: the lowest-loss candidate masks
(``sort_low_mask``, ``histogram_masks``) and ``threshold_mask`` over them,
the exact rank windows (``topk_hide``, ``sort_high_mask``, through the radix
select of ``kernels/threshold_select.py``, with their stable-argsort
oracles), the samplers (``importance_probs``, ``with_replacement``,
``weighted_keep``) and the epoch order (``masked_order``,
``device_permutation``).  Everything stays on the state's device and never
waits on it; the plan crosses to the host once per epoch, in the sampler.

The JAX ops draw from a ``jax.random`` key (threefry), which has no PyTorch
counterpart, so here the random numbers are inputs: a permutation, or
uniforms in [0, 1).  Each sampler draws them from its own
``torch.Generator`` (seeded by ``strategy_seed``), and the parity tests hand
in the reference's.  Single-device only: the mesh's ``axis_names`` psum
belongs to a later slice.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import threshold_select as ts

#: Histogram resolution of the threshold paths (shared with core/selection).
HIST_BINS = ts.HIST_BINS


def strategy_seed(seed: int, name: str) -> int:
    """The ``torch.Generator`` seed of strategy ``name`` at ``seed``: a
    stable hash of the name folded into the seed, so strategies sharing one
    config seed draw from different streams (``strategy_key``'s convention;
    the numbers differ from threefry's)."""
    return ((seed & 0xFFFFFFFF) << 32) | (zlib.crc32(name.encode()) & 0x7FFFFFFF)


def _f32(x, device) -> torch.Tensor:
    return ts.device_scalar(x, torch.float32, device)


def make_generator(seed: int, name: str, device: torch.device) -> torch.Generator:
    """The ``torch.Generator`` of strategy ``name`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(strategy_seed(seed, name))
    return gen


def generator_state(gen: torch.Generator) -> np.ndarray:
    """``gen``'s state as a uint8 array (a checkpoint leaf): the port's
    ``key_data``."""
    return gen.get_state().numpy().copy()


def load_generator_state(gen: torch.Generator, arr) -> None:
    """Set ``gen`` to a state from ``generator_state`` (``load_key``): the
    same object, so whatever holds ``gen`` (a captured graph) sees it."""
    gen.set_state(torch.as_tensor(np.asarray(arr, np.uint8)).cpu())


def device_permutation(gen: torch.Generator, n: int) -> torch.Tensor:
    """Uniform permutation of ``range(n)`` on ``gen``'s device: the epoch
    shuffle."""
    return torch.randperm(n, generator=gen, device=gen.device)


def uniform(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n,) float32 uniforms in [0, 1) on ``gen``'s device."""
    return torch.rand(n, generator=gen, device=gen.device)


def masked_order(perm: torch.Tensor, mask: torch.Tensor):
    """``(order, num_masked)``: ``perm`` stable-sorted by ``mask`` so the
    kept (False) entries come first, in shuffled order."""
    order = perm[torch.argsort(mask[perm].to(torch.uint8), stable=True)]
    return order, mask.sum().to(torch.int32)


def sort_low_mask(loss: torch.Tensor, fraction) -> torch.Tensor:
    """Mask of the ``floor(fraction * N)`` lowest losses (stable argsort,
    ``jnp.argsort``'s default).  The paper-faithful O(N log N) path."""
    n = loss.shape[0]
    num_hide = ts.fraction_count(fraction, n, loss.device)
    order = torch.argsort(loss, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=loss.device)
    rank[order] = torch.arange(n, device=loss.device)
    return rank < num_hide


def stable_rank_order(scores: torch.Tensor) -> torch.Tensor:
    """(N,) int32 rank of each score under a stable ascending sort (ties by
    index): the O(N log N) oracle of ``topk_hide``."""
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    rank = torch.empty(n, dtype=torch.int32, device=scores.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=scores.device)
    return rank


def topk_hide(scores: torch.Tensor, k) -> torch.Tensor:
    """Mask of the ``k`` smallest scores, ties by index (FORGET's prune
    set): equal to ``stable_rank_order(scores) < k``, by the radix
    count-then-select (the rank-select kernel on the card) instead of a sort."""
    return kernel_ops.rank_select(scores, k)


def sort_high_mask(loss: torch.Tensor, valid: torch.Tensor,
                   fraction) -> torch.Tensor:
    """Mask of the highest-loss ``floor(fraction * N)`` among the valid
    samples (DropTop), ties broken as a stable ascending argsort does.

    Invalid and non-finite losses rank below everything, so they never
    occupy the top window.  By the radix select (high variant); equal to
    ``sort_high_mask_argsort``, the oracle.
    """
    valid = valid & torch.isfinite(loss)
    keyed = torch.where(valid, loss, -torch.inf)
    num_top = ts.fraction_count(fraction, loss.shape[0], loss.device)
    return kernel_ops.rank_select(keyed, num_top, high=True) & valid


def sort_high_mask_argsort(loss: torch.Tensor, valid: torch.Tensor,
                           fraction) -> torch.Tensor:
    """The O(N log N) ``sort_high_mask``: the parity oracle."""
    valid = valid & torch.isfinite(loss)
    rank = stable_rank_order(torch.where(valid, loss, -torch.inf))
    n = loss.shape[0]
    return (rank >= n - ts.fraction_count(fraction, n, loss.device)) & valid


def _valid_mean(loss: torch.Tensor, valid: torch.Tensor):
    """(mean of the valid losses with 0 for none, their count)."""
    cnt = valid.sum()
    total = torch.where(valid, loss, 0.0).sum()
    return total / torch.clamp(cnt, min=1), cnt


def importance_probs(loss: torch.Tensor, valid: torch.Tensor,
                     smoothing: float) -> torch.Tensor:
    """Loss-proportional draw probabilities (ISWR).

    Never-seen samples take the mean seen loss (1.0 when nothing is seen);
    ``smoothing`` keeps zero-loss samples drawable; a non-finite loss counts
    as not seen.
    """
    valid = valid & torch.isfinite(loss)
    mean, cnt = _valid_mean(loss, valid)
    fill = torch.where(cnt > 0, mean, 1.0)
    smoothed = torch.where(valid, loss, fill) + smoothing
    return smoothed / smoothed.sum()


def with_replacement(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(N,) int32 categorical draws with replacement from ``p`` by inverse
    CDF, given (N,) uniforms ``u`` in [0, 1)."""
    n = p.shape[0]
    cdf = torch.cumsum(p, 0)
    x = u * cdf[-1]
    idx = torch.searchsorted(cdf, x, side="right")
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def weighted_keep(loss: torch.Tensor, valid: torch.Tensor, prune_ratio: float,
                  u: torch.Tensor):
    """InfoBatch soft pruning: ``(prune_mask, weights)``.

    Prunes the below-mean valid samples whose uniform ``u`` falls below
    ``prune_ratio`` and weights every kept below-mean sample by
    ``1/(1 - r)``.  Non-finite losses count as not valid.
    """
    valid = valid & torch.isfinite(loss)
    mean, _ = _valid_mean(loss, valid)
    below = valid & (loss < mean)
    prune = below & (u < prune_ratio)
    # 1 / (1 - r) in float32, as the reference traces it (not in float64)
    one = _f32(1.0, loss.device)
    up = torch.div(one, one - _f32(prune_ratio, loss.device))
    weights = torch.where(below & ~prune, up, one)
    return prune, weights


def histogram_masks(loss: torch.Tensor, valid: torch.Tensor, low_fraction,
                    high_fraction: float = 0.0, *, bins: int = HIST_BINS,
                    use_kernel: bool = False):
    """Histogram-CDF threshold masks ``(low_mask, high_mask)``.

    One pass builds the histogram of the valid losses; the CDF walk gives
    the lowest-loss candidate mask for ``low_fraction`` and, when
    ``high_fraction > 0``, the mirrored top-tail mask (DropTop; else
    ``None``).  The boundary bin is included only if leaving it out would
    under-fill by more than half its population, so the count can pass
    ``floor(F * N)`` by at most half a bin.  Non-finite losses count as
    invalid.  ``use_kernel`` goes through ``threshold_select.
    histogram_select`` (the one histogram-select kernel on a CUDA tensor,
    the plain version on a CPU one); ``False`` runs the plain composition
    on any device.
    """
    select = ts.histogram_select if use_kernel else ts.histogram_select_plain
    low_mask, high_mask, *_ = select(loss, valid, low_fraction, high_fraction,
                                     bins)
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
