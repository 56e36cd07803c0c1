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
``torch.Generator`` (seeded by ``strategy_seed``), or, where a held step
must hold the stream as a held key does, from ``counter_uniform``; the
parity tests hand in the reference's.

Under a data-parallel group (``ctx``, ``dist/sharding.py``) the ops take
row-sharded score inputs and gather them whole on every rank first
(``ctx.gather_rows``, the reference's ``_rep``), so the plan math is the
single-device computation on every rank and plans are bit-identical
across world sizes; ``histogram_masks`` instead runs its stages on the
local rows with the range and the histogram reduced over the ranks
(O(bins) communication), as the reference's does inside ``shard_map``.
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


def legacy_words(host_state) -> np.ndarray | None:
    """Two uint32 words drawn from a numpy bit-generator state (the legacy
    checkpoints' ``host["rng"]``), or None for an unreadable payload."""
    try:
        g = np.random.default_rng(0)
        g.bit_generator.state = host_state
        return g.integers(0, 2 ** 32, size=2, dtype=np.int64).astype(np.uint32)
    except (KeyError, TypeError, ValueError):
        return None


def migrate_legacy_rng(gen: torch.Generator, host_state, seed: int,
                       name: str) -> None:
    """Seed ``gen`` from a legacy numpy ``Generator`` state: with the two
    uint32 words ``legacy_words`` draws from it, the same checkpoint always
    giving the same stream; on an unreadable payload, by the seed
    convention (``strategy_seed``).  The numpy stream itself is retired, as
    in the reference: a migrated run resumes deterministically, on the
    generator's stream."""
    words = legacy_words(host_state)
    gen.manual_seed(strategy_seed(seed, name) if words is None
                    else (int(words[0]) << 32) | int(words[1]))


def restore_generator(gen: torch.Generator, state: dict, seed: int,
                      name: str, leaf: str = "rng_key") -> None:
    """Restore ``gen`` in place from a strategy ``state_dict``, current or
    legacy format (the reference's ``restore_key``): ``arrays[leaf]``
    (``generator_state``), else a legacy ``host["rng"]`` through
    ``migrate_legacy_rng``; a dict with neither raises."""
    arrays = state.get("arrays") or {}
    host = state.get("host") or {}
    if leaf in arrays:
        load_generator_state(gen, arrays[leaf])
    elif "rng" in host:
        migrate_legacy_rng(gen, host["rng"], seed, name)
    else:
        raise ValueError(
            f"state dict for {name!r} has neither arrays[{leaf!r}] nor a "
            "legacy host['rng'] entry: cannot restore the plan generator")


def device_permutation(gen: torch.Generator, n: int) -> torch.Tensor:
    """Uniform permutation of ``range(n)`` on ``gen``'s device: the epoch
    shuffle."""
    return torch.randperm(n, generator=gen, device=gen.device)


def uniform(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n,) float32 uniforms in [0, 1) on ``gen``'s device."""
    return torch.rand(n, generator=gen, device=gen.device)


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A two-round multiply-xorshift hash of the 32-bit values held in the
    int64 ``x``; both multipliers are below 2^31, so no product leaves
    int64."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def counter_key(seed: int, name: str, device: torch.device) -> torch.Tensor:
    """``counter_uniform``'s key for strategy ``name`` at ``seed``: the two
    32-bit halves of ``strategy_seed`` as a (2,) int64 device tensor (state,
    so that a checkpoint carries it and a captured step reads it)."""
    s = strategy_seed(seed, name)
    return torch.tensor([s & _M32, (s >> 32) & _M32], dtype=torch.int64,
                        device=device)


def counter_uniform(key: torch.Tensor, counter: torch.Tensor,
                    n: int) -> torch.Tensor:
    """(n,) float32 uniforms in [0, 1) on ``counter``'s device, a function
    of ``key`` (``counter_key``), the 0-dim integer tensor ``counter`` and
    the position alone: the same counter gives the same numbers, so a
    caller that holds its counter holds its stream, as a held JAX key does.
    Nothing waits on the device; the numbers repeat after 2^32 counts."""
    h = _mix32((counter.to(torch.int64) ^ key[1]) & _M32)
    i = torch.arange(n, dtype=torch.int64, device=counter.device)
    x = _mix32(_mix32(i ^ key[0]) ^ h)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _gather(x: torch.Tensor, ctx) -> torch.Tensor:
    """A row-sharded input whole on every rank (itself without a group)."""
    return x if ctx is None else ctx.gather_rows(x)


def masked_order(perm: torch.Tensor, mask: torch.Tensor, ctx=None):
    """``(order, num_masked)``: ``perm`` stable-sorted by ``mask`` so the
    kept (False) entries come first, in shuffled order."""
    mask = _gather(mask, ctx)
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


def topk_hide(scores: torch.Tensor, k, ctx=None) -> torch.Tensor:
    """Mask of the ``k`` smallest scores, ties by index (FORGET's prune
    set): equal to ``stable_rank_order(scores) < k``, by the radix
    count-then-select (the rank-select kernel on the card) instead of a
    sort.  Over every rank's scores under ``ctx``."""
    return kernel_ops.rank_select(_gather(scores, ctx), k)


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
                     smoothing: float, ctx=None) -> torch.Tensor:
    """Loss-proportional draw probabilities (ISWR), over every rank's
    samples under ``ctx``.

    Never-seen samples take the mean seen loss (1.0 when nothing is seen);
    ``smoothing`` keeps zero-loss samples drawable; a non-finite loss counts
    as not seen.
    """
    loss, valid = _gather(loss, ctx), _gather(valid, ctx)
    valid = valid & torch.isfinite(loss)
    mean, cnt = _valid_mean(loss, valid)
    fill = torch.where(cnt > 0, mean, 1.0)
    smoothed = torch.where(valid, loss, fill) + smoothing
    return smoothed / smoothed.sum()


def blocked_cumsum(x: torch.Tensor, cols: int = 1024) -> torch.Tensor:
    """Inclusive prefix sums of the 1-D ``x`` in a fixed order: rows of
    ``cols`` scanned each on its own, then the row totals, then each row
    offset by the totals before it.  Every scan is over the last dim of a
    tensor of two rows or more, which PyTorch runs as one block a row."""
    n = x.shape[0]
    rows = max(-(-n // cols), 2)
    padded = torch.zeros(rows * cols, dtype=x.dtype, device=x.device)
    padded[:n] = x
    within = torch.cumsum(padded.view(rows, cols), dim=1)
    totals = torch.stack((within[:, -1], torch.zeros_like(within[:, -1])))
    before = torch.cumsum(totals, dim=1)[0, :-1]
    within[1:] += before[:, None]
    return within.reshape(-1)[:n]


def with_replacement(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(N,) int32 categorical draws with replacement from ``p`` by inverse
    CDF, given (N,) uniforms ``u`` in [0, 1).

    The CDF is ``blocked_cumsum`` in float64 rounded to ``p``'s dtype on
    every device: a 1-D float ``torch.cumsum`` on CUDA is a decoupled
    look-back scan whose order of additions depends on timing, so its last
    bits (and a draw at a CDF step) could change from run to run.  The
    blocked sum is reproducible bit for bit, and equal to the CPU's
    sequential cumsum except where the two float64 orders straddle a
    float32 rounding point."""
    n = p.shape[0]
    cdf = blocked_cumsum(p.double()).to(p.dtype)
    x = u * cdf[-1]
    idx = torch.searchsorted(cdf, x, side="right")
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def weighted_keep(loss: torch.Tensor, valid: torch.Tensor, prune_ratio: float,
                  u: torch.Tensor, ctx=None):
    """InfoBatch soft pruning: ``(prune_mask, weights)``, over every rank's
    samples under ``ctx`` (``u`` is the (N,) uniforms of all of them).

    Prunes the below-mean valid samples whose uniform ``u`` falls below
    ``prune_ratio`` and weights every kept below-mean sample by
    ``1/(1 - r)``.  Non-finite losses count as not valid.
    """
    loss, valid = _gather(loss, ctx), _gather(valid, ctx)
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
                    use_kernel: bool = False, ctx=None):
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

    Under a group (``ctx``) the rows are this rank's and the plan is the
    cross-shard one: the local ``[lo, hi]`` (B2's stage) reduced to the
    global range (one ``all_reduce`` MIN of ``[lo, -hi]``), the local
    histogram over it (B3's) summed (one ``all_reduce``, int32: exact),
    then both walks over the global counts to ``floor(F * N)`` of the
    global N and this rank's masks.  Min, max and integer sums do not
    depend on the order of reduction, so the masks are the rows of the
    single-device masks.  ``use_kernel`` runs each stage's kernel
    (``histogram_range``, ``histogram_count``, ``histogram_walk``).
    """
    if ctx is None or ctx.group is None:
        select = (ts.histogram_select if use_kernel
                  else ts.histogram_select_plain)
        low_mask, high_mask, *_ = select(loss, valid, low_fraction,
                                         high_fraction, bins)
        return low_mask, high_mask
    low_mask, high_mask, *_ = histogram_select_staged(
        loss, valid, low_fraction, high_fraction, bins=bins,
        use_kernel=use_kernel, ctx=ctx)
    return low_mask, high_mask


def histogram_select_staged(loss: torch.Tensor, valid: torch.Tensor,
                            low_fraction, high_fraction: float = 0.0, *,
                            bins: int = HIST_BINS, use_kernel: bool = False,
                            ctx):
    """The cross-shard histogram selection of ``histogram_masks``:
    ``(low_mask, high_mask, hist, lo_hi, walk)`` with the global histogram
    and range, as ``threshold_select.histogram_select`` gives them."""
    if use_kernel:
        rng, cnt, walk = (ts.histogram_range, ts.histogram_count,
                          ts.histogram_walk)
    else:
        rng, cnt, walk = ts.range_plain, ts.count_plain, ts.walk_plain
    lo_hi = rng(loss, valid)
    # One MIN reduces both ends: max(hi) = -min(-hi), and negation is exact.
    lo_hi[1:].neg_()
    ctx.all_reduce(lo_hi, "min")
    lo_hi[1:].neg_()
    hist = ctx.all_reduce(cnt(loss, valid, lo_hi, bins), "sum")
    n_count = loss.shape[0] * ctx.dp_size
    low_mask, high_mask, w = walk(loss, valid, hist, lo_hi, n_count,
                                  low_fraction, high_fraction)
    return low_mask, high_mask, hist, lo_hi, w


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
