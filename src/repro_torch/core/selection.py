"""Hidden-sample selection (step B of the paper, Fig. 1).

Port of ``repro/core/selection.py``.  Three interchangeable methods, chosen
by ``KakurenboConfig.selection``:

1. ``"sort"`` — the paper's: rank every sample by lagging loss (O(N log N))
   and hide the lowest-loss fraction <= F;
2. ``"histogram"`` — the histogram-CDF threshold in plain PyTorch (O(N));
3. ``"histogram_pallas"`` — the same math in one CUDA kernel on the card,
   the histogram-select (B2 and B3 fused with the CDF walks and the masks;
   the name is the JAX package's, kept so configurations carry over).
   Bit-identical masks to ``"histogram"``.

All honour the move-back rule: a candidate stays hidden only if it was
correct with confidence >= tau at its last observation.  Never-seen samples
are never hidden.  DropTop (App. D) hides the highest-loss tail on top,
regardless of move-back: under ``"sort"`` by the exact rank window of
``planops.sort_high_mask`` (the radix select, one kernel on the card),
under the histogram methods by the CDF walk mirrored from the top bin.

Under a data-parallel group (``ctx``) the state is this rank's row slice
and the mask is over its rows: the histogram methods run the cross-shard
plan of ``planops.histogram_masks`` (O(bins) communicated), ``"sort"``
ranks the gathered state (``state.gather_state``, O(N)) and keeps its
rows, as the reference's global argsort does.
"""
from __future__ import annotations

import torch

from repro_torch.core import planops
from repro_torch.core.state import SampleState, gather_state

#: Histogram resolution of the threshold paths.
HIST_BINS = planops.HIST_BINS

#: Methods accepted by ``select_hidden`` / ``KakurenboConfig.selection``.
SELECTION_METHODS = ("sort", "histogram", "histogram_pallas")


def _eligible(state: SampleState, tau: float, moveback: bool) -> torch.Tensor:
    """True where a sample is allowed to stay hidden."""
    if not moveback:
        return state.seen >= 0
    return state.pa & (state.pc >= tau) & (state.seen >= 0)


def histogram_threshold(loss: torch.Tensor, valid: torch.Tensor, num_hide,
                        lo, hi, bins: int = HIST_BINS) -> torch.Tensor:
    """Loss threshold t with about ``num_hide`` valid losses below it, from
    the histogram CDF: the right edge of the first bin whose CDF reaches
    ``num_hide``.  Plain PyTorch, as the reference's is plain jnp (the
    histogram paths above take their masks from ``planops.histogram_masks``
    instead)."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=loss.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=loss.device)
    span = torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(((loss - lo) / span * bins).to(torch.int32), 0,
                      bins - 1)
    hist = torch.zeros(bins, dtype=torch.int32, device=loss.device)
    hist.index_add_(0, idx.long(), valid.to(torch.int32))
    cdf = torch.cumsum(hist, 0)
    need = torch.as_tensor(num_hide, dtype=cdf.dtype, device=loss.device)
    b = torch.clamp(torch.searchsorted(cdf, need.reshape(1), side="left")[0],
                    0, bins - 1)
    return lo + (b.to(torch.float32) + 1.0) * span / bins


def select_hidden_sort(state: SampleState, max_fraction, tau: float = 0.7,
                       drop_top_fraction: float = 0.0,
                       moveback: bool = True) -> torch.Tensor:
    """Paper-faithful selection: global sort by lagging loss.  DropTop's
    top tail exempts never-seen samples, which rank below every real loss
    so that they never occupy the top window."""
    candidate = planops.sort_low_mask(state.loss, max_fraction)
    hidden = candidate & _eligible(state, tau, moveback)
    if drop_top_fraction > 0.0:
        hidden = hidden | planops.sort_high_mask(state.loss, state.seen >= 0,
                                                 drop_top_fraction)
    return hidden


def select_hidden_histogram(state: SampleState, max_fraction,
                            tau: float = 0.7, bins: int = HIST_BINS,
                            drop_top_fraction: float = 0.0,
                            moveback: bool = True,
                            use_kernel: bool = False, ctx=None) -> torch.Tensor:
    """Histogram-CDF threshold instead of a sort.  The hidden count is at
    most ``floor(F * N)`` plus half the boundary bin (see
    ``planops.histogram_masks``)."""
    candidate, top = planops.histogram_masks(
        state.loss, state.seen >= 0, max_fraction, drop_top_fraction,
        bins=bins, use_kernel=use_kernel, ctx=ctx)
    hidden = candidate & _eligible(state, tau, moveback)
    if top is not None:
        hidden = hidden | top
    return hidden


def select_hidden(state: SampleState, max_fraction, *, method: str = "sort",
                  tau: float = 0.7, drop_top_fraction: float = 0.0,
                  moveback: bool = True, ctx=None) -> torch.Tensor:
    """(N,) bool hidden mask by ``method`` (under ``ctx``: over this rank's
    rows of the state)."""
    if method == "sort":
        whole = select_hidden_sort(gather_state(state, ctx), max_fraction,
                                   tau, drop_top_fraction, moveback)
        return whole if ctx is None else ctx.shard_rows(whole)
    if method in ("histogram", "histogram_pallas"):
        return select_hidden_histogram(
            state, max_fraction, tau, drop_top_fraction=drop_top_fraction,
            moveback=moveback, use_kernel=(method == "histogram_pallas"),
            ctx=ctx)
    raise ValueError(
        f"unknown selection method {method!r}; known: {SELECTION_METHODS}")
