"""Per-sample bookkeeping state (paper Sec. 3.4).

Port of ``repro/core/state.py``: for every sample a lagging loss, prediction
accuracy (PA), prediction confidence (PC), the hidden flag and the epoch it
was last seen, as ``(N,)`` tensors on the training device.

Unlike the JAX package, ``scatter_observations`` updates the tensors in
place (and returns the same state), which saves an (N,)-sized copy per
batch and lets a captured train step (CUDA graphs) hold their addresses;
a checkpoint restore copies into them too.  The numeric guard's
``valid=`` mask (``train/guard.py``) makes a non-finite observation a
bit-exact no-op for its sample.

Under a data-parallel group (``dist/sharding.py``) each rank keeps a row
slice of the state, as the reference row-shards it over its mesh:
``init_sample_state(rows=)`` builds one, ``scatter_observations(offset=)``
maps the batch's global ids to its rows and skips the others, and
``gather_state`` puts the ranks' slices back together.  ``RowLayout`` is
the one place a strategy learns that layout from: it builds the slice,
gives the scatter into it and carries the state to and from a
checkpoint's global arrays.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import copy_into
from repro_torch.dist.sharding import ParallelCtx


@dataclasses.dataclass
class SampleState:
    """State for the N samples of a dataset.

    loss (N,) f32 lagging loss; pa (N,) bool correct last time seen; pc (N,)
    f32 max softmax probability; hidden (N,) bool hidden this epoch; seen
    (N,) i32 epoch of the last observation (-1 = never); forget_events (N,)
    i32 correct->incorrect flips; prev_correct (N,) bool.
    """

    loss: torch.Tensor
    pa: torch.Tensor
    pc: torch.Tensor
    hidden: torch.Tensor
    seen: torch.Tensor
    forget_events: torch.Tensor
    prev_correct: torch.Tensor

    @property
    def num_samples(self) -> int:
        return self.loss.shape[0]


#: The fields ``scatter_observations`` reads or writes: what a captured
#: train step holds by address (``hidden`` is the epoch plan's).
OBSERVED_FIELDS = ("loss", "pa", "pc", "seen", "forget_events",
                   "prev_correct")


def init_sample_state(num_samples: int, device: torch.device | str,
                      init_loss: float = 1e9,
                      rows: tuple[int, int] | None = None) -> SampleState:
    """Fresh state: everything visible, never-seen samples maximally
    important (a large loss, so they are never hidden).  ``rows`` (``[start,
    stop)`` of ``num_samples``) builds that row slice only."""
    n = num_samples if rows is None else rows[1] - rows[0]
    dev = torch.device(device)
    return SampleState(
        loss=torch.full((n,), init_loss, dtype=torch.float32, device=dev),
        pa=torch.zeros(n, dtype=torch.bool, device=dev),
        pc=torch.zeros(n, dtype=torch.float32, device=dev),
        hidden=torch.zeros(n, dtype=torch.bool, device=dev),
        seen=torch.full((n,), -1, dtype=torch.int32, device=dev),
        forget_events=torch.zeros(n, dtype=torch.int32, device=dev),
        prev_correct=torch.zeros(n, dtype=torch.bool, device=dev),
    )


def last_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """For each position j of the (B,) ``idx``, the position of the last
    occurrence of ``idx[j]`` in the batch, with no wait on the device.

    A stable sort groups equal indices in position order; the end of each
    run is its last occurrence, spread over the run by a reverse running
    minimum and scattered back through the sort's permutation (which has no
    repeats, so that scatter is deterministic).
    """
    b = idx.shape[0]
    sorted_idx, order = torch.sort(idx, stable=True)
    pos = torch.arange(b, device=idx.device)
    is_end = torch.ones(b, dtype=torch.bool, device=idx.device)
    is_end[:-1] = sorted_idx[:-1] != sorted_idx[1:]
    run_end = torch.where(is_end, pos, b).flip(0).cummin(0).values.flip(0)
    winner = torch.empty_like(order)
    winner[order] = order[run_end]
    return winner


def scatter_observations(state: SampleState,
                         indices: np.ndarray | torch.Tensor,
                         loss: torch.Tensor, pa: torch.Tensor,
                         pc: torch.Tensor,
                         epoch: int | torch.Tensor,
                         valid: torch.Tensor | None = None,
                         offset: int | None = None) -> SampleState:
    """Record (loss, PA, PC) for the samples at ``indices``, in place.

    ``epoch`` is a Python int or a 0-dim int32 tensor on the state's device
    (the trainer's, as the reference passes ``jnp.int32(epoch)``), read
    there: nothing crosses to the host.

    Repeated indices (ISWR draws with replacement) keep the reference's
    meaning: loss, PA, PC, ``seen`` and ``prev_correct`` take the batch's
    *last* occurrence, and every occurrence adds its forgetting event,
    computed from the pre-batch ``prev_correct``.  ``index_put_`` with
    repeated indices writes in no fixed order on CUDA, so every occurrence
    first takes the values of its index's last occurrence
    (``last_occurrence``): all writers of a slot then write the same value.
    The integer ``index_add_`` of the events is exact in any order.

    ``valid`` is the numeric guard's (B,) quarantine mask: an occurrence
    where it is False carries the sample's existing loss, PA, PC, ``seen``
    and ``prev_correct`` (gathered before any write) and adds no forgetting
    event, so a non-finite observation leaves its sample bit for bit as it
    was.  With a repeated index the last occurrence still decides: an
    invalid last occurrence restores the pre-batch values, as the
    reference's last-write-wins scatter does.  Static shapes only
    (``torch.where`` against the gathered values), so a captured step can
    hold it.  ``None`` is the unguarded path, unchanged.

    ``offset`` makes ``state`` the row slice ``[offset, offset + n)`` of a
    larger state (a rank's, under a data-parallel group): the global ids in
    ``indices`` map to its rows, and an occurrence outside them is skipped
    as an invalid one is.  Such occurrences are moved ahead of the others
    (a stable sort of the batch), so that a slot any of the batch's own
    rows writes takes that row's values; they target a row of the slice
    only to keep the shapes static.  The slice's rows end as the global
    scatter leaves them, bit for bit.
    """
    dev = state.loss.device
    idx = torch.as_tensor(indices).to(device=dev, dtype=torch.int64)
    if offset is not None:
        n = state.num_samples
        local = idx - offset
        inside = (local >= 0) & (local < n)
        first = torch.argsort(inside.to(torch.uint8), stable=True)
        idx = local.clamp(0, n - 1)[first]
        loss, pa, pc = loss[first], pa[first], pc[first]
        valid = (inside if valid is None else valid & inside)[first]
    # A forgetting event (FORGET baseline) is a correct -> incorrect flip.
    forget_inc = state.prev_correct[idx] & ~pa
    if valid is not None:
        forget_inc = forget_inc & valid
    forget_inc = forget_inc.to(torch.int32)
    last = last_occurrence(idx)
    loss_last = loss.to(torch.float32)[last]
    pa_last = pa[last]
    pc_last = pc.to(torch.float32)[last]
    seen, prev_last = epoch, pa_last
    if valid is not None:
        # Where the last occurrence is invalid, write the pre-batch values
        # (gathered before any write) back: the reference's masked values
        # under its last-write-wins scatter.
        keep = valid[last]
        loss_last = torch.where(keep, loss_last, state.loss[idx])
        pa_last = torch.where(keep, pa_last, state.pa[idx])
        pc_last = torch.where(keep, pc_last, state.pc[idx])
        seen = torch.where(keep, torch.as_tensor(epoch, dtype=torch.int32,
                                                 device=dev), state.seen[idx])
        prev_last = torch.where(keep, prev_last, state.prev_correct[idx])
    state.loss[idx] = loss_last
    state.pa[idx] = pa_last
    state.pc[idx] = pc_last
    state.seen[idx] = seen
    state.forget_events.index_add_(0, idx, forget_inc)
    state.prev_correct[idx] = prev_last
    return state


def _words(t: torch.Tensor) -> torch.Tensor:
    """A float32, int32 or bool field as int32 words, bit for bit."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32)


def _from_words(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    w = w.contiguous()
    if dtype == torch.float32:
        return w.view(torch.float32)
    return w != 0 if dtype == torch.bool else w


def gather_state(state: SampleState, ctx) -> SampleState:
    """The whole state from every rank's row slice, in rank order: one
    all-gather of the fields packed as int32 words (bit for bit).  ``state``
    itself when ``ctx`` spans one process without a group."""
    if ctx is None or ctx.group is None:
        return state
    names = [f.name for f in dataclasses.fields(state)]
    fields = [getattr(state, k) for k in names]
    got = ctx.gather_rows(torch.stack([_words(t) for t in fields], dim=1))
    return SampleState(**{k: _from_words(got[:, i], t.dtype)
                          for i, (k, t) in enumerate(zip(names, fields))})


class RowLayout:
    """Where a strategy's per-sample rows live under ``ctx``: this rank's
    contiguous slice ``[start, stop)`` of ``num_samples`` (all of them
    without a group).  The strategies that row-shard their state
    (KAKURENBO and random, FORGET, InfoBatch, ISWR) hold one and pass only
    ``ctx`` to it."""

    def __init__(self, num_samples: int, ctx: ParallelCtx | None = None):
        self.num_samples = num_samples
        self.ctx = ctx or ParallelCtx()
        self.start, self.stop = self.ctx.rows(num_samples)

    def init_state(self, device: torch.device | str,
                   init_loss: float = 1e9) -> SampleState:
        """A fresh ``SampleState`` of this rank's rows."""
        return init_sample_state(self.num_samples, device, init_loss,
                                 rows=(self.start, self.stop))

    @property
    def scatter(self):
        """``scatter_observations`` into this rank's rows (``offset=`` their
        first id): a strategy's ``fused_observe``; the plain one without a
        group."""
        if self.ctx.group is None:
            return scatter_observations
        return functools.partial(scatter_observations, offset=self.start)

    def shard(self, x):
        """This rank's rows of a global ``(N, ...)`` tensor."""
        return self.ctx.shard_rows(x)

    def gather(self, x):
        """The global value of a row-sharded ``SampleState`` or tensor: what
        a checkpoint holds."""
        if isinstance(x, SampleState):
            return gather_state(x, self.ctx)
        return self.ctx.gather_rows(x)

    def load(self, own: Any, whole: Any) -> None:
        """Copy this rank's rows of ``whole`` (a checkpoint's global arrays:
        a tensor, a ``SampleState``, the dict of its fields, or a dict of
        these) into ``own``, in place."""
        copy_into(own, self._rows_of(whole))

    def _rows_of(self, whole: Any) -> Any:
        if self.ctx.group is None:
            return whole
        if dataclasses.is_dataclass(whole):
            whole = {f.name: getattr(whole, f.name)
                     for f in dataclasses.fields(whole)}
        if isinstance(whole, dict):
            return {k: self._rows_of(v) for k, v in whole.items()}
        return self.ctx.shard_rows(whole)


def with_hidden(state: SampleState, hidden: torch.Tensor) -> SampleState:
    """``state`` with ``hidden`` as its hidden mask (a new ``SampleState``
    sharing the other tensors)."""
    return dataclasses.replace(state, hidden=hidden)


def state_summary(state: SampleState, ctx: ParallelCtx | None = None
                  ) -> dict[str, Any]:
    """Host summary for logs and checkpoint checksums: the sample count,
    the hidden and seen counts and the mean over every sample of the loss
    where seen (0 elsewhere).  Syncs to the host.  Under a group the state
    is gathered whole first."""
    state = gather_state(state, ctx)
    seen = state.seen >= 0
    return {
        "num_samples": int(state.num_samples),
        "num_hidden": int(state.hidden.sum()),
        "mean_loss_seen": float(torch.where(seen, state.loss, 0.0).mean()),
        "num_seen": int(seen.sum()),
    }
