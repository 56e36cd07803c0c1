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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
                      init_loss: float = 1e9) -> SampleState:
    """Fresh state: everything visible, never-seen samples maximally
    important (a large loss, so they are never hidden)."""
    n, dev = num_samples, torch.device(device)
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
                         valid: torch.Tensor | None = None) -> SampleState:
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
    """
    dev = state.loss.device
    idx = torch.as_tensor(indices).to(device=dev, dtype=torch.int64)
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
