"""Per-sample bookkeeping state (paper Sec. 3.4).

Port of ``repro/core/state.py``: for every sample a lagging loss, prediction
accuracy (PA), prediction confidence (PC), the hidden flag and the epoch it
was last seen, as ``(N,)`` tensors on the training device.

Unlike the JAX package, ``scatter_observations`` updates the tensors in
place (and returns the same state), which saves an (N,)-sized copy per
batch.  The numeric guard's ``valid=`` path belongs to a later slice.
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


def scatter_observations(state: SampleState,
                         indices: np.ndarray | torch.Tensor,
                         loss: torch.Tensor, pa: torch.Tensor,
                         pc: torch.Tensor, epoch: int) -> SampleState:
    """Record (loss, PA, PC) for the samples at ``indices``, in place.

    The JAX version lets the last duplicate win; ``index_put_`` with
    duplicate indices is nondeterministic on CUDA, so duplicates raise here.
    They never occur on the training path: a batch row of
    ``epoch_index_plan`` pads from the front of the epoch, and the refresh
    batches slice their padding off before observing.  Host (numpy) indices
    are checked on the host; a tensor is checked with ``torch.unique``,
    which waits for the device.
    """
    if isinstance(indices, np.ndarray):
        if len(np.unique(indices)) != len(indices):
            raise ValueError("scatter_observations: duplicate indices")
        indices = torch.as_tensor(indices, device=state.loss.device)
    elif torch.unique(indices).numel() != indices.numel():
        raise ValueError("scatter_observations: duplicate indices")
    idx = indices.to(device=state.loss.device, dtype=torch.int64)
    # A forgetting event (FORGET baseline) is a correct -> incorrect flip.
    forget_inc = (state.prev_correct[idx] & ~pa).to(torch.int32)
    state.loss[idx] = loss.to(torch.float32)
    state.pa[idx] = pa
    state.pc[idx] = pc.to(torch.float32)
    state.seen[idx] = epoch
    state.forget_events[idx] += forget_inc
    state.prev_correct[idx] = pa
    return state
