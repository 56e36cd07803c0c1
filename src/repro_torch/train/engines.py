"""Epoch engines: how a planned epoch's batches become train steps.

Port of ``repro/train/engines.py::HostLoopEngine``: one train step per
batch, batches assembled on the host by the ``Pipeline`` and copied to the
device each step with the strategy's per-sample weights.  Per-step loss
scalars and backward counts stay on the device and cross to the host once,
at epoch end.  The JAX package's default engine is the
scanned one, which is bit-identical to the host loop there, so the host
loop computes the same thing; a device-resident engine (CUDA graphs) comes
in a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EpochRunResult:
    """What an engine hands back to ``Trainer.run_epoch``."""

    losses: np.ndarray        # (num_steps,) f64 per-step loss scalars
    fwd_samples: int
    bwd_samples: int


class HostLoopEngine:
    """Per-batch dispatch with host-side batch assembly."""

    name = "host"

    def __init__(self, trainer):
        self.tr = trainer

    def run_epoch(self, epoch: int, indices: np.ndarray, plan,
                  lr: float) -> EpochRunResult:
        tr = self.tr
        # The strategy's device state is threaded through the steps and
        # handed back at the epoch boundary (also on a crash).
        state = tr.strategy.get_device_state()
        losses, bwds = [], []
        try:
            for idx, batch in tr.pipeline.batches(indices):
                weight = tr.strategy.batch_weights(idx)
                if weight is not None:
                    batch = dict(batch, weight=np.asarray(weight, np.float32))
                state, scalar, bwd = tr.train_step(
                    state, tr.to_device(batch), idx, epoch, lr)
                losses.append(scalar)
                if bwd is not None:
                    bwds.append(bwd)
        finally:
            if state is not None:
                tr.strategy.set_device_state(state)
        if not losses:
            return EpochRunResult(np.zeros(0), 0, 0)
        # The epoch's one loss (and backward count) materialisation.
        ls = torch.stack(losses).cpu().numpy().astype(np.float64)
        n = len(losses) * tr.cfg.batch_size
        bwd_total = int(torch.stack(bwds).sum()) if bwds else n
        return EpochRunResult(losses=ls, fwd_samples=n, bwd_samples=bwd_total)
