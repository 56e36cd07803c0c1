"""Importance Sampling With Replacement (ISWR) baseline [Katharopoulos'18].

Port of ``repro/core/iswr.py``.  Each epoch draws N samples *with
replacement* with probability proportional to the lagging loss, so the
model sees as many samples per epoch as the baseline (paper Sec. 4).
Optional unbiasing weights ``1/(N p_i)`` (off in the paper's variant).

The plan is one device step (``importance_probs`` + the inverse-CDF draw)
over uniforms from the strategy's own ``torch.Generator``; the draw (and,
for the unbiased variant, the probabilities) crosses to the host once per
epoch.  A batch may repeat an index: ``scatter_observations`` keeps the
last occurrence, as the reference does.  Under a data-parallel group
(``ctx``) the state is row-sharded, as the reference's; the probabilities
are over every rank's samples and the draw is the same on every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import planops
from repro_torch.core.state import (RowLayout, SampleState,
                                    scatter_observations)
from repro_torch.core.strategy import EpochPlan, SampleStrategy, register_strategy
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass
class ISWRConfig:
    smoothing: float = 1e-3   # keeps unseen/zero-loss samples drawable
    unbiased: bool = False    # weight each loss by 1/(N p_i)


def _plan_step(state: SampleState, u: torch.Tensor, smoothing: float,
               ctx: ParallelCtx | None = None):
    """Loss-proportional probabilities and N draws: ``(draw, p)``, over
    every rank's samples under ``ctx``."""
    p = planops.importance_probs(state.loss, state.seen >= 0, smoothing, ctx)
    return planops.with_replacement(p, u), p


@register_strategy("iswr")
class ISWRStrategy(SampleStrategy):
    """With-replacement importance sampling."""

    config_cls, config_field = ISWRConfig, "iswr"
    fused_observe = staticmethod(scatter_observations)

    def __init__(self, num_samples: int, config: ISWRConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        super().__init__(num_samples, config or ISWRConfig(), seed)
        self.device = resolve_device(device)
        self.rows = RowLayout(num_samples, ctx)
        self.ctx = self.rows.ctx
        self.state = self.rows.init_state(self.device, init_loss=1.0)
        self.fused_observe = self.rows.scatter
        self._gen = planops.make_generator(seed, "iswr", self.device)
        self._last_p: np.ndarray | None = None

    def draw_uniform(self) -> torch.Tensor:
        return planops.uniform(self._gen, self.num_samples)

    def get_device_state(self) -> SampleState:
        return self.state

    def plan(self, epoch: int) -> EpochPlan:
        draw, p = _plan_step(self.state, self.draw_uniform(),
                             self.config.smoothing, self.ctx)
        draw = draw.cpu().numpy()             # the epoch's host crossing
        if self.config.unbiased:
            self._last_p = p.cpu().numpy()
        return EpochPlan(epoch=epoch, visible_indices=draw, host_syncs=1)

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self.state = self.fused_observe(self.state, indices, loss, pa, pc,
                                        epoch)

    def state_dict(self) -> dict:
        # _last_p is not saved: plan() recomputes it before any lookup.
        return {"arrays": {"state": self.rows.gather(self.state),
                           "rng_key": planops.generator_state(self._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        self.rows.load(self.state, state["arrays"]["state"])
        planops.load_generator_state(self._gen, state["arrays"]["rng_key"])

    def batch_weights(self, indices: np.ndarray) -> np.ndarray:
        if not self.config.unbiased:
            return np.ones(len(indices), np.float32)
        n = self.num_samples
        return (1.0 / (n * self._last_p[indices])).astype(np.float32)
