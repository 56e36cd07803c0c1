"""Importance Sampling With Replacement (ISWR) baseline [Katharopoulos'18].

Port of ``repro/core/iswr.py``.  Each epoch draws N samples *with
replacement* with probability proportional to the lagging loss, so the
model sees as many samples per epoch as the baseline (paper Sec. 4).
Optional unbiasing weights ``1/(N p_i)`` (off in the paper's variant).

The plan is one device step (``importance_probs`` + the inverse-CDF draw)
over uniforms from the sampler's own ``torch.Generator``; the draw (and,
for the unbiased variant, the probabilities) crosses to the host once per
epoch.  ``ISWRSampler`` holds the plan (the reference's low-level API) and
``ISWRStrategy`` wraps it.  A batch may repeat an index:
``scatter_observations`` keeps the last occurrence, as the reference
does.  Under a data-parallel group
(``ctx``) the state is row-sharded, as the reference's; the probabilities
are over every rank's samples and the draw is the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import planops
from repro_torch.core.state import (RowLayout, SampleState,
                                    scatter_observations)
from repro_torch.core.strategy import (EpochPlan, SampleStrategy, inner_attr,
                                       register_strategy)
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


class ISWRSampler:
    """The ISWR plan over a ``SampleState``: ``begin_epoch`` draws the
    epoch's N indices, ``sample_weights`` looks up the unbiasing weights,
    ``observe`` records a batch."""

    def __init__(self, num_samples: int, config: ISWRConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        self.config = config or ISWRConfig()
        self.num_samples = num_samples
        self.device = resolve_device(device)
        self.rows = RowLayout(num_samples, ctx)
        self.ctx = self.rows.ctx
        self.state = self.rows.init_state(self.device, init_loss=1.0)
        self._gen = planops.make_generator(seed, "iswr", self.device)
        #: The last plan's (N,) draw probabilities, on the device.
        self.probs: torch.Tensor | None = None
        self._last_p = np.full(num_samples, 1.0 / num_samples)

    def draw_uniform(self) -> torch.Tensor:
        return planops.uniform(self._gen, self.num_samples)

    def begin_epoch(self, epoch: int) -> np.ndarray:
        """The epoch's N with-replacement indices (host)."""
        draw, self.probs = _plan_step(self.state, self.draw_uniform(),
                                      self.config.smoothing, self.ctx)
        draw = draw.cpu().numpy()             # the epoch's host crossing
        if self.config.unbiased:
            self._last_p = self.probs.cpu().numpy()
        return draw

    def sample_weights(self, indices: np.ndarray) -> np.ndarray:
        if not self.config.unbiased:
            return np.ones(len(indices), np.float32)
        n = self.num_samples
        return (1.0 / (n * self._last_p[indices])).astype(np.float32)

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self.state = self.rows.scatter(self.state, indices, loss, pa, pc,
                                       epoch)

    def batches(self, epoch_indices: np.ndarray,
                batch_size: int) -> Iterator[np.ndarray]:
        for start in range(0, len(epoch_indices) - batch_size + 1, batch_size):
            yield epoch_indices[start : start + batch_size]


@register_strategy("iswr")
class ISWRStrategy(SampleStrategy):
    """With-replacement importance sampling over ``ISWRSampler``."""

    config_cls, config_field = ISWRConfig, "iswr"
    fused_observe = staticmethod(scatter_observations)
    state = inner_attr()
    draw_uniform = inner_attr()

    def __init__(self, num_samples: int, config: ISWRConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        super().__init__(num_samples, config or ISWRConfig(), seed)
        self._inner = ISWRSampler(num_samples, self.config, seed, device, ctx)
        self.fused_observe = self._inner.rows.scatter

    def get_device_state(self) -> SampleState:
        return self._inner.state

    def plan(self, epoch: int) -> EpochPlan:
        return EpochPlan(epoch=epoch,
                         visible_indices=self._inner.begin_epoch(epoch),
                         host_syncs=1)

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self._inner.observe(indices, loss, pa, pc, epoch)

    def batch_weights(self, indices: np.ndarray) -> np.ndarray:
        return self._inner.sample_weights(indices)

    def state_dict(self) -> dict:
        # The probabilities are not saved: begin_epoch recomputes them
        # before any lookup.
        inner = self._inner
        return {"arrays": {"state": inner.rows.gather(inner.state),
                           "rng_key": planops.generator_state(inner._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        inner = self._inner
        inner.rows.load(inner.state, state["arrays"]["state"])
        planops.restore_generator(inner._gen, state, self.seed, "iswr")
