"""InfoBatch baseline [28] (paper App. E / C.4; Qin et al. 2023).

Port of ``repro/core/infobatch.py``.  Each epoch randomly prunes a fraction
``r`` of the samples whose lagging loss is below the mean and weights the
kept below-mean samples by ``1/(1 - r)``, so the expected gradient is
unbiased.  No pruning in the final ``anneal`` fraction of training;
``total_epochs`` reaches the strategy through ``make_strategy``'s extras.

The soft prune (``planops.weighted_keep``) and the kept-first shuffle
(``masked_order``) are one device step over uniforms and a permutation from
the sampler's own ``torch.Generator``; the order, prune count and weights
cross to the host once per epoch.  ``InfoBatchSampler`` holds the plan (the
reference's low-level API) and ``InfoBatchStrategy`` wraps it.  Under a
data-parallel group (``ctx``) the state is row-sharded, as the
reference's; the plan gathers the scores and is the same on every rank.
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
class InfoBatchConfig:
    prune_ratio: float = 0.5   # r: fraction of below-mean samples pruned
    anneal: float = 0.875      # stop pruning after this fraction of epochs
    total_epochs: int = 100


def _plan_step(state: SampleState, perm: torch.Tensor, u: torch.Tensor,
               prune_ratio: float, *, annealed: bool,
               ctx: ParallelCtx | None = None):
    """``(order with the kept samples first, prune count, weights)``.  In
    the anneal phase nothing is pruned and the weights are uniform; with
    nothing observed yet ``weighted_keep`` gives the same.  Over every
    rank's samples under ``ctx`` (``state`` is this rank's rows)."""
    n, dev = perm.shape[0], state.loss.device
    if annealed:
        prune = torch.zeros(n, dtype=torch.bool, device=dev)
        weights = torch.ones(n, dtype=torch.float32, device=dev)
    else:
        prune, weights = planops.weighted_keep(state.loss, state.seen >= 0,
                                               prune_ratio, u, ctx)
    order, num_prune = planops.masked_order(perm, prune)
    return order, num_prune, weights


class InfoBatchSampler:
    """The InfoBatch plan over a ``SampleState``: ``begin_epoch`` prunes and
    shuffles, ``sample_weights`` looks up the rescaling weights."""

    def __init__(self, num_samples: int, config: InfoBatchConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        self.config = config or InfoBatchConfig()
        self.num_samples = num_samples
        self.device = resolve_device(device)
        self.rows = RowLayout(num_samples, ctx)
        self.ctx = self.rows.ctx
        self.state = self.rows.init_state(self.device)
        self._gen = planops.make_generator(seed, "infobatch", self.device)
        self.weights = np.ones(num_samples, np.float32)

    def draw_uniform(self) -> torch.Tensor:
        return planops.uniform(self._gen, self.num_samples)

    def draw_permutation(self) -> torch.Tensor:
        return planops.device_permutation(self._gen, self.num_samples)

    def begin_epoch(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """``(shuffled kept indices, sorted pruned indices)`` (host)."""
        c, n = self.config, self.num_samples
        annealed = epoch >= int(c.anneal * c.total_epochs)
        u, perm = self.draw_uniform(), self.draw_permutation()
        order, num_prune, weights = _plan_step(self.state, perm, u,
                                               c.prune_ratio, annealed=annealed,
                                               ctx=self.ctx)
        order = order.cpu().numpy()           # the epoch's host crossing
        self.weights = weights.cpu().numpy()
        kept = n - int(num_prune)
        return order[:kept], np.sort(order[kept:])

    def sample_weights(self, indices: np.ndarray) -> np.ndarray:
        return self.weights[indices]

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self.state = self.rows.scatter(self.state, indices, loss, pa, pc,
                                       epoch)

    def batches(self, epoch_indices: np.ndarray,
                batch_size: int) -> Iterator[np.ndarray]:
        for start in range(0, len(epoch_indices) - batch_size + 1, batch_size):
            yield epoch_indices[start : start + batch_size]


@register_strategy("infobatch")
class InfoBatchStrategy(SampleStrategy):
    """Lossless dynamic pruning with ``1/(1 - r)`` rescaling weights, over
    ``InfoBatchSampler``."""

    config_cls, config_field = InfoBatchConfig, "infobatch"
    fused_observe = staticmethod(scatter_observations)
    state = inner_attr()
    weights = inner_attr()
    draw_uniform = inner_attr()
    draw_permutation = inner_attr()

    def __init__(self, num_samples: int, config: InfoBatchConfig | None = None,
                 seed: int = 0, total_epochs: int | None = None,
                 device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        cfg = config or InfoBatchConfig()
        if total_epochs is not None:
            cfg = dataclasses.replace(cfg, total_epochs=total_epochs)
        super().__init__(num_samples, cfg, seed)
        self._inner = InfoBatchSampler(num_samples, cfg, seed, device, ctx)
        self.fused_observe = self._inner.rows.scatter

    def get_device_state(self) -> SampleState:
        return self._inner.state

    def plan(self, epoch: int) -> EpochPlan:
        visible, pruned = self._inner.begin_epoch(epoch)
        return EpochPlan(epoch=epoch, visible_indices=visible,
                         hidden_indices=pruned,
                         hidden_fraction=len(pruned) / self.num_samples,
                         host_syncs=1)

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self._inner.observe(indices, loss, pa, pc, epoch)

    def batch_weights(self, indices: np.ndarray) -> np.ndarray:
        return self._inner.sample_weights(indices)

    def state_dict(self) -> dict:
        # The weights are not saved: begin_epoch rebuilds them before any
        # lookup.
        inner = self._inner
        return {"arrays": {"state": inner.rows.gather(inner.state),
                           "rng_key": planops.generator_state(inner._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        inner = self._inner
        inner.rows.load(inner.state, state["arrays"]["state"])
        planops.restore_generator(inner._gen, state, self.seed, "infobatch")
