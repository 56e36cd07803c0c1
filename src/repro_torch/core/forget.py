"""Online FORGET baseline (paper Sec. 4; Toneva et al. [13]).

Port of ``repro/core/forget.py``.  Train ``warmup_epochs`` on the full
dataset while counting forgetting events (correct -> incorrect flips, kept
in ``SampleState`` by the fused observe), then prune the fraction F of the
least-forgettable samples and restart training from the initial model on
the pruned set (``EpochPlan.reinit_model``).  The reported cost includes
the warmup epochs (paper Sec. 4.2).

The prune set is the stable fewest-events-first rank window
(``planops.topk_hide``: the radix select, one kernel on the card);
never-correct samples score +inf.  The epoch shuffle is ``masked_order``
over a permutation drawn from the sampler's own ``torch.Generator``.
``ForgetSampler`` holds the plan (the reference's low-level API) and
``ForgetStrategy`` wraps it.  Under a data-parallel group (``ctx``) the
state and the prune mask are row-sharded, as the reference's: the prune
ranks every rank's scores and the order gathers the mask.
"""
from __future__ import annotations

import dataclasses
import math
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
class ForgetConfig:
    fraction: float = 0.3
    warmup_epochs: int = 20


def _prune_step(state: SampleState, k,
                ctx: ParallelCtx | None = None) -> torch.Tensor:
    """Mask of the ``k`` least-forgettable samples (stable fewest-events
    rank; over every rank's rows under ``ctx``).  Samples never predicted
    correctly count as infinitely forgettable: they score +inf and are
    kept."""
    events = state.forget_events.to(torch.float32)
    ever_correct = state.pa | (state.forget_events > 0)
    scores = torch.where(ever_correct, events, torch.inf)
    return planops.topk_hide(scores, k, ctx)


class ForgetSampler:
    """The FORGET plan over a ``SampleState``: ``begin_epoch`` prunes once,
    at the end of warmup, and shuffles the kept samples."""

    def __init__(self, num_samples: int, config: ForgetConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        self.config = config or ForgetConfig()
        self.num_samples = num_samples
        self.device = resolve_device(device)
        self.rows = RowLayout(num_samples, ctx)
        self.ctx = self.rows.ctx
        self.state = self.rows.init_state(self.device)
        self._gen = planops.make_generator(seed, "forget", self.device)
        # True = removed from training (this rank's rows under ctx).
        self.pruned_mask = torch.zeros(self.state.num_samples,
                                       dtype=torch.bool, device=self.device)
        self.restarted = False

    @property
    def should_restart(self) -> bool:
        """True exactly once, after warmup: the caller restarts the model."""
        return self.restarted

    def draw_permutation(self) -> torch.Tensor:
        return planops.device_permutation(self._gen, self.num_samples)

    def begin_epoch(self, epoch: int) -> np.ndarray:
        """The visible indices, shuffled (host).  ``epoch`` counts every
        epoch run, warmup included."""
        c = self.config
        if epoch == c.warmup_epochs and not self.restarted:
            self._prune()
            self.restarted = True
        else:
            self.restarted = False
        order, num_pruned = planops.masked_order(self.draw_permutation(),
                                                 self.pruned_mask, self.ctx)
        order = order.cpu().numpy()           # the epoch's host crossing
        return order[: self.num_samples - int(num_pruned)]

    def _prune(self) -> None:
        # floor in float64, as the reference's host code takes it.
        k = int(math.floor(self.config.fraction * self.num_samples))
        self.pruned_mask = self.rows.shard(
            _prune_step(self.state, k, self.ctx))

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self.state = self.rows.scatter(self.state, indices, loss, pa, pc,
                                       epoch)

    def batches(self, epoch_indices: np.ndarray,
                batch_size: int) -> Iterator[np.ndarray]:
        for start in range(0, len(epoch_indices) - batch_size + 1, batch_size):
            yield epoch_indices[start : start + batch_size]


@register_strategy("forget")
class ForgetStrategy(SampleStrategy):
    """Warmup -> prune the unforgettables -> restart, as one plan flag, over
    ``ForgetSampler``."""

    config_cls, config_field = ForgetConfig, "forget"
    fused_observe = staticmethod(scatter_observations)
    state = inner_attr()
    pruned_mask = inner_attr()
    restarted = inner_attr()
    draw_permutation = inner_attr()

    def __init__(self, num_samples: int, config: ForgetConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        super().__init__(num_samples, config or ForgetConfig(), seed)
        self._inner = ForgetSampler(num_samples, self.config, seed, device,
                                    ctx)
        self.fused_observe = self._inner.rows.scatter

    def get_device_state(self) -> SampleState:
        return self._inner.state

    def plan(self, epoch: int) -> EpochPlan:
        idx = self._inner.begin_epoch(epoch)
        return EpochPlan(epoch=epoch, visible_indices=idx,
                         reinit_model=self._inner.should_restart,
                         host_syncs=1)

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self._inner.observe(indices, loss, pa, pc, epoch)

    def state_dict(self) -> dict:
        inner = self._inner
        return {"arrays": {"state": inner.rows.gather(inner.state),
                           "pruned": inner.rows.gather(inner.pruned_mask),
                           "rng_key": planops.generator_state(inner._gen)},
                "host": {"restarted": bool(inner.restarted)}}

    def load_state_dict(self, state: dict) -> None:
        inner, a = self._inner, state["arrays"]
        inner.rows.load({"state": inner.state, "pruned": inner.pruned_mask},
                        {"state": a["state"], "pruned": a["pruned"]})
        inner.restarted = bool(state["host"]["restarted"])
        planops.restore_generator(inner._gen, state, self.seed, "forget")
