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
over a permutation drawn from the strategy's own ``torch.Generator``.
Under a data-parallel group (``ctx``) the state and the prune mask are
row-sharded, as the reference's: the prune ranks every rank's scores and
the order gathers the mask.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import planops
from repro_torch.core.state import (RowLayout, SampleState,
                                    scatter_observations)
from repro_torch.core.strategy import EpochPlan, SampleStrategy, register_strategy
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


@register_strategy("forget")
class ForgetStrategy(SampleStrategy):
    """Warmup -> prune the unforgettables -> restart, as one plan flag."""

    config_cls, config_field = ForgetConfig, "forget"
    fused_observe = staticmethod(scatter_observations)

    def __init__(self, num_samples: int, config: ForgetConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        super().__init__(num_samples, config or ForgetConfig(), seed)
        self.device = resolve_device(device)
        self.rows = RowLayout(num_samples, ctx)
        self.ctx = self.rows.ctx
        self.state = self.rows.init_state(self.device)
        self.fused_observe = self.rows.scatter
        self._gen = planops.make_generator(seed, "forget", self.device)
        # True = removed from training (this rank's rows under ctx).
        self.pruned_mask = torch.zeros(self.state.num_samples,
                                       dtype=torch.bool, device=self.device)
        self.restarted = False

    def draw_permutation(self) -> torch.Tensor:
        return planops.device_permutation(self._gen, self.num_samples)

    def get_device_state(self) -> SampleState:
        return self.state

    def plan(self, epoch: int) -> EpochPlan:
        """``epoch`` counts every epoch run, warmup included."""
        c = self.config
        if epoch == c.warmup_epochs and not self.restarted:
            # floor in float64, as the reference's host code takes it.
            k = int(math.floor(c.fraction * self.num_samples))
            self.pruned_mask = self.rows.shard(
                _prune_step(self.state, k, self.ctx))
            self.restarted = True
        else:
            self.restarted = False
        order, num_pruned = planops.masked_order(self.draw_permutation(),
                                                 self.pruned_mask, self.ctx)
        order = order.cpu().numpy()           # the epoch's host crossing
        return EpochPlan(
            epoch=epoch,
            visible_indices=order[: self.num_samples - int(num_pruned)],
            reinit_model=self.restarted, host_syncs=1)

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self.state = self.fused_observe(self.state, indices, loss, pa, pc,
                                        epoch)

    def state_dict(self) -> dict:
        return {"arrays": {"state": self.rows.gather(self.state),
                           "pruned": self.rows.gather(self.pruned_mask),
                           "rng_key": planops.generator_state(self._gen)},
                "host": {"restarted": bool(self.restarted)}}

    def load_state_dict(self, state: dict) -> None:
        a = state["arrays"]
        self.rows.load({"state": self.state, "pruned": self.pruned_mask},
                       {"state": a["state"], "pruned": a["pruned"]})
        self.restarted = bool(state["host"]["restarted"])
        planops.load_generator_state(self._gen, a["rng_key"])
