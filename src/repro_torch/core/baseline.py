"""The uniform baseline and random hiding.

Port of ``repro/core/baseline.py``.  ``baseline`` is a uniform
without-replacement epoch over every sample, the control every paper table
is measured against.  ``random`` is KAKURENBO's machinery driven by
iid-uniform importance (paper App. C.4): it hides the same *fraction* as
KAKURENBO but picks the samples at random, isolating how much of the win
comes from loss-ranked selection.  Both draw on the device from their own
``torch.Generator`` and cross to the host once per epoch.  Under a
data-parallel group (``ctx``) every rank draws the same numbers, and
``random`` keeps its state row-sharded as KAKURENBO does.
"""
from __future__ import annotations

import torch

from repro_torch.core import planops
from repro_torch.core.kakurenbo import KakurenboConfig, KakurenboStrategy
from repro_torch.core.state import SampleState
from repro_torch.core.strategy import EpochPlan, SampleStrategy, register_strategy
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.kernels.backend import resolve_device


@register_strategy("baseline")
class BaselineStrategy(SampleStrategy):
    """Uniform without-replacement epoch over every sample."""

    def __init__(self, num_samples: int, config=None, seed: int = 0,
                 device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        super().__init__(num_samples, config, seed)
        self.device = resolve_device(device)
        # Seeded alike on every rank: no state to shard.
        self.ctx = ctx or ParallelCtx()
        self._gen = planops.make_generator(seed, "baseline", self.device)

    def draw_permutation(self) -> torch.Tensor:
        return planops.device_permutation(self._gen, self.num_samples)

    def plan(self, epoch: int) -> EpochPlan:
        return EpochPlan(epoch=epoch,
                         visible_indices=self.draw_permutation().cpu().numpy(),
                         host_syncs=1)

    def state_dict(self) -> dict:
        return {"arrays": {"rng_key": planops.generator_state(self._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        planops.restore_generator(self._gen, state, self.seed, "baseline")


@torch.no_grad()
def randomize_importance(state: SampleState, u: torch.Tensor) -> SampleState:
    """iid-uniform "losses" ``u``, every sample seen and move-back-eligible:
    a pure coin flip for the KAKURENBO plan.  Written into ``state`` in
    place (a captured train step holds its tensors)."""
    state.loss.copy_(u)
    state.pa.fill_(True)
    state.pc.fill_(1.0)
    state.seen.zero_()
    return state


@register_strategy("random")
class RandomStrategy(KakurenboStrategy):
    """Random hiding (App. C.4): KAKURENBO with iid-uniform importance,
    redrawn every epoch, and the same step-D refresh cost."""

    config_cls, config_field = KakurenboConfig, "kakurenbo"

    def __init__(self, num_samples: int, config: KakurenboConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        super().__init__(num_samples, config, seed, device, ctx)
        self._gen = planops.make_generator(seed, "random", self._inner.device)

    def draw_uniform(self) -> torch.Tensor:
        return planops.uniform(self._gen, self.num_samples)

    def plan(self, epoch: int) -> EpochPlan:
        randomize_importance(self._inner.state,
                             self._inner.rows.shard(self.draw_uniform()))
        return self._inner.begin_epoch(epoch)

    def state_dict(self) -> dict:
        inner = self._inner
        return {"arrays": {"state": inner.rows.gather(inner.state),
                           "inner_key": planops.generator_state(inner._gen),
                           "rng_key": planops.generator_state(self._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        a = state["arrays"]
        self._inner.rows.load(self._inner.state, a["state"])
        planops.restore_generator(self._inner._gen, state, self.seed,
                                  "kakurenbo", leaf="inner_key")
        planops.restore_generator(self._gen, state, self.seed, "random")
