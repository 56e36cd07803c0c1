"""Selective-Backprop baseline [17] (paper Sec. 4, "SB").

Port of ``repro/core/selective_backprop.py``.  Forward the whole batch,
then backprop only the samples kept with probability
``max(percentile(loss)^beta, floor)``; beta = 1 keeps about half.  The
percentile is taken against a ring buffer of the last ``history`` losses.

The flow is the protocol's in-step ``fused_select`` hook: the trainer runs
a forward-only loss, ``select_step`` turns it into per-sample backward
weights (0 = dropped, survivors rescaled by ``B / kept``) and updates the
device-resident ring buffer in place.  The per-step uniforms are an input:
the strategy draws them from its own ``torch.Generator`` (a step generator,
registered with every captured graph), and the parity tests hand in the
reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.checkpoint import copy_into
from repro_torch.core import planops
from repro_torch.core.strategy import EpochPlan, SampleStrategy, register_strategy
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass
class SBConfig:
    beta: float = 1.0
    history: int = 4096   # sliding window of recent losses for percentiles
    floor: float = 0.05   # minimum selection probability (avoid starving)
    bootstrap: int = 32   # train on everything until this many losses seen


def init_select_state(config: SBConfig, device: torch.device) -> dict:
    """The ring buffer of recent losses, +inf in unwritten slots (they sort
    past every real loss), with its fill count and write position."""
    return {"hist": torch.full((config.history,), torch.inf,
                               dtype=torch.float32, device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "ptr": torch.zeros((), dtype=torch.int32, device=device)}


def select_step(state: dict, loss: torch.Tensor, u: torch.Tensor, *,
                beta: float, floor: float, bootstrap: int):
    """``(state, (B,) loss, (B,) uniforms) -> (weights, state)``.

    Each loss's percentile within the history drives a Bernoulli keep; the
    kept samples are weighted by ``B / kept`` so the batch loss stays
    unbiased.  Until ``bootstrap`` losses are seen everything trains.  The
    batch is then written into the ring buffer, and the count and write
    position advanced, all in place (a captured step holds the tensors).
    """
    hist = state["hist"]
    h, b = hist.shape[0], loss.shape[0]
    loss = loss.to(torch.float32)
    filled = torch.clamp(state["count"], max=h)
    ranks = torch.searchsorted(torch.sort(hist).values, loss, side="left")
    pct = ranks / torch.clamp(filled, min=1)
    prob = torch.where(state["count"] < bootstrap, 1.0,
                       torch.clamp(pct ** beta, min=floor))
    keep = (u < prob).to(torch.float32)
    # a tensor numerator: ``int / tensor`` would multiply by a reciprocal
    batch = torch.full((), float(b), dtype=torch.float32, device=loss.device)
    weights = keep * (batch / torch.clamp(keep.sum(), min=1.0))
    pos = (state["ptr"] + torch.arange(b, dtype=torch.int32,
                                       device=loss.device)) % h
    hist[pos.long()] = loss
    state["count"].copy_(torch.clamp(state["count"] + b, max=1 << 30))
    state["ptr"].copy_((state["ptr"] + b) % h)
    return weights, state


@register_strategy("sb")
class SBStrategy(SampleStrategy):
    """Forward-then-mask selection as the in-step ``fused_select`` hook."""

    config_cls, config_field = SBConfig, "sb"

    def __init__(self, num_samples: int, config: SBConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None):
        super().__init__(num_samples, config or SBConfig(), seed)
        self.device = resolve_device(device)
        self._sel = init_select_state(self.config, self.device)
        self._sel_gen = planops.make_generator(seed, "sb", self.device)
        self._gen = planops.make_generator(seed, "sb-plan", self.device)

    def draw_uniform(self, b: int) -> torch.Tensor:
        return planops.uniform(self._sel_gen, b)

    def draw_permutation(self) -> torch.Tensor:
        return planops.device_permutation(self._gen, self.num_samples)

    def fused_select(self, state: dict, loss: torch.Tensor):
        c = self.config
        return select_step(state, loss, self.draw_uniform(loss.shape[0]),
                           beta=c.beta, floor=c.floor, bootstrap=c.bootstrap)

    def plan(self, epoch: int) -> EpochPlan:
        return EpochPlan(epoch=epoch,
                         visible_indices=self.draw_permutation().cpu().numpy(),
                         host_syncs=1)

    def get_device_state(self) -> dict:
        return self._sel

    def step_generators(self) -> list[torch.Generator]:
        return [self._sel_gen]

    def state_dict(self) -> dict:
        sel = self._sel
        return {"arrays": {"hist": sel["hist"], "count": sel["count"],
                           "ptr": sel["ptr"],
                           "sel_key": planops.generator_state(self._sel_gen),
                           "rng_key": planops.generator_state(self._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        a = state["arrays"]
        copy_into(self._sel, {k: a[k] for k in ("hist", "count", "ptr")})
        planops.load_generator_state(self._sel_gen, a["sel_key"])
        planops.load_generator_state(self._gen, a["rng_key"])
