"""Selective-Backprop baseline [17] (paper Sec. 4, "SB").

Port of ``repro/core/selective_backprop.py``.  Forward the whole batch,
then backprop only the samples kept with probability
``max(percentile(loss)^beta, floor)``; beta = 1 keeps about half.  The
percentile is taken against a ring buffer of the last ``history`` losses.

The flow is the protocol's in-step ``fused_select`` hook: the trainer runs
a forward-only loss, ``select_step`` turns it into per-sample backward
weights (0 = dropped, survivors rescaled by ``B / kept``) and updates the
device-resident ring buffer in place.  The per-step uniforms are an input:
the strategy draws them with ``planops.counter_uniform`` at a key and a
draw counter kept in the selection state (each select advances the
counter), and the parity tests hand in the reference's.  Key and counter
are state like the reference's carried key: a guarded step that holds the
selection state (a non-finite selection loss) holds the counter too, so
the next step draws what the held one drew, as the held key does.
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


def init_select_state(config: SBConfig, device: torch.device,
                      seed: int = 0) -> dict:
    """The ring buffer of recent losses, +inf in unwritten slots (they sort
    past every real loss), with its fill count and write position, and the
    draws' key and count of draws taken (together the port's counterpart
    of the reference's carried key)."""
    return {"hist": torch.full((config.history,), torch.inf,
                               dtype=torch.float32, device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "ptr": torch.zeros((), dtype=torch.int32, device=device),
            "key": planops.counter_key(seed, "sb", device),
            "draws": torch.zeros((), dtype=torch.int64, device=device)}


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
        self._sel = init_select_state(self.config, self.device, seed)
        self._gen = planops.make_generator(seed, "sb-plan", self.device)

    def draw_uniform(self, b: int) -> torch.Tensor:
        """The ``b`` uniforms of the draw counter's current value."""
        sel = self._sel
        return planops.counter_uniform(sel["key"], sel["draws"], b)

    def draw_permutation(self) -> torch.Tensor:
        return planops.device_permutation(self._gen, self.num_samples)

    def fused_select(self, state: dict, loss: torch.Tensor):
        c = self.config
        u = self.draw_uniform(loss.shape[0])
        state["draws"].add_(1)
        return select_step(state, loss, u, beta=c.beta, floor=c.floor,
                           bootstrap=c.bootstrap)

    def plan(self, epoch: int) -> EpochPlan:
        return EpochPlan(epoch=epoch,
                         visible_indices=self.draw_permutation().cpu().numpy(),
                         host_syncs=1)

    def get_device_state(self) -> dict:
        return self._sel

    def state_dict(self) -> dict:
        return {"arrays": {**self._sel,
                           "rng_key": planops.generator_state(self._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        a = state["arrays"]
        copy_into(self._sel, {k: a[k] for k in self._sel})
        planops.load_generator_state(self._gen, a["rng_key"])
