"""The uniform baseline strategy.

Port of ``repro/core/baseline.py::BaselineStrategy`` (``random`` comes in a
later slice): a uniform without-replacement epoch over every sample, the
control every paper table is measured against.  The shuffle is drawn on the
device from a ``torch.Generator`` and crosses to the host once per epoch.
"""
from __future__ import annotations

import torch

from repro_torch.core import planops
from repro_torch.core.strategy import EpochPlan, SampleStrategy, register_strategy
from repro_torch.kernels.backend import resolve_device


@register_strategy("baseline")
class BaselineStrategy(SampleStrategy):
    """Uniform without-replacement epoch over every sample."""

    def __init__(self, num_samples: int, config=None, seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__(num_samples, config, seed)
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(planops.strategy_seed(seed, "baseline"))

    def plan(self, epoch: int) -> EpochPlan:
        order = torch.randperm(self.num_samples, generator=self._gen,
                               device=self.device)
        return EpochPlan(epoch=epoch, visible_indices=order.cpu().numpy(),
                         host_syncs=1)
