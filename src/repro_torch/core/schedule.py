"""Schedules: maximum hidden fraction (Sec. 3.3) and LR adjustment (Sec. 3.2).

Port of ``repro/core/schedule.py``, in float32 like the reference, so that
``num_hide = floor(f32(F) * f32(N))`` and the Eq. 8 factor match it bit for
bit.  The arithmetic runs on 0-d float32 CPU tensors (numpy scalar promotion
differs between numpy versions; torch's does not).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class FractionSchedule:
    """F_e = F_max * alpha[i] for the largest milestone[i] <= e.

    Paper defaults: F_max=0.3, alpha=[1, 0.8, 0.6, 0.4] at epochs
    [0, 30, 60, 80] (ImageNet-1K).
    """

    max_fraction: float = 0.3
    alphas: Sequence[float] = (1.0, 0.8, 0.6, 0.4)
    milestones: Sequence[int] = (0, 30, 60, 80)

    def __post_init__(self):
        if len(self.alphas) != len(self.milestones):
            raise ValueError("alphas and milestones differ in length")
        if not 0.0 <= self.max_fraction < 1.0:
            raise ValueError(f"max_fraction={self.max_fraction} not in [0, 1)")

    def __call__(self, epoch: int) -> torch.Tensor:
        alpha = _f32(0.0)
        for a, m in zip(self.alphas, self.milestones):
            if epoch >= m:
                alpha = _f32(a)
        return _f32(self.max_fraction) * alpha


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    """Base LR schedule with linear warmup over ``warmup_epochs``.

    kind: "step" (decay_rate at each milestone), "cosine" (anneal to 0 over
    total_epochs), or "constant".
    """

    base_lr: float
    kind: str = "cosine"
    total_epochs: int = 100
    warmup_epochs: int = 5
    decay_rate: float = 0.1
    milestones: Sequence[int] = (30, 60, 80)

    def __call__(self, epoch: int) -> torch.Tensor:
        e = _f32(epoch)
        base = _f32(self.base_lr)
        if self.kind == "step":
            lr = base
            for m in self.milestones:
                if epoch >= m:
                    lr = lr * _f32(self.decay_rate)
        elif self.kind == "cosine":
            frac = torch.clamp(
                (e - _f32(self.warmup_epochs))
                / _f32(max(self.total_epochs - self.warmup_epochs, 1)), 0.0, 1.0)
            lr = base * _f32(0.5) * (_f32(1.0) + torch.cos(_f32(math.pi) * frac))
        elif self.kind == "constant":
            lr = base
        else:
            raise ValueError(f"unknown LR schedule {self.kind!r}")
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            warm = torch.clamp((e + _f32(1.0)) / _f32(self.warmup_epochs),
                               0.0, 1.0)
            lr = base * warm
        return lr


def kakurenbo_lr(base_lr: torch.Tensor, hidden_fraction: torch.Tensor
                 ) -> torch.Tensor:
    """Eq. 8: eta_e = eta_base,e / (1 - F*_e), with F* clipped to 0.95."""
    f = torch.clamp(torch.as_tensor(hidden_fraction, dtype=torch.float32),
                    0.0, 0.95)
    return base_lr / (1.0 - f)


def linear_scaling_rule(base_lr_per_worker: float, num_workers: int) -> float:
    """Goyal et al. [34]'s linear scaling rule (App. B.3), used by the
    paper's ResNet-50 (A): the per-worker LR times the worker count."""
    return base_lr_per_worker * num_workers
