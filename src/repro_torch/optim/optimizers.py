"""Optimizers (the subset of this slice: SGD with momentum).

Port of ``repro/optim/optimizers.py::sgd``.  The reference's update is

    g <- g + wd * p;  m <- momentum * m + g;  step = momentum * m + g
    (nesterov) or m;  p <- p - lr * step

which is exactly what ``torch.optim.SGD`` computes (dampening 0; its first
step sets m = g, equal to momentum * 0 + g), so it backs this wrapper.  The
LR is passed per step, as the reference's ``update(..., lr)`` takes it.
AdamW, RMSProp and Adafactor come in a later slice.
"""
from __future__ import annotations

from typing import Iterable

import torch


class SGD:
    """SGD (momentum, nesterov, weight decay) with the LR given per step."""

    name = "sgd"

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        self._opt = torch.optim.SGD(
            params, lr=0.0, momentum=momentum,
            nesterov=nesterov and momentum > 0.0, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self._opt.zero_grad(set_to_none=True)

    def step(self, lr: float) -> None:
        for group in self._opt.param_groups:
            group["lr"] = lr
        self._opt.step()


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], **hp) -> SGD:
    if name != "sgd":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (AdamW, RMSProp and "
            "Adafactor come in a later slice of the PyTorch port)")
    return SGD(params, **hp)
