"""Optimizers (the subset of this slice: SGD with momentum).

Port of ``repro/optim/optimizers.py::sgd``, written as the port's own
foreach update so that a CUDA graph can hold it:

    g <- g + wd * p;  m <- momentum * m + g;  step = momentum * m + g
    (nesterov) or m;  p <- p - lr * step

The momentum buffers are allocated as zeros at construction (the first
step's ``momentum * 0 + g`` equals the reference's ``m = g``) and are only
ever updated in place.  The LR is read from a 0-dim float32 tensor on the
parameters' device: a captured step reads whatever the tensor holds at
replay, where a Python float would be baked into the graph.  ``step``
takes that tensor, or a number, which is written into the optimizer's own
LR tensor first.  AdamW, RMSProp and Adafactor come in a later slice.
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
        self.params = list(params)
        self.momentum = float(momentum)
        self.nesterov = nesterov and self.momentum > 0.0
        self.weight_decay = float(weight_decay)
        self.bufs = ([torch.zeros_like(p, memory_format=torch.preserve_format)
                      for p in self.params] if self.momentum else [])
        dev = self.params[0].device if self.params else torch.device("cpu")
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: torch.Tensor | float) -> None:
        if not isinstance(lr, torch.Tensor):
            self.lr.fill_(lr)
            lr = self.lr
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        step = grads
        if self.momentum:
            bufs = [b for p, b in zip(self.params, self.bufs)
                    if p.grad is not None]
            torch._foreach_mul_(bufs, self.momentum)
            torch._foreach_add_(bufs, grads)
            step = (torch._foreach_add(grads, bufs, alpha=self.momentum)
                    if self.nesterov else bufs)
        torch._foreach_sub_(params, torch._foreach_mul(step, lr))

    def reset(self) -> None:
        """Zero the momentum in place (FORGET's restart)."""
        for b in self.bufs:
            b.zero_()

    def state_dict(self) -> dict:
        """The momentum buffers themselves (no copies)."""
        return {"momentum": list(self.bufs)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state``'s buffers into this optimizer's, in place."""
        src = list(state["momentum"])
        if len(src) != len(self.bufs):
            raise ValueError(f"SGD state holds {len(src)} momentum buffers, "
                             f"this optimizer {len(self.bufs)}")
        for b, s in zip(self.bufs, src):
            b.copy_(torch.as_tensor(s))


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter], **hp) -> SGD:
    if name != "sgd":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (AdamW, RMSProp and "
            "Adafactor come in a later slice of the PyTorch port)")
    return SGD(params, **hp)
