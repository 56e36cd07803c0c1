"""Optimizers: SGD (momentum, Nesterov), AdamW, RMSProp and Adafactor.

Port of ``repro/optim/optimizers.py``, with the reference's hyperparameter
names and defaults, written so that a CUDA graph can hold every update:

- the LR is read from a 0-dim float32 tensor on the parameters' device (a
  captured step reads whatever it holds at replay, where a Python float
  would be baked into the graph); ``step`` takes that tensor, or a number,
  which is written into the optimizer's own LR tensor first;
- the state is allocated at construction (zeros: the first step's
  ``decay * 0 + g`` equals the reference's fresh state) and only ever
  updated in place, AdamW's and Adafactor's step count ``t`` included (a
  0-dim int32 tensor, as in the reference);
- ``reset`` zeroes the state in place (FORGET's restart, the reference's
  ``opt.init``), ``state_dict`` hands out the live state tensors and
  ``load_state_dict`` copies into them, so a checkpoint restores under
  both epoch engines.

The updates (the reference's order of operations; ``lr`` the LR tensor):

    sgd:       g <- g + wd p;  m <- mu m + g;  p <- p - lr (mu m + g | m)
    adamw:     t <- t + 1;  m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2;
               p <- p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p),
               bc = 1 - b^t
    rmsprop:   g <- g + wd p;  v <- decay v + (1 - decay) g^2;
               m <- mu m + g / (sqrt(v) + eps);  p <- p - lr m
    adafactor: t <- t + 1;  beta = 1 - t^-0.8;  g2 = g^2 + eps; a tensor
               of 2+ dims keeps row and column means of g2 over its last
               two dims in the reference's layout, a vector a full second
               moment; the update is clipped to RMS ``clip_threshold``.
               A 4-D tensor is a conv weight, OIHW here and HWIO in the
               reference: it is factored through its HWIO view, over
               (I, O), so the same model gets the same estimator and the
               state the reference's shapes.

``state_tensors()`` lists every tensor the update writes besides the
parameters: the numeric guard holds them, with the parameters, at their
pre-step values on a non-finite step, and the scanned engine snapshots
them around its warm-up blocks.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.checkpoint.checkpoint import copy_into, flatten


class _Optimizer:
    """The shared plumbing: the parameters, the LR tensor, the state tree
    (``self._state``, nested dicts and lists of tensors)."""

    name = "?"

    def __init__(self, params: Iterable[torch.nn.Parameter]):
        self.params = list(params)
        dev = self.params[0].device if self.params else torch.device("cpu")
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self._state: dict = {}
        # fill_missing_grads' zeros, by position in params.
        self._zero_grads: dict[int, torch.Tensor] = {}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def fill_missing_grads(self) -> None:
        """Zeros as the gradient of every parameter the loss does not reach
        (the VLM's ``mm_proj`` on text): the reference differentiates the
        whole tree, so AdamW's decay moves such a leaf.  Its zeros are
        allocated at its first step (before any capture: the engine's
        warm-up runs eagerly) and zeroed in place after."""
        for i, p in enumerate(self.params):
            if p.grad is None:
                z = self._zero_grads.get(i)
                if z is None:
                    z = self._zero_grads[i] = torch.zeros_like(p)
                else:
                    z.zero_()
                p.grad = z

    def _lr(self, lr: torch.Tensor | float) -> torch.Tensor:
        if not isinstance(lr, torch.Tensor):
            self.lr.fill_(lr)
            return self.lr
        return lr

    def _active(self) -> list[int]:
        return [i for i, p in enumerate(self.params) if p.grad is not None]

    @torch.no_grad()
    def step(self, lr: torch.Tensor | float) -> None:
        idx = self._active()
        self._update([self.params[i] for i in idx],
                     [self.params[i].grad for i in idx], idx, self._lr(lr))

    def _update(self, params, grads, idx, lr) -> None:
        raise NotImplementedError

    def state_tensors(self) -> list[torch.Tensor]:
        """Every state tensor, in ``state_dict``'s flattened order."""
        return [t for _, t in flatten(self._state)]

    @torch.no_grad()
    def reset(self) -> None:
        """Zero the state in place (FORGET's restart)."""
        for t in self.state_tensors():
            t.zero_()

    def state_dict(self) -> dict:
        """The live state tensors themselves (no copies)."""
        return self._state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state``'s tensors (or arrays) into this optimizer's, in
        place."""
        copy_into(self._state, state)


def _zeros(params, dtype=None) -> list[torch.Tensor]:
    return [torch.zeros_like(p, dtype=dtype or p.dtype,
                             memory_format=torch.preserve_format)
            for p in params]


#: An update's temporaries (AdamW's: two tensors the size of the
#: parameters it updates) are bounded by running it over groups of
#: parameters of at most this many bytes; a model under it is one group.
GROUP_BYTES = 1 << 30


def _groups(tensors, limit: int) -> list[list[int]]:
    """Consecutive positions of ``tensors`` in groups of at most ``limit``
    bytes (a larger tensor alone)."""
    out: list[list[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        n = t.numel() * t.element_size()
        if out and size + n <= limit:
            out[-1].append(i)
            size += n
        else:
            out.append([i])
            size = n
    return out


def _step_count(params) -> torch.Tensor:
    dev = params[0].device if params else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


class SGD(_Optimizer):
    """SGD (momentum, nesterov, weight decay)."""

    name = "sgd"

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        super().__init__(params)
        self.momentum = float(momentum)
        self.nesterov = nesterov and self.momentum > 0.0
        self.weight_decay = float(weight_decay)
        self.bufs = _zeros(self.params) if self.momentum else []
        self._state = {"momentum": self.bufs}

    def _update(self, params, grads, idx, lr) -> None:
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        step = grads
        if self.momentum:
            bufs = [self.bufs[i] for i in idx]
            torch._foreach_mul_(bufs, self.momentum)
            torch._foreach_add_(bufs, grads)
            step = (torch._foreach_add(grads, bufs, alpha=self.momentum)
                    if self.nesterov else bufs)
        torch._foreach_sub_(params, torch._foreach_mul(step, lr))

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        src = list(state["momentum"])
        if len(src) != len(self.bufs):
            raise ValueError(f"SGD state holds {len(src)} momentum buffers, "
                             f"this optimizer {len(self.bufs)}")
        super().load_state_dict(state)


class AdamW(_Optimizer):
    """Adam with decoupled weight decay; ``state_dtype`` sets the moments'
    dtype (the parameters' by default), the update runs in float32."""

    name = "adamw"

    def __init__(self, params: Iterable[torch.nn.Parameter], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, state_dtype=None):
        super().__init__(params)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self._state = {"m": _zeros(self.params, state_dtype),
                       "v": _zeros(self.params, state_dtype),
                       "t": _step_count(self.params)}

    def _update(self, params, grads, idx, lr) -> None:
        s = self._state
        t = s["t"]
        t.add_(1)
        tf = t.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, tf)
        bc2 = 1.0 - torch.pow(self.b2, tf)
        for group in _groups(params, GROUP_BYTES):
            self._adam([params[j] for j in group], [grads[j] for j in group],
                       [s["m"][idx[j]] for j in group],
                       [s["v"][idx[j]] for j in group], bc1, bc2, lr)

    def _adam(self, params, grads, m, v, bc1, bc2, lr) -> None:
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(grads, grads), alpha=1.0 - b2)
        # ``.float()`` is the tensor itself in float32: no copy, no launch.
        denom = torch._foreach_div([x.float() for x in v], bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div([x.float() for x in m], bc1)
        torch._foreach_div_(upd, denom)
        pf = [p.float() for p in params]
        if self.weight_decay:
            torch._foreach_add_(upd, pf, alpha=self.weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(pf, upd)
        for p, x in zip(params, pf):
            if x is not p:
                p.copy_(x)


class RMSProp(_Optimizer):
    """RMSProp with momentum over the normalised gradient."""

    name = "rmsprop"

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 decay: float = 0.9, momentum: float = 0.9, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params)
        self.decay, self.momentum = float(decay), float(momentum)
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self._state = {"v": _zeros(self.params), "m": _zeros(self.params)}

    def _update(self, params, grads, idx, lr) -> None:
        s = self._state
        v = [s["v"][i] for i in idx]
        m = [s["m"][i] for i in idx]
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        torch._foreach_mul_(v, self.decay)
        torch._foreach_add_(v, torch._foreach_mul(grads, grads),
                            alpha=1.0 - self.decay)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_mul_(m, self.momentum)
        torch._foreach_add_(m, torch._foreach_div(grads, denom))
        torch._foreach_sub_(params, torch._foreach_mul(m, lr))


def _reference_layout(x: torch.Tensor) -> torch.Tensor:
    """The reference's view of a tensor: a conv weight OIHW -> HWIO (a
    view, no copy); any other tensor as it is."""
    return x.permute(2, 3, 1, 0) if x.dim() == 4 else x


def _port_layout(x: torch.Tensor) -> torch.Tensor:
    """``_reference_layout``'s inverse: HWIO -> OIHW."""
    return x.permute(3, 2, 0, 1) if x.dim() == 4 else x


class Adafactor(_Optimizer):
    """Factored second moment (row and column means over the last two dims
    of the reference's layout) for tensors of two or more dims, a full one
    for vectors; no momentum; the update clipped to RMS
    ``clip_threshold``."""

    name = "adafactor"

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 eps: float = 1e-30, clip_threshold: float = 1.0,
                 weight_decay: float = 0.0):
        super().__init__(params)
        self.eps, self.clip_threshold = float(eps), float(clip_threshold)
        self.weight_decay = float(weight_decay)

        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            shape = _reference_layout(p).shape
            if p.dim() >= 2:
                return {"r": torch.zeros(shape[:-1], **f32),
                        "c": torch.zeros(shape[:-2] + shape[-1:], **f32)}
            return {"v": torch.zeros(shape, **f32)}

        self._state = {"s": [one(p) for p in self.params],
                       "t": _step_count(self.params)}

    def _update(self, params, grads, idx, lr) -> None:
        t = self._state["t"]
        t.add_(1)
        beta = 1.0 - torch.pow(t.to(torch.float32), -0.8)
        keep = 1.0 - beta
        eps = self.eps
        for i, p, g in zip(idx, params, grads):
            s = self._state["s"][i]
            gf = g.float()
            g2 = gf * gf + eps
            if p.dim() >= 2:
                r, c = s["r"], s["c"]
                g2 = _reference_layout(g2)
                r.copy_(beta * r + keep * g2.mean(dim=-1))
                c.copy_(beta * c + keep * g2.mean(dim=-2))
                rmean = torch.clamp(r.mean(dim=-1, keepdim=True)[..., None],
                                    min=eps)
                denom = torch.sqrt(r[..., :, None] * c[..., None, :] / rmean)
                upd = gf / _port_layout(torch.clamp(denom, min=eps))
            else:
                v = s["v"]
                v.copy_(beta * v + keep * g2)
                upd = gf / (torch.sqrt(v) + eps)
            rms = torch.sqrt((upd * upd).mean() + eps)
            upd = upd / torch.clamp(rms / self.clip_threshold, min=1.0)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.float()
            p.copy_((p.float() - lr * upd).to(p.dtype))


OPTIMIZERS = {"sgd": SGD, "adamw": AdamW, "rmsprop": RMSProp,
              "adafactor": Adafactor}


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   **hp) -> _Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](params, **hp)
