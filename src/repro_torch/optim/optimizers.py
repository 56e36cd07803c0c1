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
               state the reference's shapes.  The layers of one of the
               reference's stacked (L, ...) leaves are updated as that
               leaf (``stacks``), on a mesh each mean over its axes.

``state_tensors()`` lists every tensor the update writes besides the
parameters: the numeric guard holds them, with the parameters, at their
pre-step values on a non-finite step, and the scanned engine snapshots
them around its warm-up blocks.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import copy_into, flatten
from repro_torch.dist.sharding import entry_axes


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

    def shard_over(self, ctx, specs: list[tuple]) -> None:
        """Take the mesh ``ctx`` and each parameter's spec: an elementwise
        update needs neither."""

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
    ``clip_threshold``.

    ``stacks`` lists groups of positions in ``params``, each the L
    per-layer tensors of one of the reference's stacked ``(L, ...)``
    leaves (``launch/train.py::optimizer_for`` finds them in a model's
    tree).  Such a group is updated as that one leaf: its moments are the
    stacked leaf's (row and column means of each layer; for a stack of
    vectors ``r`` (L,) and ``c`` (d,), shared by the layers), its RMS clip
    spans the whole stack, and its state has the stacked shapes.  No
    (L, ...) copy of the gradients is made: one pass over the layers
    updates the moments and sums the squared update, one applies it (a
    stack of vectors takes one more, between them, for the sum).  Every
    other tensor is a leaf of its own, as in the trainer.

    On a mesh (``shard_over``) each mean and the RMS span the mesh axes of
    the dimensions they reduce, from each tensor's spec: a sum over the
    local block, summed over those axes, divided by the global count.
    Where no axis of a reduction has more than one rank the local op runs
    alone, the one a model with no mesh runs, so a (1, 1) mesh updates bit
    for bit as no mesh."""

    name = "adafactor"

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 eps: float = 1e-30, clip_threshold: float = 1.0,
                 weight_decay: float = 0.0, stacks=()):
        super().__init__(params)
        self.eps, self.clip_threshold = float(eps), float(clip_threshold)
        self.weight_decay = float(weight_decay)
        self._ctx = None
        self._specs: list[tuple] | None = None
        member = {i: tuple(g) for g in stacks for i in g}
        # The logical leaves, by their first position: (positions, stacked).
        self.leaves: list[tuple[tuple[int, ...], bool]] = []
        for i in range(len(self.params)):
            group = member.get(i)
            if group is None:
                self.leaves.append(((i,), False))
            elif group[0] == i:
                shapes = {tuple(self.params[j].shape) for j in group}
                if len(shapes) != 1:
                    raise ValueError(f"a stack's layers differ in shape: "
                                     f"{sorted(shapes)}")
                self.leaves.append((group, True))
        self._state = {"s": [self._init_state(g, st) for g, st in self.leaves],
                       "t": _step_count(self.params)}

    def _init_state(self, group, stacked: bool) -> dict:
        p = self.params[group[0]]
        f32 = dict(dtype=torch.float32, device=p.device)
        shape = ((len(group), *p.shape) if stacked
                 else _reference_layout(p).shape)
        if len(shape) >= 2:
            return {"r": torch.zeros(shape[:-1], **f32),
                    "c": torch.zeros(shape[:-2] + shape[-1:], **f32)}
        return {"v": torch.zeros(shape, **f32)}

    def shard_over(self, ctx, specs: list[tuple]) -> None:
        """Reduce over ``ctx``'s mesh: ``specs[i]`` is the spec of
        ``params[i]``, this rank's block (one layer's for a stack)."""
        if len(specs) != len(self.params):
            raise ValueError(f"{len(specs)} specs for {len(self.params)} "
                             "parameters")
        self._ctx, self._specs = ctx, [tuple(sp) for sp in specs]

    # -- reductions over the mesh ------------------------------------------

    def _axes(self, i: int, dims) -> tuple[str, ...]:
        """The mesh axes of more than one rank that ``params[i]``'s
        ``dims`` are sharded over, in mesh order."""
        if self._specs is None:
            return ()
        ndim = self.params[i].dim()
        spec = self._specs[i] + (None,) * ndim
        ctx = self._ctx
        used = {a for d in dims for a in entry_axes(spec[d % ndim])}
        return tuple(a for a in ctx.axis_names
                     if a in used and ctx.axis_size(a) > 1)

    def _span(self, axes) -> int:
        return math.prod(self._ctx.axis_size(a) for a in axes)

    def _sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        if axes:
            x = x.contiguous()
            dist.all_reduce(x, group=self._ctx.group_for(axes))
        return x

    def _mean(self, x: torch.Tensor, dim: int | None, axes) -> torch.Tensor:
        """``x.mean(dim)`` over the global tensor whose block along ``dim``
        (every dim: None) is sharded over ``axes``."""
        if not axes:
            return x.mean() if dim is None else x.mean(dim=dim)
        n = (x.numel() if dim is None else x.shape[dim]) * self._span(axes)
        return self._sum_over(x.sum() if dim is None else x.sum(dim=dim),
                              axes) / n

    # -- the update ----------------------------------------------------------

    def _update(self, params, grads, idx, lr) -> None:
        t = self._state["t"]
        t.add_(1)
        beta = 1.0 - torch.pow(t.to(torch.float32), -0.8)
        keep = 1.0 - beta
        active = set(idx)
        for (group, stacked), s in zip(self.leaves, self._state["s"]):
            live = [i in active for i in group]
            if not any(live):
                continue
            if not all(live):
                raise ValueError("a stack's layers must all have gradients "
                                 "or none")
            if not stacked:
                s = {k: v[None] for k, v in s.items()}
            self._group(group, s, stacked, beta, keep, lr)

    def _upd(self, i, layer, s, gf=None) -> torch.Tensor:
        """Layer ``layer``'s unclipped update of a logical leaf (its
        moments already updated; ``gf`` its float32 gradient, if at
        hand)."""
        eps = self.eps
        p = self.params[i]
        gf = p.grad.float() if gf is None else gf
        if "v" in s:
            return gf / (torch.sqrt(s["v"][layer]) + eps)
        r = s["r"]
        if p.dim() == 1:                      # a stack of vectors
            rmean = torch.clamp(r.mean(), min=eps)
            denom = torch.sqrt(r[layer] * s["c"] / rmean)
        else:
            rl = r[layer]
            rmean = torch.clamp(self._mean(rl, -1, self._axes(i, (-2,)))
                                [..., None, None], min=eps)
            denom = torch.sqrt(rl[..., :, None] * s["c"][layer][..., None, :]
                               / rmean)
        return gf / _port_layout(torch.clamp(denom, min=eps))

    def _apply(self, p, upd, rms, lr) -> None:
        upd = upd / torch.clamp(rms / self.clip_threshold, min=1.0)
        if self.weight_decay:
            upd = upd + self.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))

    def _group(self, group, s, stacked, beta, keep, lr) -> None:
        """One logical leaf: the L layers of a stack, or one tensor (a
        group of one, its state viewed with a leading dim of 1).  One pass
        updates the moments (a stack of vectors: its shared ``c`` after
        it) and sums the squared update, one applies it; a tensor of its
        own keeps its update between them, and its RMS is a ``mean``."""
        eps = self.eps
        first = self.params[group[0]]
        every = self._axes(group[0], range(first.dim()))
        vectors = first.dim() == 1 and "r" in s
        csum, sums, upd = None, [], None
        for layer, i in enumerate(group):
            gf = self.params[i].grad.float()
            # The reference layout moves only a conv weight's dims, which
            # are never sharded.
            g2 = _reference_layout(gf * gf + eps)
            if "v" in s:
                v = s["v"][layer]
                v.copy_(beta * v + keep * g2)
            else:
                r = s["r"][layer]
                r.copy_(beta * r + keep * self._mean(g2, -1,
                                                     self._axes(i, (-1,))))
                if vectors:
                    csum = g2 if csum is None else csum + g2
                    continue
                c = s["c"][layer]
                c.copy_(beta * c + keep * self._mean(g2, -2,
                                                     self._axes(i, (-2,))))
            upd = self._upd(i, layer, s, gf)
            if stacked:
                sums.append((upd * upd).sum())
        if not stacked:
            rms = torch.sqrt(self._mean(upd * upd, None, every) + eps)
            self._apply(first, upd, rms, lr)
            return
        if vectors:
            s["c"].copy_(beta * s["c"] + keep * (csum / len(group)))
            for layer, i in enumerate(group):
                upd = self._upd(i, layer, s)
                sums.append((upd * upd).sum())
        n = len(group) * first.numel() * self._span(every)
        rms = torch.sqrt(self._sum_over(torch.stack(sums).sum(), every) / n
                         + eps)
        for layer, i in enumerate(group):
            self._apply(self.params[i], self._upd(i, layer, s), rms, lr)


OPTIMIZERS = {"sgd": SGD, "adamw": AdamW, "rmsprop": RMSProp,
              "adafactor": Adafactor}


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   **hp) -> _Optimizer:
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](params, **hp)
