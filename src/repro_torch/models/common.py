"""Shared model building blocks: parameter definitions, inits, RMSNorm,
rotary embedding and the gated MLP.

Port of ``repro/models/common.py``.  Parameters are described by
``ParamDef`` trees (nested dicts) so that one structure gives the shapes,
the initialised values and, through each def's logical axes (one entry a
dim, ``None`` replicated), the sharding specs of a mesh
(``dist/sharding.py::spec_tree_for``, ``models/model.py::Model.param_specs``;
``logical_tree``, ``abstract_params`` on meta tensors).  ``init_params`` draws from one
``torch.Generator`` in the order of the tree: the same kinds of init as
the reference, equal in distribution, not in bits (``jax.random`` and
PyTorch draw different numbers), so parity tests carry the reference's
parameters in with ``transformer.params_from_jax``.

``remat(ctx, fn, *args)`` runs one layer under the context's recompute
policy: the reference's ``jax.checkpoint`` with ``nothing_saveable``
(``"nothing"``: only the layer's inputs kept) or ``checkpoint_dots``
(``"dots"``: the matmul outputs kept, the rest recomputed).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple | None = None  # per dim: a logical axis name or None
    init: str = "normal"        # normal | zeros | ones | embed | a_log
    scale: float | None = None  # override init scale

    def __post_init__(self):
        if self.logical is None:
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        assert len(self.logical) == len(self.shape), (self.shape, self.logical)


def map_defs(fn: Callable[[ParamDef], Any], defs: Any) -> Any:
    """Apply ``fn`` to every ``ParamDef`` leaf of a nested dict."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def stack_defs(defs: Any, num_layers: int) -> Any:
    """Prepend a layer dim to every ParamDef (the stacked layer tree)."""
    return map_defs(lambda d: ParamDef((num_layers, *d.shape),
                                       (None, *d.logical), d.init, d.scale),
                    defs)


def logical_tree(defs: Any) -> Any:
    """The tree of each def's logical axes."""
    return map_defs(lambda d: d.logical, defs)


def abstract_params(defs: Any, dtype: torch.dtype = torch.float32) -> Any:
    """The tree as meta tensors: shapes and dtype, no storage."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                    defs)


def init_params(defs: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> Any:
    """Initialised tensors for ``defs``: zeros, ones, ``a_log`` = log U[1, 16]
    (Mamba's A), ``embed`` = normal times its scale, and ``normal`` at
    fan-in scale (``shape[-2]`` for matrices) unless a scale is given.
    Drawn on the generator's device, then moved to ``device`` (None: CUDA)."""
    device = resolve_device(device)
    gdev = generator.device

    def one(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            v = torch.zeros(d.shape)
        elif d.init == "ones":
            v = torch.ones(d.shape)
        elif d.init == "a_log":
            v = torch.log(torch.empty(d.shape, device=gdev).uniform_(
                1.0, 16.0, generator=generator))
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            if d.init == "embed":
                scale = d.scale or 1.0
            else:
                scale = d.scale or (1.0 / max(fan_in, 1)) ** 0.5
            v = torch.randn(d.shape, generator=generator, device=gdev) * scale
        return v.to(device=device, dtype=dtype)

    return map_defs(one, defs)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the variance taken in float32, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the reference's float32 order: frequencies
    ``1 / theta ** (arange(half) / half)``, the angle, cos and sin, then the
    two rotated halves concatenated.  x: (..., S, H, D); positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_down``."""
    dt = x.dtype
    g = F.silu(x @ w_gate.to(dt))
    return (g * (x @ w_up.to(dt))) @ w_down.to(dt)


#: The matmul ops whose outputs ``remat_policy="dots"`` keeps: the
#: reference's ``checkpoint_dots`` saves every ``dot_general``.
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                     torch.ops.aten.bmm.default,
                     torch.ops.aten.baddbmm.default})
#: Collective namespaces: always recomputed, so the FSDP gathers of a layer
#: run again in its backward, as the reference's do.
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional"})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    if getattr(op, "namespace", None) in _COLLECTIVE_NAMESPACES:
        return ckpt.CheckpointPolicy.MUST_RECOMPUTE
    # Everything else, the kernels' ``torch.empty`` outputs (filled in
    # place through ctypes, which no policy sees) included, runs again.
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(ctx, fn: Callable, *args):
    """``fn(*args)``; under ``ctx.remat`` a ``torch.utils.checkpoint`` of
    it by ``ctx.remat_policy``: ``"nothing"`` keeps only the inputs,
    ``"dots"`` also the outputs of ``DOT_OPS`` (a selective checkpoint).
    The kernels B1, B6 and B7 run through ctypes, opaque to the policy:
    under ``"dots"`` they are recomputed (the reference's jnp attention is
    dots, which ``checkpoint_dots`` keeps)."""
    if ctx is None or not ctx.remat:
        return fn(*args)
    if ctx.remat_policy == "nothing":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if ctx.remat_policy == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat_policy={ctx.remat_policy!r}: 'nothing' or "
                     "'dots'")
