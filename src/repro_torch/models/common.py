"""Shared model building blocks: parameter definitions, inits, RMSNorm.

Port of ``repro/models/common.py``.  Parameters are described by
``ParamDef`` trees (nested dicts) so that one structure gives the shapes
and the initialised values; the JAX package's logical sharding axes are
left out (the port runs on one device).  ``init_params`` draws from one
``torch.Generator`` in the order of the tree: the same kinds of init as
the reference, equal in distribution, not in bits (``jax.random`` and
PyTorch draw different numbers), so parity tests carry the reference's
parameters in with ``transformer.params_from_jax``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | embed | a_log
    scale: float | None = None  # override init scale


def map_defs(fn: Callable[[ParamDef], Any], defs: Any) -> Any:
    """Apply ``fn`` to every ``ParamDef`` leaf of a nested dict."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def stack_defs(defs: Any, num_layers: int) -> Any:
    """Prepend a layer dim to every ParamDef (the stacked layer tree)."""
    return map_defs(lambda d: ParamDef((num_layers, *d.shape), d.init, d.scale),
                    defs)


def init_params(defs: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> Any:
    """Initialised tensors for ``defs``: zeros, ones, ``a_log`` = log U[1, 16]
    (Mamba's A), ``embed`` = normal times its scale, and ``normal`` at
    fan-in scale (``shape[-2]`` for matrices) unless a scale is given.
    Drawn on the generator's device, then moved to ``device``."""
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
