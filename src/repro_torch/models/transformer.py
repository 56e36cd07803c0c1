"""Decoder-only LM: the SSM family (mamba2) of ``repro/models/transformer.py``.

The parameter tree is the reference's: ``embed`` (V, d), ``out_norm`` and
``layers``, every layer leaf stacked along a leading (L, ...) axis.  The
reference's ``lax.scan`` over layers is a Python loop over that axis here.
Only ``cfg.family == "ssm"`` is ported; ``param_defs`` (and so ``Model``)
raises ``NotImplementedError`` for the attention, MoE, hybrid, encdec and
VLM families (ROADMAP A.13).  There is
no ``ParallelCtx``: the port runs on one device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamDef, rms_norm, stack_defs


def check_family(cfg: ArchConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP "
            "A.13); the port runs the 'ssm' family")


def _d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.d_inner or cfg.ssm.expand * cfg.d_model


def param_defs(cfg: ArchConfig) -> dict:
    check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    block = {"ln1": ParamDef((d,), init="ones"),
             "ssm": ssm_mod.ssm_param_defs(d, cfg.ssm, _d_inner(cfg))}
    defs: dict[str, Any] = {
        "embed": ParamDef((v, d), init="embed", scale=0.02),
        "out_norm": ParamDef((d,), init="ones"),
        "layers": stack_defs(block, cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v))
    return defs


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked (L, ...) tree (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


def params_from_jax(np_params: Any, device: str | torch.device | None = None
                    ) -> Any:
    """The port's parameter tree from the JAX LM's (a nested dict of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``): the same structure,
    shapes and layout, as float32 tensors on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, dev) for k, v in np_params.items()}
    return torch.from_numpy(np.array(np_params, dtype=np.float32)).to(dev)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ArchConfig, params: dict,
                 batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), loss_mask (B,S))."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    return x, mask


def _block(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    return x + ssm_mod.ssm_forward(p["ssm"], h, cfg.ssm, _d_inner(cfg),
                                   cfg.norm_eps)


def logits_fn(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward(cfg: ArchConfig, params: dict, batch: dict):
    """Full forward. Returns (logits, loss_mask, moe_aux = 0)."""
    x, mask = embed_inputs(cfg, params, batch)
    for i in range(cfg.num_layers):
        x = _block(cfg, _index(params["layers"], i), x)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), mask, torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# Serving: prefill + decode with stacked per-layer caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu") -> dict:
    """Stacked (L, ...) caches: the SSM state (f32) and the conv buffer.
    ``max_len`` sizes attention caches only; the SSM family has none."""
    di, L = _d_inner(cfg), cfg.num_layers
    one = ssm_mod.ssm_init_cache(batch, cfg.ssm, di, dtype, device)
    return {"len": 0,
            "ssm_state": one["state"].expand(L, *one["state"].shape).clone(),
            "conv_buf": one["conv_buf"].expand(L, *one["conv_buf"].shape).clone()}


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B, 1). Returns (logits (B,1,V), new cache)."""
    x = params["embed"][token.long()]
    states, bufs = [], []
    for i in range(cfg.num_layers):
        p = _index(params["layers"], i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, sc = ssm_mod.ssm_decode_step(
            p["ssm"], h, {"state": cache["ssm_state"][i],
                          "conv_buf": cache["conv_buf"][i]},
            cfg.ssm, _d_inner(cfg), cfg.norm_eps)
        x = x + y
        states.append(sc["state"])
        bufs.append(sc["conv_buf"])
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    new_cache = {"len": cache["len"] + 1, "ssm_state": torch.stack(states),
                 "conv_buf": torch.stack(bufs).to(cache["conv_buf"].dtype)}
    return logits_fn(cfg, params, x), new_cache


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: run the full prompt, return last-position logits + cache."""
    x, _ = embed_inputs(cfg, params, batch)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max(max_len or s, s), dtype=x.dtype,
                       device=x.device)
    states, bufs = [], []
    for i in range(cfg.num_layers):
        p = _index(params["layers"], i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, st, cb = ssm_mod.ssm_forward(p["ssm"], h, cfg.ssm, _d_inner(cfg),
                                        cfg.norm_eps, return_state=True)
        x = x + y
        states.append(st)
        bufs.append(cb)
    cache["ssm_state"] = torch.stack(states)
    cache["conv_buf"] = torch.stack(bufs).to(cache["conv_buf"].dtype)
    cache["len"] = s
    logits = logits_fn(cfg, params,
                       rms_norm(x[:, -1:], params["out_norm"], cfg.norm_eps))
    return logits, cache
