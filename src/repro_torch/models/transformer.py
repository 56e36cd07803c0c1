"""Decoder-only LM: the dense (llama-style GQA) and SSM (mamba2) families of
``repro/models/transformer.py``.

The parameter tree is the reference's: ``embed`` (V, d), ``out_norm``,
``lm_head`` unless tied, and ``layers``, every layer leaf stacked along a
leading (L, ...) axis.  The reference's ``lax.scan`` over layers is a Python
loop over that axis here.  Every pass also takes ``layers`` as a list of L
per-layer trees (``unstack_layers``), the layout of the trainable
``models/model.py::LM``, whose layers are separate parameters.  Only
``cfg.family`` "dense" and "ssm" are ported; ``param_defs`` (and so
``Model``) raises ``NotImplementedError`` for the MoE, hybrid, encdec and
VLM families (ROADMAP A.6), and the ring (sliding-window) cache waits for
the hybrid family.  There is no ``ParallelCtx``: the port runs on one
device.

``token_metrics`` and ``per_sample_metrics`` are KAKURENBO's sequence-level
signals (reference ``transformer.py:199-231``), the per-token triple from
``kernels/ops.fused_loss_metrics``: kernel B1 forward and backward on the
card, its plain version on the CPU.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamDef, gated_mlp, rms_norm, stack_defs

PORTED_FAMILIES = ("dense", "ssm")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP "
            f"A.6, the model zoo); the port runs the families "
            f"{PORTED_FAMILIES}")


def _d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.d_inner or cfg.ssm.expand * cfg.d_model


def _mlp_defs(d: int, ff: int) -> dict:
    return {"w_gate": ParamDef((d, ff)), "w_up": ParamDef((d, ff)),
            "w_down": ParamDef((ff, d))}


def _block_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    defs: dict[str, Any] = {"ln1": ParamDef((d,), init="ones")}
    if cfg.family == "dense":
        defs["attn"] = attn.attn_param_defs(
            d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.qk_norm)
        defs["ln2"] = ParamDef((d,), init="ones")
        defs["mlp"] = _mlp_defs(d, cfg.d_ff)
    else:
        defs["ssm"] = ssm_mod.ssm_param_defs(d, cfg.ssm, _d_inner(cfg))
    return defs


def param_defs(cfg: ArchConfig) -> dict:
    check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    defs: dict[str, Any] = {
        "embed": ParamDef((v, d), init="embed", scale=0.02),
        "out_norm": ParamDef((d,), init="ones"),
        "layers": stack_defs(_block_defs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v))
    return defs


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked (L, ...) tree (views, no copies)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


def _layer(layers: Any, i: int) -> Any:
    """Layer ``i``'s tree: an entry of a per-layer list, or views into a
    stacked (L, ...) tree."""
    return layers[i] if isinstance(layers, (list, tuple)) else _index(layers, i)


def unstack_layers(params: dict) -> dict:
    """``params`` with its stacked ``layers`` tree split into a list of L
    per-layer trees, each leaf a copy with its own storage (a view of the
    stacked tensor would keep the whole (L, ...) tensor as its base)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return params
    leaf = layers
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return dict(params, layers=[
        _map(lambda t: t.clone(), _index(layers, i))
        for i in range(leaf.shape[0])])


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: Any, device: str | torch.device | None = None,
                    unstack: bool = False) -> Any:
    """The port's parameter tree from the JAX LM's (a nested dict of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``): the same structure,
    shapes and layout, as float32 tensors on ``device`` (None: CUDA); with
    ``unstack`` the layers as a list of per-layer trees (``unstack_layers``),
    the layout ``model.LM`` takes."""
    dev = resolve_device(device)
    tree = _map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
                .to(dev), np_params)
    return unstack_layers(tree) if unstack else tree


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ArchConfig, params: dict,
                 batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), loss_mask (B,S))."""
    tokens = batch["tokens"]
    # F.embedding, not indexing: its backward sums each row's gradient in a
    # fixed order on both devices (index_put_'s accumulate does not on the
    # CPU), which the engines' and restart's bit-identity rest on.
    x = F.embedding(tokens.long(), params["embed"])
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    return x, mask


def _mlp_residual(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(h2, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                         p["mlp"]["w_down"])


def _dense_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, is_global: bool):
    """One dense layer: attention, then the gated MLP, each with its
    residual.  Returns (x, k, v); prefill writes k and v into the cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                               cfg.qk_norm, cfg.norm_eps)
    a = attn.attend(q, k, v, causal=True, window=cfg.attn_window,
                    is_global=is_global)
    x = x + attn.out_proj(a, p["attn"]["wo"])
    return _mlp_residual(cfg, p, x), k, v


def _block(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
           is_global: bool) -> torch.Tensor:
    """One layer of the full forward."""
    if cfg.family == "ssm":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        return x + ssm_mod.ssm_forward(p["ssm"], h, cfg.ssm, _d_inner(cfg),
                                       cfg.norm_eps)
    return _dense_block(cfg, p, x, positions, is_global)[0]


def global_layer_flags(cfg: ArchConfig) -> list[bool]:
    """Per layer: True = full/global attention, False = sliding window.
    Without a window every layer is global; with one, the first, middle and
    last layers are (hymba)."""
    L = cfg.num_layers
    if cfg.attn_window is None:
        return [True] * L
    return [i in (0, L // 2, L - 1) for i in range(L)]


def logits_fn(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward(cfg: ArchConfig, params: dict, batch: dict):
    """Full forward. Returns (logits, loss_mask, moe_aux = 0)."""
    x, mask = embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, flag in enumerate(global_layer_flags(cfg)):
        x = _block(cfg, _layer(params["layers"], i), x, positions, flag)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), mask, torch.zeros((), device=x.device)


def token_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Per-token (ce, correct, pmax) of (..., V) logits, through
    ``ops.fused_loss_metrics`` over the flattened rows: kernel B1 forward
    (and its backward kernel for ce's gradient) on the card, its plain
    version on the CPU.  ``correct`` is B1's ``gold >= max``; the
    reference's ``argmax == label`` differs only where another logit ties
    the gold one at the maximum (ROADMAP C)."""
    v = logits.shape[-1]
    ce, correct, pmax = kops.fused_loss_metrics(
        logits.reshape(-1, v), labels.reshape(-1).to(torch.int32))
    shape = labels.shape
    return ce.reshape(shape), correct.reshape(shape), pmax.reshape(shape)


def per_sample_metrics(cfg: ArchConfig, logits: torch.Tensor,
                       labels: torch.Tensor, mask: torch.Tensor,
                       pa_threshold: float = 0.5):
    """Sequence-level (loss, PA, PC), KAKURENBO's importance signals: for
    an LM a "sample" is a sequence; loss is the masked mean token CE, PC
    the masked mean max softmax probability, PA token accuracy >=
    ``pa_threshold``.  A row with no unmasked token divides by 1."""
    ce, correct, pmax = token_metrics(logits, labels)
    m = mask.to(torch.float32)
    denom = torch.clamp(m.sum(dim=-1), min=1.0)
    loss = (ce * m).sum(dim=-1) / denom
    acc = (correct.to(torch.float32) * m).sum(dim=-1) / denom
    pc = (pmax * m).sum(dim=-1) / denom
    return loss, acc >= pa_threshold, pc


# ---------------------------------------------------------------------------
# Serving: prefill + decode with stacked per-layer caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None) -> dict:
    """Stacked (L, ...) zero caches on ``device`` (None: CUDA): k and v of
    (L, B, max_len, Hkv, Dh) for attention, the SSM state (f32) and the
    conv buffer for the SSM family."""
    dev = resolve_device(device)
    L = cfg.num_layers
    cache: dict[str, Any] = {"len": 0}
    if cfg.family == "dense":
        shape = (L, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    else:
        one = ssm_mod.ssm_init_cache(batch, cfg.ssm, _d_inner(cfg), dtype, dev)
        cache["ssm_state"] = one["state"].expand(L, *one["state"].shape).clone()
        cache["conv_buf"] = one["conv_buf"].expand(
            L, *one["conv_buf"].shape).clone()
    return cache


def _decode_block(cfg: ArchConfig, p: dict, x: torch.Tensor, layer_cache: dict,
                  cache_len: int, is_global: bool) -> tuple[torch.Tensor, dict]:
    """One layer of one decode step.  Writes k and v into ``layer_cache``'s
    (views of the stacked cache) in place; returns (x, the SSM family's new
    state and conv buffer, or nothing)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, sc = ssm_mod.ssm_decode_step(
            p["ssm"], h, {"state": layer_cache["ssm_state"],
                          "conv_buf": layer_cache["conv_buf"]},
            cfg.ssm, _d_inner(cfg), cfg.norm_eps)
        return x + y, {"ssm_state": sc["state"], "conv_buf": sc["conv_buf"]}
    positions = torch.full((x.shape[0], 1), cache_len, device=x.device)
    q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                               cfg.qk_norm, cfg.norm_eps)
    kc, vc = attn.update_cache(layer_cache["k"], layer_cache["v"], k, v,
                               cache_len)
    a = attn.decode_attend(q, kc, vc, cache_len + 1, window=cfg.attn_window,
                           is_global=is_global)
    x = x + attn.out_proj(a, p["attn"]["wo"])
    return _mlp_residual(cfg, p, x), {}


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B, 1). Returns (logits (B,1,V), new cache).

    The attention cache's k and v are written in place (the new cache
    holds the same tensors); the SSM family's state and conv buffer are
    new tensors, the old cache's are not modified."""
    x = F.embedding(token.long(), params["embed"])
    n = cache["len"]
    layer_caches = {k: v for k, v in cache.items() if k != "len"}
    emitted: dict[str, list] = {}
    for i, flag in enumerate(global_layer_flags(cfg)):
        x, new = _decode_block(cfg, _layer(params["layers"], i), x,
                               _index(layer_caches, i), n, flag)
        for k, t in new.items():
            emitted.setdefault(k, []).append(t)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    new_cache = dict(cache, len=n + 1)
    for k, ts in emitted.items():
        new_cache[k] = torch.stack(ts).to(cache[k].dtype)
    return logits_fn(cfg, params, x), new_cache


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: run the full prompt, return last-position logits + cache.
    The cache holds x's dtype, as the reference's."""
    x, _ = embed_inputs(cfg, params, batch)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max(max_len or s, s), dtype=x.dtype,
                       device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    states, bufs = [], []
    for i, flag in enumerate(global_layer_flags(cfg)):
        p = _layer(params["layers"], i)
        if cfg.family == "ssm":
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            y, st, cb = ssm_mod.ssm_forward(p["ssm"], h, cfg.ssm,
                                            _d_inner(cfg), cfg.norm_eps,
                                            return_state=True)
            x = x + y
            states.append(st)
            bufs.append(cb)
        else:
            x, k, v = _dense_block(cfg, p, x, positions, flag)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    if states:
        cache["ssm_state"] = torch.stack(states)
        cache["conv_buf"] = torch.stack(bufs).to(cache["conv_buf"].dtype)
    cache["len"] = s
    logits = logits_fn(cfg, params,
                       rms_norm(x[:, -1:], params["out_norm"], cfg.norm_eps))
    return logits, cache
