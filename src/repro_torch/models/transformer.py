"""Decoder-only LM: the dense, MoE, SSM, hybrid and VLM families of
``repro/models/transformer.py``.

The parameter tree is the reference's: ``embed`` (V, d), ``out_norm``,
``lm_head`` unless tied, ``mm_proj`` for the VLM, and ``layers``, every
layer leaf stacked along a leading (L, ...) axis.  The reference's
``lax.scan`` over layers is a Python loop over that axis here.  Every pass
also takes ``layers`` as a list of L per-layer trees (``unstack_layers``),
the layout of the trainable ``models/model.py::LM``, whose layers are
separate parameters.  A layer by family, as the reference's ``_block``:

- dense and vlm: attention, then the gated MLP, each with its residual;
- moe: attention, then ``models/moe.py::moe_ffn``, whose load-balancing
  terms ``forward`` sums over the layers in float32, in layer order;
- ssm: the mamba2 block alone;
- hybrid (hymba): attention and the SSM block on the same normed input,
  mean-fused (``x + 0.5 (a + s)``), then the MLP; sliding-window attention
  except in the first, middle and last layers.

The VLM prepends its projected patch embeddings (``patch_embeds @
mm_proj``) to the text, their loss mask false.  The ``encdec`` family
(seamless-m4t) waits for ``models/encdec.py`` (ROADMAP A.6(d)):
``param_defs`` (and so ``Model``) raises ``NotImplementedError`` for it.
There is no ``ParallelCtx``: the port runs on one device.

Serving: ``init_cache`` gives stacked (L, ...) caches, a ring buffer of
``attn_window`` slots with ``ring=True``.  As in the reference, a decode
step treats any attention cache no longer than the window as a ring (its
write index wraps, every slot written is attended, the layer's window
flag ignored): ``init_cache(ring=True)``'s, and a flat cache whose prompt
and generation fit in the window.

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
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamDef, gated_mlp, rms_norm, stack_defs

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
#: The CLIP-style frontend stub's output width (llava's projector input).
VLM_PATCH_DIM = 1024


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP "
            f"A.6(d), models/encdec.py); the port runs the families "
            f"{PORTED_FAMILIES}")


def _d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.d_inner or cfg.ssm.expand * cfg.d_model


def _mlp_defs(d: int, ff: int) -> dict:
    return {"w_gate": ParamDef((d, ff)), "w_up": ParamDef((d, ff)),
            "w_down": ParamDef((ff, d))}


def _block_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    defs: dict[str, Any] = {"ln1": ParamDef((d,), init="ones")}
    if cfg.family in ("dense", "moe", "hybrid", "vlm"):
        defs["attn"] = attn.attn_param_defs(
            d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.qk_norm)
        defs["ln2"] = ParamDef((d,), init="ones")
    if cfg.family == "moe":
        defs["moe"] = moe_mod.moe_param_defs(d, cfg.moe)
    elif cfg.family in ("dense", "vlm", "hybrid"):
        defs["mlp"] = _mlp_defs(d, cfg.d_ff)
    if cfg.family in ("ssm", "hybrid"):
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
    if cfg.family == "vlm":
        defs["mm_proj"] = ParamDef((VLM_PATCH_DIM, d))
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
    """Returns (x (B,S,d), loss_mask (B,S)); for the VLM, with
    ``patch_embeds`` in the batch, S counts the patch positions in front of
    the text, their mask rows false."""
    tokens = batch["tokens"]
    # F.embedding, not indexing: its backward sums each row's gradient in a
    # fixed order on both devices (index_put_'s accumulate does not on the
    # CPU), which the engines' and restart's bit-identity rest on.
    x = F.embedding(tokens.long(), params["embed"])
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype) @ params["mm_proj"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
        mask = torch.cat([torch.zeros(pe.shape[:2], dtype=torch.bool,
                                      device=mask.device), mask], dim=1)
    return x, mask


def _attention(cfg: ArchConfig, p: dict, h: torch.Tensor,
               positions: torch.Tensor, is_global: bool):
    """Self-attention of the normed ``h``: (the output projection, k, v)."""
    q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                               cfg.qk_norm, cfg.norm_eps)
    a = attn.attend(q, k, v, causal=True, window=cfg.attn_window,
                    is_global=is_global)
    return attn.out_proj(a, p["attn"]["wo"]), k, v


def _ffn_residual(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """The second half of a layer: (x + FFN(norm(x)), the MoE's aux term or
    None)."""
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_ffn(p["moe"], h2, cfg.moe)
        return x + y, aux
    return x + gated_mlp(h2, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                         p["mlp"]["w_down"]), None


def _ssm(cfg: ArchConfig, p: dict, h: torch.Tensor, state: bool):
    return ssm_mod.ssm_forward(p["ssm"], h, cfg.ssm, _d_inner(cfg),
                               cfg.norm_eps, return_state=state)


def _block(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
           is_global: bool, state: bool = False):
    """One layer.  Returns (x, the MoE's aux term or None, emitted): with
    ``state``, ``emitted`` holds what prefill writes into the cache (k and
    v, the SSM's final state and conv buffer)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    emit: dict[str, torch.Tensor] = {}
    if cfg.family == "ssm":
        y = _ssm(cfg, p, h, state)
        if state:
            y, emit["ssm_state"], emit["conv_buf"] = y
        return x + y, None, emit
    a, emit["k"], emit["v"] = _attention(cfg, p, h, positions, is_global)
    if cfg.family == "hybrid":
        y = _ssm(cfg, p, h, state)
        if state:
            y, emit["ssm_state"], emit["conv_buf"] = y
        x = x + 0.5 * (a + y)            # hymba: mean-fused parallel heads
    else:
        x = x + a
    x, aux = _ffn_residual(cfg, p, x)
    return x, aux, emit


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
    """Full forward. Returns (logits, loss_mask, moe_aux): the MoE layers'
    aux terms summed in float32 from 0, in layer order (0 for the other
    families)."""
    check_family(cfg)
    x, mask = embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, flag in enumerate(global_layer_flags(cfg)):
        x, a, _ = _block(cfg, _layer(params["layers"], i), x, positions, flag)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), mask, aux


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
               device: torch.device | str | None = None,
               ring: bool = False) -> dict:
    """Stacked (L, ...) zero caches on ``device`` (None: CUDA): k and v of
    (L, B, S_cache, Hkv, Dh) for attention, the SSM state (f32) and the
    conv buffer for the SSM and hybrid families.  S_cache is ``max_len``,
    or with ``ring`` (long-context serving of a windowed arch) at most
    ``attn_window``: a ring buffer, every layer attending its window."""
    dev = resolve_device(device)
    L = cfg.num_layers
    cache: dict[str, Any] = {"len": 0}
    if cfg.family != "ssm" and cfg.num_heads:
        s_cache = max_len
        if ring:
            if cfg.attn_window is None:
                raise ValueError(f"{cfg.name}: a ring cache needs a window "
                                 "(attn_window is None)")
            s_cache = min(max_len, cfg.attn_window)
        shape = (L, batch, s_cache, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        one = ssm_mod.ssm_init_cache(batch, cfg.ssm, _d_inner(cfg), dtype, dev)
        cache["ssm_state"] = one["state"].expand(L, *one["state"].shape).clone()
        cache["conv_buf"] = one["conv_buf"].expand(
            L, *one["conv_buf"].shape).clone()
    return cache


def _ssm_step(cfg: ArchConfig, p: dict, h: torch.Tensor, layer_cache: dict):
    y, sc = ssm_mod.ssm_decode_step(
        p["ssm"], h, {"state": layer_cache["ssm_state"],
                      "conv_buf": layer_cache["conv_buf"]},
        cfg.ssm, _d_inner(cfg), cfg.norm_eps)
    return y, {"ssm_state": sc["state"], "conv_buf": sc["conv_buf"]}


def _decode_block(cfg: ArchConfig, p: dict, x: torch.Tensor, layer_cache: dict,
                  cache_len: int, is_global: bool) -> tuple[torch.Tensor, dict]:
    """One layer of one decode step.  Writes k and v into ``layer_cache``'s
    (views of the stacked cache) in place; returns (x, the SSM's new state
    and conv buffer, or nothing)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, new = _ssm_step(cfg, p, h, layer_cache)
        return x + y, new
    positions = torch.full((x.shape[0], 1), cache_len, device=x.device)
    q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                               cfg.qk_norm, cfg.norm_eps)
    s_cache = layer_cache["k"].shape[1]
    ring = cfg.attn_window is not None and s_cache <= cfg.attn_window
    kc, vc = attn.update_cache(layer_cache["k"], layer_cache["v"], k, v,
                               cache_len % s_cache if ring else cache_len)
    if ring:
        # Every slot written lies inside the window: mask only the unwritten.
        a = attn.decode_attend(q, kc, vc, min(cache_len + 1, s_cache))
    else:
        a = attn.decode_attend(q, kc, vc, cache_len + 1,
                               window=cfg.attn_window, is_global=is_global)
    a = attn.out_proj(a, p["attn"]["wo"])
    new: dict[str, torch.Tensor] = {}
    if cfg.family == "hybrid":
        y, new = _ssm_step(cfg, p, h, layer_cache)
        x = x + 0.5 * (a + y)
    else:
        x = x + a
    return _ffn_residual(cfg, p, x)[0], new


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B, 1). Returns (logits (B,1,V), new cache).

    The attention cache's k and v are written in place (the new cache
    holds the same tensors); the SSM state and conv buffer are new
    tensors, the old cache's are not modified."""
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
    The cache holds x's dtype, as the reference's, and covers the VLM's
    patch positions; the MoE layers' aux terms are dropped."""
    x, _ = embed_inputs(cfg, params, batch)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max(max_len or s, s), dtype=x.dtype,
                       device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    states, bufs = [], []
    for i, flag in enumerate(global_layer_flags(cfg)):
        x, _, emit = _block(cfg, _layer(params["layers"], i), x, positions,
                            flag, state=True)
        if "k" in emit:
            cache["k"][i, :, :s] = emit["k"]
            cache["v"][i, :, :s] = emit["v"]
        if "ssm_state" in emit:
            states.append(emit["ssm_state"])
            bufs.append(emit["conv_buf"])
    if states:
        cache["ssm_state"] = torch.stack(states)
        cache["conv_buf"] = torch.stack(bufs).to(cache["conv_buf"].dtype)
    cache["len"] = s
    logits = logits_fn(cfg, params,
                       rms_norm(x[:, -1:], params["out_norm"], cfg.norm_eps))
    return logits, cache
