"""Encoder-decoder backbone (seamless-m4t-v2 text/audio translation).

Port of ``repro/models/encdec.py`` for one device.  As in the reference the
modality frontend is a stub: the encoder takes precomputed audio-frame
embeddings ``frames`` (B, S_enc, encoder_input_dim); everything from the
first projection on is real.  The encoder is non-causal self-attention and
the gated MLP; a decoder layer is causal self-attention, cross-attention
over the encoder's output, and the gated MLP.

The parameter tree is the reference's: ``enc_in``, ``enc_layers``
(``ln1/attn/ln2/mlp``), ``enc_norm``, ``embed``, ``dec_layers``
(``ln1/attn/lnx/xattn/ln2/mlp``, the cross-attention without qk_norm),
``out_norm`` and ``lm_head``.  The reference's ``lax.scan`` over layers is
a Python loop; each stack is stacked (L, ...) leaves or a list of L
per-layer trees (``transformer.unstack_layers``, the layout of the
trainable ``models/model.py::LM``).

Self-attention goes through ``attention.attend``: kernel B7 on CUDA
tensors, non-causal in the encoder and causal in the decoder.  The
cross-attention (``attention.cross_attend``, queries and keys of different
lengths) and the decode step's attention are plain PyTorch, as they are
plain jnp in the reference.  ``per_sample_metrics`` is the decoder-only
families' (B1 through ``transformer.token_metrics``).

Serving: ``prefill`` encodes the frames once and keeps each decoder
layer's cross-attention K and V in the cache (``xk``, ``xv``: (L, B,
S_enc, Hkv, Dh)) beside the self-attention's ``k`` and ``v`` (L, B,
max_len, Hkv, Dh); ``decode_step`` writes ``k`` and ``v`` in place and
attends over every ``xk``/``xv`` slot.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import ParamDef, gated_mlp, rms_norm, stack_defs
from repro_torch.models.transformer import index_at, layer_at
from repro_torch.models.transformer import per_sample_metrics  # noqa: F401


def _mlp_defs(d: int, ff: int) -> dict:
    return {"w_gate": ParamDef((d, ff), ("fsdp", "tp")),
            "w_up": ParamDef((d, ff), ("fsdp", "tp")),
            "w_down": ParamDef((ff, d), ("tp", "fsdp"))}


def param_defs(cfg: ArchConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    nq, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    enc_block = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "attn": attn.attn_param_defs(d, nq, nkv, dh, cfg.qk_norm),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "mlp": _mlp_defs(d, cfg.d_ff),
    }
    dec_block = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "attn": attn.attn_param_defs(d, nq, nkv, dh, cfg.qk_norm),
        "lnx": ParamDef((d,), (None,), init="ones"),
        "xattn": attn.attn_param_defs(d, nq, nkv, dh, False),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "mlp": _mlp_defs(d, cfg.d_ff),
    }
    return {
        "enc_in": ParamDef((cfg.encoder_input_dim, d), (None, "fsdp")),
        "enc_layers": stack_defs(enc_block, cfg.num_encoder_layers),
        "enc_norm": ParamDef((d,), (None,), init="ones"),
        "embed": ParamDef((v, d), ("tp", "fsdp"), init="embed", scale=0.02),
        "dec_layers": stack_defs(dec_block, cfg.num_layers),
        "out_norm": ParamDef((d,), (None,), init="ones"),
        "lm_head": ParamDef((d, v), ("fsdp", "tp")),
    }


def _xattn_qkv(p: dict, h_dec: torch.Tensor, enc_out: torch.Tensor):
    return attn.heads(h_dec, p["wq"]), attn.heads(enc_out, p["wk"]), \
        attn.heads(enc_out, p["wv"])


def _cdtype(params: dict) -> torch.dtype:
    dt = params["embed"].dtype
    return torch.bfloat16 if dt.itemsize == 1 else dt


def _mlp_residual(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(h2, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                         p["mlp"]["w_down"])


def _embed(params: dict, tokens: torch.Tensor, dt: torch.dtype):
    # F.embedding, not indexing: its backward sums each row's gradient in a
    # fixed order on both devices (see transformer.embed_inputs).
    return F.embedding(tokens.long(), params["embed"]).to(dt)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over ``frames`` (B, S_enc, E): (B, S_enc, d_model)."""
    dt = _cdtype(params)
    x = frames.to(dt) @ params["enc_in"].to(dt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.num_encoder_layers):
        p = layer_at(params["enc_layers"], i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                                   cfg.qk_norm, cfg.norm_eps)
        x = x + attn.out_proj(attn.attend(q, k, v, causal=False),
                              p["attn"]["wo"])
        x = _mlp_residual(cfg, p, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _decoder_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
                   enc_out: torch.Tensor, positions: torch.Tensor):
    """One decoder layer.  Returns (x, what prefill keeps in the cache:
    the self-attention's k and v, the cross-attention's xk and xv)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                               cfg.qk_norm, cfg.norm_eps)
    x = x + attn.out_proj(attn.attend(q, k, v, causal=True), p["attn"]["wo"])
    hx = rms_norm(x, p["lnx"], cfg.norm_eps)
    qx, kx, vx = _xattn_qkv(p["xattn"], hx, enc_out)
    x = x + attn.out_proj(attn.cross_attend(qx, kx, vx), p["xattn"]["wo"])
    return _mlp_residual(cfg, p, x), {"k": k, "v": v, "xk": kx, "xv": vx}


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["lm_head"].to(x.dtype)


def forward(cfg: ArchConfig, params: dict, batch: dict):
    """Train forward.  batch: ``frames`` (B, S_enc, E), ``tokens`` (B,
    S_dec), optionally ``mask``.  Returns (logits, loss mask, aux = 0)."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    x = _embed(params, tokens, enc_out.dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.num_layers):
        x, _ = _decoder_block(cfg, layer_at(params["dec_layers"], i), x,
                              enc_out, positions)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    return (_logits(params, x), mask,
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None) -> dict:
    """Zero caches on ``device`` (None: CUDA): the self-attention's ``k``
    and ``v`` (L, B, max_len, Hkv, Dh), the cross-attention's ``xk`` and
    ``xv`` (L, B, enc_len, Hkv, Dh)."""
    dev = resolve_device(device)
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    cache: dict[str, Any] = {"len": 0}
    for name, s in (("k", max_len), ("v", max_len), ("xk", enc_len),
                    ("xv", enc_len)):
        cache[name] = torch.zeros((L, batch, s, hkv, dh), dtype=dtype,
                                  device=dev)
    return cache


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Encode the frames, keep each layer's cross K/V, run the prompt.
    Returns the last position's logits (B, 1, V) and the cache (x's
    dtype, ``len`` = S)."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens, enc_out.dtype)
    cache = init_cache(cfg, b, max(max_len or s, s), enc_out.shape[1],
                       dtype=x.dtype, device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    for i in range(cfg.num_layers):
        x, emit = _decoder_block(cfg, layer_at(params["dec_layers"], i), x,
                                 enc_out, positions)
        cache["k"][i, :, :s] = emit["k"]
        cache["v"][i, :, :s] = emit["v"]
        cache["xk"][i] = emit["xk"]
        cache["xv"][i] = emit["xv"]
    cache["len"] = s
    x = rms_norm(x[:, -1:], params["out_norm"], cfg.norm_eps)
    return _logits(params, x), cache


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B, 1).  Returns (logits (B, 1, V), the
    cache with ``len`` + 1): its ``k`` and ``v`` are written in place (the
    new cache holds the same tensors)."""
    x = _embed(params, token, _cdtype(params))
    n = cache["len"]
    positions = torch.full((x.shape[0], 1), n, device=x.device)
    layer_caches = {k: v for k, v in cache.items() if k != "len"}
    for i in range(cfg.num_layers):
        p = layer_at(params["dec_layers"], i)
        lc = index_at(layer_caches, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                                   cfg.qk_norm, cfg.norm_eps)
        kc, vc = attn.update_cache(lc["k"], lc["v"], k, v, n)
        x = x + attn.out_proj(attn.decode_attend(q, kc, vc, n + 1),
                              p["attn"]["wo"])
        hx = rms_norm(x, p["lnx"], cfg.norm_eps)
        qx = attn.heads(hx, p["xattn"]["wq"])
        ax = attn.decode_attend(qx, lc["xk"], lc["xv"], lc["xk"].shape[1])
        x = x + attn.out_proj(ax, p["xattn"]["wo"])
        x = _mlp_residual(cfg, p, x)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    return _logits(params, x), dict(cache, len=n + 1)
