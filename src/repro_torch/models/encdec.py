"""Encoder-decoder backbone (seamless-m4t-v2 text/audio translation).

Port of ``repro/models/encdec.py``.  As in the reference the modality
frontend is a stub: the encoder takes precomputed audio-frame embeddings
``frames`` (B, S_enc, encoder_input_dim); everything from the first
projection on is real.  The encoder is non-causal self-attention and the
gated MLP; a decoder layer is causal self-attention, cross-attention over
the encoder's output, and the gated MLP.

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

Under a ``("data", "model")`` mesh (``ctx``, and ``specs``, the shards'
per-layer specs) every pass runs on this rank's shards as
``transformer.forward`` does: ``enc_in`` and every data-sharded dim
FSDP-gathered at use (a layer's inside its checkpoint under
``ctx.remat``), the encoder's and the decoder's self-attention
head-parallel through B7 on the local heads
(``transformer._attention_tp``), the cross-attention head-parallel and
plain, the MLP column- then row-parallel, the embedding vocab-parallel
and ``lm_head``'s vocab columns gathered.

Serving: ``prefill`` encodes the frames once and keeps each decoder
layer's cross-attention K and V in the cache (``xk``, ``xv``: (L, B,
S_enc, Hkv, Dh)) beside the self-attention's ``k`` and ``v`` (L, B,
max_len, Hkv, Dh); ``decode_step`` writes ``k`` and ``v`` in place and
attends over every ``xk``/``xv`` slot.  On a mesh the caches hold this
data rank's rows and every head (the sequence of ``k``/``v`` split over
"model" under ``seq_parallel_kv``, as ``transformer.decode_attention``
reads it).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import ParamDef, rms_norm, stack_defs
from repro_torch.models.transformer import index_at, layer_at
from repro_torch.models.transformer import per_sample_metrics  # noqa: F401


def param_defs(cfg: ArchConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    nq, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    enc_block = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "attn": attn.attn_param_defs(d, nq, nkv, dh, cfg.qk_norm),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "mlp": tf._mlp_defs(d, cfg.d_ff),
    }
    dec_block = {
        "ln1": ParamDef((d,), (None,), init="ones"),
        "attn": attn.attn_param_defs(d, nq, nkv, dh, cfg.qk_norm),
        "lnx": ParamDef((d,), (None,), init="ones"),
        "xattn": attn.attn_param_defs(d, nq, nkv, dh, False),
        "ln2": ParamDef((d,), (None,), init="ones"),
        "mlp": tf._mlp_defs(d, cfg.d_ff),
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


def _cdtype(params: dict) -> torch.dtype:
    dt = params["embed"].dtype
    return torch.bfloat16 if dt.itemsize == 1 else dt


def _mlp_residual(cfg: ArchConfig, p: dict, x: torch.Tensor,
                  ctx=None) -> torch.Tensor:
    return tf._ffn_residual(cfg, p, x, ctx)[0]


def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           dt: torch.dtype, ctx=None):
    # F.embedding, not indexing (see transformer._embed): vocab-parallel
    # under a model axis that splits the vocab.
    return tf._embed(cfg, ctx, params["embed"], tokens).to(dt)


def _top(params: dict) -> dict:
    return {k: v for k, v in params.items()
            if k not in ("enc_layers", "dec_layers")}


def _layers(ctx, params: dict, specs: dict | None, key: str, i: int):
    """Layer ``i`` of stack ``key``, FSDP-gathered on a mesh."""
    return tf.gather_fsdp(ctx, layer_at(params[key], i),
                          specs and specs[key])


def _run(ctx, fn, *args):
    """``fn(*args)``, a checkpoint under ``ctx.remat`` (nothing saved but
    its inputs)."""
    if ctx is not None and ctx.remat:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _enc_layer(cfg: ArchConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, ctx=None) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a = tf._attention(cfg, p, h, positions, True, ctx, causal=False)[0]
    return _mlp_residual(cfg, p, x + a, ctx)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, ctx=None,
           specs: dict | None = None, top: dict | None = None) -> torch.Tensor:
    """The encoder over ``frames`` (B, S_enc, E): (B, S_enc, d_model).
    ``top``: the non-layer leaves, already gathered on a mesh."""
    if top is None:
        top = tf.gather_fsdp(ctx, _top(params), specs)
    dt = _cdtype(top)
    x = frames.to(dt) @ top["enc_in"].to(dt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def layer(x, lp):
        return _enc_layer(cfg, tf.gather_fsdp(
            ctx, lp, specs and specs["enc_layers"]), x, positions, ctx)

    for i in range(cfg.num_encoder_layers):
        x = _run(ctx, layer, x, layer_at(params["enc_layers"], i))
    return rms_norm(x, top["enc_norm"], cfg.norm_eps)


def _cross_attention(cfg: ArchConfig, p: dict, hx: torch.Tensor,
                     enc_out: torch.Tensor, ctx=None):
    """Cross-attention of the normed decoder states over the encoder's
    output: (the output projection, k, v).  Under a model axis that splits
    the heads: head-parallel, plain, ``wo`` row-parallel (k and v those of
    the local KV heads where they are split too)."""
    if tf._heads_split(cfg, p, ctx):
        q, k, v, kv_split = tf.tp_heads(cfg, p, hx, enc_out, ctx)
        kr, vr = tf.read_kv(cfg, k, v, q.shape[2], kv_split, ctx)
        a = ctx.tp_reduce(attn.out_proj(attn.cross_attend(q, kr, vr),
                                        p["wo"]))
        return a, k, v
    q, k, v = (attn.heads(hx, p["wq"]), attn.heads(enc_out, p["wk"]),
               attn.heads(enc_out, p["wv"]))
    return attn.out_proj(attn.cross_attend(q, k, v), p["wo"]), k, v


def _decoder_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
                   enc_out: torch.Tensor, positions: torch.Tensor, ctx=None,
                   state: bool = False):
    """One decoder layer.  Returns (x, with ``state`` what prefill keeps
    in the cache: the self-attention's k and v, the cross-attention's xk
    and xv, every KV head)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, k, v = tf._attention(cfg, p, h, positions, True, ctx)
    x = x + a
    hx = rms_norm(x, p["lnx"], cfg.norm_eps)
    ax, kx, vx = _cross_attention(cfg, p["xattn"], hx, enc_out, ctx)
    x = _mlp_residual(cfg, p, x + ax, ctx)
    if not state:
        return x, {}
    k, v = tf._whole_kv(cfg, k, v, ctx)
    kx, vx = tf._whole_kv(cfg, kx, vx, ctx)
    return x, {"k": k, "v": v, "xk": kx, "xv": vx}


def forward(cfg: ArchConfig, params: dict, batch: dict, ctx=None,
            specs: dict | None = None):
    """Train forward.  batch: ``frames`` (B, S_enc, E), ``tokens`` (B,
    S_dec), optionally ``mask``.  Returns (logits, loss mask, aux = 0).
    On a mesh ``params`` are this rank's shards and ``batch`` its rows."""
    top = tf.gather_fsdp(ctx, _top(params), specs)
    enc_out = encode(cfg, params, batch["frames"], ctx, specs, top)
    tokens = batch["tokens"]
    x = _embed(cfg, top, tokens, enc_out.dtype, ctx)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def layer(x, enc_out, lp):
        return _decoder_block(cfg, tf.gather_fsdp(
            ctx, lp, specs and specs["dec_layers"]), x, enc_out, positions,
            ctx)[0]

    for i in range(cfg.num_layers):
        x = _run(ctx, layer, x, enc_out, layer_at(params["dec_layers"], i))
    x = rms_norm(x, top["out_norm"], cfg.norm_eps)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    return (tf.logits_fn(cfg, top, x, ctx), mask,
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str | None = None,
               seq_shards: int = 1) -> dict:
    """Zero caches on ``device`` (None: CUDA): the self-attention's ``k``
    and ``v`` (L, B, max_len / seq_shards, Hkv, Dh: one model rank's span
    under ``seq_parallel_kv``), the cross-attention's ``xk`` and ``xv``
    (L, B, enc_len, Hkv, Dh)."""
    dev = resolve_device(device)
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    if max_len % seq_shards:
        raise ValueError(
            f"seq_parallel_kv: a cache of {max_len} positions does not split "
            f"over {seq_shards} model ranks")
    cache: dict[str, Any] = {"len": 0}
    for name, s in (("k", max_len // seq_shards), ("v", max_len // seq_shards),
                    ("xk", enc_len), ("xv", enc_len)):
        cache[name] = torch.zeros((L, batch, s, hkv, dh), dtype=dtype,
                                  device=dev)
    return cache


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            max_len: int | None = None, ctx=None,
            specs: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Encode the frames, keep each layer's cross K/V, run the prompt.
    Returns the last position's logits (B, 1, V) and the cache (x's
    dtype, ``len`` = S).  On a mesh: this rank's shards and rows, this
    rank's block of the cache."""
    top = tf.gather_fsdp(ctx, _top(params), specs)
    enc_out = encode(cfg, params, batch["frames"], ctx, specs, top)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(cfg, top, tokens, enc_out.dtype, ctx)
    cache = init_cache(cfg, b, max(max_len or s, s), enc_out.shape[1],
                       dtype=x.dtype, device=x.device,
                       seq_shards=tf.seq_shards(ctx))
    positions = torch.arange(s, device=x.device)[None, :]
    for i in range(cfg.num_layers):
        x, emit = _decoder_block(cfg, _layers(ctx, params, specs,
                                              "dec_layers", i),
                                 x, enc_out, positions, ctx, state=True)
        tf.write_prompt(cache, i, emit["k"], emit["v"], ctx)
        cache["xk"][i] = emit["xk"]
        cache["xv"][i] = emit["xv"]
    cache["len"] = s
    x = rms_norm(x[:, -1:], top["out_norm"], cfg.norm_eps)
    return tf.logits_fn(cfg, top, x, ctx), cache


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor,
                cache: dict, ctx=None,
                specs: dict | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B, 1).  Returns (logits (B, 1, V), the
    cache with ``len`` + 1): its ``k`` and ``v`` are written in place (the
    new cache holds the same tensors).  On a mesh the cross-attention is
    head-parallel: the local q heads against the KV heads they read."""
    top = tf.gather_fsdp(ctx, _top(params), specs)
    x = _embed(cfg, top, token, _cdtype(top), ctx)
    n = cache["len"]
    layer_caches = {k: v for k, v in cache.items() if k != "len"}
    for i in range(cfg.num_layers):
        p = _layers(ctx, params, specs, "dec_layers", i)
        lc = index_at(layer_caches, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + tf.decode_attention(cfg, p["attn"], h, lc, n, True, ctx)
        hx = rms_norm(x, p["lnx"], cfg.norm_eps)
        qx = attn.heads(hx, p["xattn"]["wq"])
        split = tf._heads_split(cfg, p["xattn"], ctx)
        xk, xv = lc["xk"], lc["xv"]
        if split:
            xk, xv = tf.select_kv(cfg, xk, xv, qx.shape[2], ctx.tp_rank)
        ax = attn.out_proj(attn.decode_attend(qx, xk, xv, xk.shape[1]),
                           p["xattn"]["wo"])
        x = _mlp_residual(cfg, p, x + (ctx.tp_reduce(ax) if split else ax),
                          ctx)
    x = rms_norm(x, top["out_norm"], cfg.norm_eps)
    return tf.logits_fn(cfg, top, x, ctx), dict(cache, len=n + 1)
