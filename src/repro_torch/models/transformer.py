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
(seamless-m4t) is ``models/encdec.py``; ``models/model.py::Model``
dispatches on the family, and this module's ``unstack_layers`` and
``params_from_jax`` carry its two layer stacks (``enc_layers``,
``dec_layers``) as they carry ``layers``.

Under a ``("data", "model")`` mesh (``dist/sharding.py::ParallelCtx``),
``forward``, ``prefill`` and ``decode_step`` run every decoder-only family
on each rank's shards with the collectives where the reference's GSPMD
puts them: a vocab-parallel embedding, head-parallel attention (B7 on the
local heads, ``wo`` row-parallel), a column- then row-parallel MLP, the
expert-parallel MoE (``models/moe.py``), the SSM's sharded leaves gathered
whole (B6 over every head), the logits' vocab columns gathered (before B1
in training); FSDP's data-sharded dims gathered per layer at use (the
MoE's d_ff shards stay resident in its ``"partial"`` layout); each
training layer a checkpoint under ``remat``.  The VLM's patch embeddings
are projected through the gathered ``mm_proj`` on every rank.

Serving: ``init_cache`` gives stacked (L, ...) caches, a ring buffer of
``attn_window`` slots with ``ring=True``.  As in the reference, a decode
step treats any attention cache no longer than the window as a ring (its
write index wraps, every slot written is attended, the layer's window
flag ignored): ``init_cache(ring=True)``'s, and a flat cache whose prompt
and generation fit in the window.  On a mesh a rank's cache is its block
of the reference's decode layout: the batch split over the data axes, the
heads whole (k and v from split KV heads gathered over "model" before the
write), and under ``seq_parallel_kv`` the sequence split over "model":
a decode step's write goes to the rank that owns the position, and the
attention is ``attention.decode_attend_sp`` over every head, no ring and
no window (the reference's branch comes before both).  The cache's
``len`` is the reference's 0-d int32 tensor, on the cache's device: a
decode step takes its positions, ring slot and masks from it on the
device and reads nothing back to the host, so that one step can be
captured as a CUDA graph (``launch/serve.py::capture_decode``).

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
from repro_torch.models.common import (ParamDef, gated_mlp, remat, rms_norm,
                                      rope, stack_defs)

#: The CLIP-style frontend stub's output width (llava's projector input).
VLM_PATCH_DIM = 1024
#: The stacked layer trees of a parameter tree: the decoder-only families'
#: ``layers``, the encoder-decoder's ``enc_layers`` and ``dec_layers``.
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def _d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.d_inner or cfg.ssm.expand * cfg.d_model


def _mlp_defs(d: int, ff: int) -> dict:
    return {"w_gate": ParamDef((d, ff), ("fsdp", "tp")),
            "w_up": ParamDef((d, ff), ("fsdp", "tp")),
            "w_down": ParamDef((ff, d), ("tp", "fsdp"))}


def _block_defs(cfg: ArchConfig, moe_mode: str = "gather") -> dict:
    d = cfg.d_model
    defs: dict[str, Any] = {"ln1": ParamDef((d,), (None,), init="ones")}
    if cfg.family in ("dense", "moe", "hybrid", "vlm"):
        defs["attn"] = attn.attn_param_defs(
            d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.qk_norm)
        defs["ln2"] = ParamDef((d,), (None,), init="ones")
    if cfg.family == "moe":
        defs["moe"] = moe_mod.moe_param_defs(d, cfg.moe, moe_mode)
    elif cfg.family in ("dense", "vlm", "hybrid"):
        defs["mlp"] = _mlp_defs(d, cfg.d_ff)
    if cfg.family in ("ssm", "hybrid"):
        defs["ssm"] = ssm_mod.ssm_param_defs(d, cfg.ssm, _d_inner(cfg))
    return defs


def param_defs(cfg: ArchConfig, moe_mode: str = "gather") -> dict:
    """The parameter tree's defs; ``moe_mode`` picks the MoE experts'
    FSDP layout (the reference's ``"gather"`` or ``"partial"``)."""
    d, v = cfg.d_model, cfg.vocab_size
    defs: dict[str, Any] = {
        "embed": ParamDef((v, d), ("tp", "fsdp"), init="embed", scale=0.02),
        "out_norm": ParamDef((d,), (None,), init="ones"),
        "layers": stack_defs(_block_defs(cfg, moe_mode), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("fsdp", "tp"))
    if cfg.family == "vlm":
        defs["mm_proj"] = ParamDef((VLM_PATCH_DIM, d), (None, "fsdp"))
    return defs


def index_at(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked (L, ...) tree of tensors or arrays (views,
    no copies)."""
    if isinstance(tree, dict):
        return {k: index_at(v, i) for k, v in tree.items()}
    return tree[i]


def layer_at(layers: Any, i: int) -> Any:
    """Layer ``i``'s tree: an entry of a per-layer list, or views into a
    stacked (L, ...) tree."""
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return index_at(layers, i)


def unstack_layers(params: dict, copy: bool = True) -> dict:
    """``params`` with each stacked layer tree (``LAYER_STACKS``) split into
    a list of L per-layer trees, each leaf a copy with its own storage (a
    view of the stacked tensor would keep the whole (L, ...) tensor as its
    base); ``copy=False``: views (of tensors or numpy arrays)."""
    out = dict(params)
    for key in LAYER_STACKS:
        layers = params.get(key)
        if layers is None or isinstance(layers, (list, tuple)):
            continue
        leaf = layers
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        out[key] = [map_tree(lambda t: t.clone(), index_at(layers, i))
                    if copy else index_at(layers, i)
                    for i in range(leaf.shape[0])]
    return out


def map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(np_params: Any, device: str | torch.device | None = None,
                    unstack: bool = False, shard=None) -> Any:
    """The port's parameter tree from the JAX model's (a nested dict of
    numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``; any family,
    the encoder-decoder's too): the same structure, shapes and layout, as
    float32 tensors on ``device`` (None: CUDA); with ``unstack`` each layer
    stack as a list of per-layer trees (``unstack_layers``), the layout
    ``model.LM`` takes.  ``shard``, a ``models/model.py::Model`` on a
    mesh: this rank's block of every leaf by its spec (``Model.shard``:
    per-layer lists on the model's device)."""
    if shard is not None:
        return shard.shard(np_params)
    dev = resolve_device(device)
    tree = map_tree(lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
                    .to(dev), np_params)
    return unstack_layers(tree) if unstack else tree


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _tp(ctx) -> bool:
    """Whether ``ctx`` splits the layers over a model axis of 2+ ranks."""
    return ctx is not None and ctx.tp_size > 1


def _embed(cfg: ArchConfig, ctx, embed: torch.Tensor,
           tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums each row's gradient in a
    # fixed order on both devices (index_put_'s accumulate does not on the
    # CPU), which the engines' and restart's bit-identity rest on.
    tokens = tokens.long()
    v_local = embed.shape[0]
    if v_local == cfg.vocab_size:
        return F.embedding(tokens, embed)
    # Vocab-parallel: this rank's rows, the others' tokens masked to zero,
    # the partial embeddings summed over "model".
    t = tokens - ctx.tp_rank * v_local
    inside = (t >= 0) & (t < v_local)
    x = F.embedding(torch.where(inside, t, 0), embed)
    return ctx.tp_reduce(x * inside[..., None].to(x.dtype))


def embed_inputs(cfg: ArchConfig, params: dict, batch: dict,
                 ctx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), loss_mask (B,S)); for the VLM, with
    ``patch_embeds`` in the batch, S counts the patch positions in front of
    the text, their mask rows false.  Under a model axis (``ctx``) the
    embedding's vocab rows are sharded: a vocab-parallel lookup."""
    tokens = batch["tokens"]
    x = _embed(cfg, ctx, params["embed"], tokens)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype) @ params["mm_proj"].to(x.dtype)
        x = torch.cat([pe, x], dim=1)
        mask = torch.cat([torch.zeros(pe.shape[:2], dtype=torch.bool,
                                      device=mask.device), mask], dim=1)
    return x, mask


def gather_fsdp(ctx, tree: dict, specs: dict | None) -> dict:
    """``tree`` (this rank's shards) with every dim sharded over the data
    axes all-gathered (ZeRO-3, ``ctx.fsdp_gather``), except the MoE's
    experts in the ``"partial"`` layout, whose d_ff shards stay resident;
    ``tree`` itself without ``specs``."""
    if specs is None:
        return tree
    if "moe" in tree and moe_mod.partial_layout(ctx):
        rest = ctx.gather_fsdp_tree(
            {k: v for k, v in tree.items() if k != "moe"}, specs)
        return dict(rest, moe=tree["moe"])
    return ctx.gather_fsdp_tree(tree, specs)


def _heads_split(cfg: ArchConfig, p: dict, ctx) -> bool:
    """Whether ``ctx``'s model axis splits the q heads of attention ``p``."""
    return _tp(ctx) and p["wq"].shape[1] != cfg.num_heads


def _attention(cfg: ArchConfig, p: dict, h: torch.Tensor,
               positions: torch.Tensor, is_global: bool, ctx=None,
               causal: bool = True):
    """Self-attention of the normed ``h``: (the output projection, k, v).
    Under a model axis that splits the q heads, each rank attends with its
    local heads (``_attention_tp``; its k and v those of its KV heads
    where they are split too)."""
    if _heads_split(cfg, p["attn"], ctx):
        return _attention_tp(cfg, p["attn"], h, positions, is_global, ctx,
                             causal)
    q, k, v = attn.project_qkv(p["attn"], h, positions, cfg.rope_theta,
                               cfg.qk_norm, cfg.norm_eps)
    a = attn.attend(q, k, v, causal=causal, window=cfg.attn_window,
                    is_global=is_global)
    return attn.out_proj(a, p["attn"]["wo"]), k, v


def _local_kv_heads(cfg: ArchConfig, hq_local: int, rank: int):
    """The KV heads rank ``rank``'s q heads read, when the KV heads stay
    replicated: global q head ``h`` reads KV head ``h // (Hq / Hkv)``.  A
    (start, stop) range when every one is read by the same number of
    local q heads (GQA within the rank), else one KV index a q head."""
    g = cfg.num_heads // cfg.num_kv_heads
    idx = [(rank * hq_local + j) // g for j in range(hq_local)]
    lo, hi = idx[0], idx[-1] + 1
    per = hq_local // (hi - lo)
    if idx == [u for u in range(lo, hi) for _ in range(per)]:
        return lo, hi
    return idx


def select_kv(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor,
              hq_local: int, rank: int):
    """The KV heads (dim 2 of ``k``, ``v``: every head) that rank
    ``rank``'s ``hq_local`` q heads read (``_local_kv_heads``)."""
    sel = _local_kv_heads(cfg, hq_local, rank)
    if isinstance(sel, tuple):
        return k[:, :, sel[0]:sel[1]], v[:, :, sel[0]:sel[1]]
    ix = torch.tensor(sel, device=k.device)
    return k.index_select(2, ix), v.index_select(2, ix)


def tp_heads(cfg: ArchConfig, p: dict, hq: torch.Tensor, hkv: torch.Tensor,
             ctx):
    """Head-parallel projections of attention ``p``: q of this rank's
    heads (``wq``'s local columns) from ``hq``, k and v from ``hkv``: of
    this rank's KV heads where ``wk`` and ``wv`` are split, else of every
    KV head, computed whole on every rank.  The inputs of the split
    products enter through ``tp_copy``.  Returns (q, k, v, kv_split)."""
    kv_split = p["wk"].shape[1] != cfg.num_kv_heads
    qin = ctx.tp_copy(hq)
    kin = hkv
    if kv_split:
        kin = qin if hkv is hq else ctx.tp_copy(hkv)
    return (attn.heads(qin, p["wq"]), attn.heads(kin, p["wk"]),
            attn.heads(kin, p["wv"]), kv_split)


def read_kv(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor,
            hq_local: int, kv_split: bool, ctx):
    """The k and v this rank's q heads attend: ``tp_heads``' split ones
    as they are, or the local selection of the whole ones, whose gradient
    is all-reduced over "model" (each rank's q heads read a part)."""
    if kv_split:
        return k, v
    return select_kv(cfg, ctx.tp_copy(k), ctx.tp_copy(v), hq_local,
                     ctx.tp_rank)


def _attention_tp(cfg: ArchConfig, p: dict, h: torch.Tensor,
                  positions: torch.Tensor, is_global: bool, ctx,
                  causal: bool = True):
    """Head-parallel attention: ``wq`` (and ``wk``/``wv`` where the KV heads
    divide) column-sharded over "model", the local heads through
    ``attention.attend`` (kernel B7 on the card), ``wo`` row-parallel with
    one all-reduce.  Replicated KV heads are computed whole on every rank
    and the local q heads' ones selected, their gradient all-reduced.
    Returns (the output, k, v): k and v before the selection."""
    eps = cfg.norm_eps
    q, k, v, kv_split = tp_heads(cfg, p, h, h, ctx)
    if cfg.qk_norm:
        q = rms_norm(q, ctx.tp_copy(p["q_norm"]), eps)
        k = rms_norm(k, ctx.tp_copy(p["k_norm"]) if kv_split
                     else p["k_norm"], eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kr, vr = read_kv(cfg, k, v, q.shape[2], kv_split, ctx)
    a = attn.attend(q, kr, vr, causal=causal, window=cfg.attn_window,
                    is_global=is_global)
    return ctx.tp_reduce(attn.out_proj(a, p["wo"])), k, v


def _ffn_residual(cfg: ArchConfig, p: dict, x: torch.Tensor, ctx=None):
    """The second half of a layer: (x + FFN(norm(x)), the MoE's aux term or
    None).  Under a model axis that splits d_ff the MLP is column- then
    row-parallel, one all-reduce."""
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_ffn(p["moe"], h2, cfg.moe, ctx)
        return x + y, aux
    m = p["mlp"]
    if _tp(ctx) and m["w_gate"].shape[1] != cfg.d_ff:
        return x + ctx.tp_reduce(gated_mlp(ctx.tp_copy(h2), m["w_gate"],
                                           m["w_up"], m["w_down"])), None
    return x + gated_mlp(h2, m["w_gate"], m["w_up"], m["w_down"]), None


#: The SSM leaves the reference shards over "model" and the dim: the fused
#: (z | x | B | C | dt) projection, the conv over (x | B | C), the gated
#: norm over d_inner and the output projection.
_SSM_TP_DIMS = {"w_in": 1, "conv_w": 1, "conv_b": 0, "norm_w": 0, "w_out": 0}


def _ssm_leaves(cfg: ArchConfig, ps: dict, ctx) -> dict:
    """The SSM block's leaves, those a model axis shards gathered whole (a
    rank's even slice of ``w_in``'s fused output is not its heads'
    columns): the block runs over every head on every model rank, its
    weights' gradients the local slices."""
    if not _tp(ctx):
        return ps
    di, n = _d_inner(cfg), cfg.ssm.state_dim
    whole = {"w_in": 2 * di + 2 * n + di // cfg.ssm.head_dim,
             "conv_w": di + 2 * n, "conv_b": di + 2 * n, "norm_w": di,
             "w_out": di}
    ps = dict(ps)
    for name, dim in _SSM_TP_DIMS.items():
        if ps[name].shape[dim] != whole[name]:
            ps[name] = ctx.tp_gather(ps[name], dim)
    return ps


def _ssm(cfg: ArchConfig, p: dict, h: torch.Tensor, state: bool, ctx=None):
    """The SSM block (kernel B6 over every head, ``_ssm_leaves``)."""
    return ssm_mod.ssm_forward(_ssm_leaves(cfg, p["ssm"], ctx), h, cfg.ssm,
                               _d_inner(cfg), cfg.norm_eps,
                               return_state=state)


def _block(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
           is_global: bool, state: bool = False, ctx=None):
    """One layer.  Returns (x, the MoE's aux term or None, emitted): with
    ``state``, ``emitted`` holds what prefill writes into the cache (k and
    v, the SSM's final state and conv buffer).  ``ctx``: the model axis
    the layer's (local) weights are split over."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    emit: dict[str, torch.Tensor] = {}
    if cfg.family == "ssm":
        y = _ssm(cfg, p, h, state, ctx)
        if state:
            y, emit["ssm_state"], emit["conv_buf"] = y
        return x + y, None, emit
    a, k, v = _attention(cfg, p, h, positions, is_global, ctx)
    if state:
        emit["k"], emit["v"] = _whole_kv(cfg, k, v, ctx)
    if cfg.family == "hybrid":
        y = _ssm(cfg, p, h, state, ctx)
        if state:
            y, emit["ssm_state"], emit["conv_buf"] = y
        x = x + 0.5 * (a + y)            # hymba: mean-fused parallel heads
    else:
        x = x + a
    x, aux = _ffn_residual(cfg, p, x, ctx)
    return x, aux, emit


def _whole_kv(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor, ctx):
    """k and v of every KV head (the cache keeps them whole): a model
    axis' split KV heads gathered over "model"."""
    if _tp(ctx) and k.shape[2] != cfg.num_kv_heads:
        return ctx.tp_gather(k, 2), ctx.tp_gather(v, 2)
    return k, v


def global_layer_flags(cfg: ArchConfig) -> list[bool]:
    """Per layer: True = full/global attention, False = sliding window.
    Without a window every layer is global; with one, the first, middle and
    last layers are (hymba)."""
    L = cfg.num_layers
    if cfg.attn_window is None:
        return [True] * L
    return [i in (0, L // 2, L - 1) for i in range(L)]


def logits_fn(cfg: ArchConfig, params: dict, x: torch.Tensor,
              ctx=None) -> torch.Tensor:
    """(..., V) logits.  Under a model axis that splits the vocab: each
    rank's vocab columns, all-gathered over "model" (B1 needs whole
    rows)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if _tp(ctx) and head.shape[1] != cfg.vocab_size:
        return ctx.tp_gather(ctx.tp_copy(x) @ head.to(x.dtype), -1)
    return x @ head.to(x.dtype)


def forward(cfg: ArchConfig, params: dict, batch: dict, ctx=None,
            specs: dict | None = None):
    """Full forward. Returns (logits, loss_mask, moe_aux): the MoE layers'
    aux terms summed in float32 from 0, in layer order (0 for the other
    families).

    Under a mesh (``ctx``, ``dist/sharding.py::ParallelCtx``) ``params``
    are this rank's shards and ``batch`` its rows; ``specs`` (the shards'
    specs, ``layers`` one layer's) marks the dims sharded over the data
    axes, all-gathered at use (ZeRO-3, ``ctx.fsdp_gather``; a layer's
    inside its checkpoint, so the backward gathers it again).  With
    ``ctx.remat`` each layer is a checkpoint by ``ctx.remat_policy``
    (``common.remat``: ``"nothing"`` saves only its input, ``"dots"``
    its matmul outputs too).  With no context, or a (1, 1) mesh, every
    collective is skipped: the same launches on the same inputs."""
    def layer(x, lp, flag):
        return _block(cfg, gather_fsdp(ctx, lp, specs and specs["layers"]),
                      x, positions, flag, ctx=ctx)[:2]

    top = gather_fsdp(ctx, {k: v for k, v in params.items() if k != "layers"},
                      specs)
    x, mask = embed_inputs(cfg, top, batch, ctx)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, flag in enumerate(global_layer_flags(cfg)):
        lp = layer_at(params["layers"], i)
        x, a = remat(ctx, layer, x, lp, flag)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, top["out_norm"], cfg.norm_eps)
    return logits_fn(cfg, top, x, ctx), mask, aux


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
               ring: bool = False, seq_shards: int = 1) -> dict:
    """Stacked (L, ...) zero caches on ``device`` (None: CUDA): k and v of
    (L, B, S_cache, Hkv, Dh) for attention, the SSM state (f32) and the
    conv buffer for the SSM and hybrid families.  S_cache is ``max_len``,
    or with ``ring`` (long-context serving of a windowed arch) at most
    ``attn_window``: a ring buffer, every layer attending its window.
    ``seq_shards``: the number of model ranks the sequence is split over
    (``seq_parallel_kv``); k and v hold one rank's S_cache / seq_shards
    positions.  ``len`` is a 0-d int32 tensor on ``device``, 0."""
    dev = resolve_device(device)
    L = cfg.num_layers
    cache: dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32,
                                                device=dev)}
    if cfg.family != "ssm" and cfg.num_heads:
        s_cache = max_len
        if ring:
            if cfg.attn_window is None:
                raise ValueError(f"{cfg.name}: a ring cache needs a window "
                                 "(attn_window is None)")
            s_cache = min(max_len, cfg.attn_window)
        if s_cache % seq_shards:
            raise ValueError(
                f"seq_parallel_kv: a cache of {s_cache} positions does not "
                f"split over {seq_shards} model ranks")
        shape = (L, batch, s_cache // seq_shards, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        one = ssm_mod.ssm_init_cache(batch, cfg.ssm, _d_inner(cfg), dtype, dev)
        cache["ssm_state"] = one["state"].expand(L, *one["state"].shape).clone()
        cache["conv_buf"] = one["conv_buf"].expand(
            L, *one["conv_buf"].shape).clone()
    return cache


def seq_shards(ctx) -> int:
    """The model ranks a cache's sequence is split over: the model axis'
    size under ``seq_parallel_kv``, else 1."""
    if ctx is None or not ctx.seq_parallel_kv or ctx.tp_axis is None:
        return 1
    return ctx.tp_size


def write_prompt(cache: dict, i: int, k: torch.Tensor, v: torch.Tensor,
                 ctx=None) -> None:
    """Layer ``i``'s prompt k and v (B, S, Hkv, Dh) into the cache's first
    S positions: this rank's span of them under ``seq_parallel_kv``."""
    s = k.shape[1]
    if seq_shards(ctx) == 1:
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        return
    s_loc = cache["k"].shape[2]
    start = ctx.tp_rank * s_loc
    n = min(max(s - start, 0), s_loc)
    cache["k"][i, :, :n] = k[:, start:start + n]
    cache["v"][i, :, :n] = v[:, start:start + n]


def _ssm_step(cfg: ArchConfig, p: dict, h: torch.Tensor, layer_cache: dict,
              ctx=None):
    y, sc = ssm_mod.ssm_decode_step(
        _ssm_leaves(cfg, p["ssm"], ctx), h,
        {"state": layer_cache["ssm_state"],
         "conv_buf": layer_cache["conv_buf"]},
        cfg.ssm, _d_inner(cfg), cfg.norm_eps)
    return y, {"ssm_state": sc["state"], "conv_buf": sc["conv_buf"]}


def decode_attention(cfg: ArchConfig, p: dict, h: torch.Tensor,
                     layer_cache: dict, cache_len: torch.Tensor,
                     is_global: bool, ctx=None) -> torch.Tensor:
    """One decode step's self-attention of the normed ``h`` (B, 1, d):
    the new k and v written into ``layer_cache``'s (this rank's block of
    the layer's cache, in place), the output projection returned.

    ``cache_len`` is the cache's 0-d int32 tensor: the position, the ring
    slot (``torch.remainder``) and the valid counts are device values, and
    no branch reads them.  Under a model axis that splits the q heads, the
    local heads attend the KV heads they read (``select_kv``) and ``wo`` is
    row-parallel.  Under ``seq_parallel_kv`` the position's owner writes it
    (every rank writes its clamped slot, the others their own values back),
    and every rank attends all heads over its span
    (``attention.decode_attend_sp``), then keeps its heads' slice: as in
    the reference this branch comes before the ring and the window, so
    neither applies."""
    positions = cache_len.expand(h.shape[0], 1).long()  # as prefill's arange
    q, k, v = attn.project_qkv(p, h, positions, cfg.rope_theta,
                               cfg.qk_norm, cfg.norm_eps)
    k, v = _whole_kv(cfg, k, v, ctx)
    split = _heads_split(cfg, p, ctx)
    shards = seq_shards(ctx)
    s_loc = layer_cache["k"].shape[1]
    s_cache = s_loc * shards
    ring = cfg.attn_window is not None and s_cache <= cfg.attn_window
    idx = torch.remainder(cache_len, s_cache) if ring else cache_len
    if shards > 1:
        # The write clamped into the cache, as update_cache places it, on
        # the rank whose span holds the slot; the others rewrite theirs.
        kc, vc = layer_cache["k"], layer_cache["v"]
        start = ctx.tp_rank * s_loc
        at = idx.clamp(max=s_cache - 1) - start
        mine = (at >= 0) & (at < s_loc)
        slot = at.clamp(0, s_loc - 1).long().reshape(1)
        k_old, v_old = kc.index_select(1, slot), vc.index_select(1, slot)
        attn.update_cache(kc, vc, torch.where(mine, k.to(kc.dtype), k_old),
                          torch.where(mine, v.to(vc.dtype), v_old), slot)
        a = attn.decode_attend_sp(ctx.tp_gather(q, 2) if split else q,
                                  layer_cache["k"], layer_cache["v"],
                                  cache_len + 1, start, ctx)
        if split:
            hl = q.shape[2]
            a = a[:, :, ctx.tp_rank * hl:(ctx.tp_rank + 1) * hl]
    else:
        kc, vc = attn.update_cache(layer_cache["k"], layer_cache["v"], k, v,
                                   idx)
        if split:
            kc, vc = select_kv(cfg, kc, vc, q.shape[2], ctx.tp_rank)
        if ring:
            # Every slot written lies inside the window: mask only the
            # unwritten.
            a = attn.decode_attend(q, kc, vc,
                                   torch.clamp(cache_len + 1, max=s_cache))
        else:
            a = attn.decode_attend(q, kc, vc, cache_len + 1,
                                   window=cfg.attn_window,
                                   is_global=is_global)
    a = attn.out_proj(a, p["wo"])
    return ctx.tp_reduce(a) if split else a


def _decode_block(cfg: ArchConfig, p: dict, x: torch.Tensor, layer_cache: dict,
                  cache_len: torch.Tensor, is_global: bool,
                  ctx=None) -> tuple[torch.Tensor, dict]:
    """One layer of one decode step.  Writes k and v into ``layer_cache``'s
    (views of the stacked cache) in place; returns (x, the SSM's new state
    and conv buffer, or nothing)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.family == "ssm":
        y, new = _ssm_step(cfg, p, h, layer_cache, ctx)
        return x + y, new
    a = decode_attention(cfg, p["attn"], h, layer_cache, cache_len,
                         is_global, ctx)
    new: dict[str, torch.Tensor] = {}
    if cfg.family == "hybrid":
        y, new = _ssm_step(cfg, p, h, layer_cache, ctx)
        x = x + 0.5 * (a + y)
    else:
        x = x + a
    return _ffn_residual(cfg, p, x, ctx)[0], new


def _top(params: dict) -> dict:
    return {k: v for k, v in params.items() if k != "layers"}


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor,
                cache: dict, ctx=None,
                specs: dict | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B, 1). Returns (logits (B,1,V), new cache).

    The attention cache's k and v are written in place (the new cache
    holds the same tensors); the SSM state, the conv buffer and ``len``
    (the 0-d int32 position, + 1) are new tensors, the old cache's are not
    modified.  Nothing is read back to the host: one step can be captured
    (``launch/serve.py::capture_decode``).  On a mesh (``ctx``,
    ``specs`` as ``forward``'s) ``params`` are this rank's shards, and
    ``token`` and ``cache`` this data rank's rows; the logits are whole
    over the vocab."""
    top = gather_fsdp(ctx, _top(params), specs)
    x = _embed(cfg, ctx, top["embed"], token)
    n = cache["len"]
    layer_caches = {k: v for k, v in cache.items() if k != "len"}
    emitted: dict[str, list] = {}
    for i, flag in enumerate(global_layer_flags(cfg)):
        lp = gather_fsdp(ctx, layer_at(params["layers"], i),
                         specs and specs["layers"])
        x, new = _decode_block(cfg, lp, x, index_at(layer_caches, i), n, flag,
                               ctx)
        for k, t in new.items():
            emitted.setdefault(k, []).append(t)
    x = rms_norm(x, top["out_norm"], cfg.norm_eps)
    new_cache = dict(cache, len=n + 1)
    for k, ts in emitted.items():
        new_cache[k] = torch.stack(ts).to(cache[k].dtype)
    return logits_fn(cfg, top, x, ctx), new_cache


def prefill(cfg: ArchConfig, params: dict, batch: dict,
            max_len: int | None = None, ctx=None,
            specs: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: run the full prompt, return last-position logits + cache.
    The cache holds x's dtype, as the reference's, and covers the VLM's
    patch positions; the MoE layers' aux terms are dropped.  On a mesh
    (``ctx``, ``specs`` as ``forward``'s) ``params`` are this rank's
    shards and ``batch`` this data rank's rows, and the cache is this
    rank's block (``init_cache``'s ``seq_shards``)."""
    top = gather_fsdp(ctx, _top(params), specs)
    x, _ = embed_inputs(cfg, top, batch, ctx)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max(max_len or s, s), dtype=x.dtype,
                       device=x.device, seq_shards=seq_shards(ctx))
    positions = torch.arange(s, device=x.device)[None, :]
    states, bufs = [], []
    for i, flag in enumerate(global_layer_flags(cfg)):
        lp = gather_fsdp(ctx, layer_at(params["layers"], i),
                         specs and specs["layers"])
        x, _, emit = _block(cfg, lp, x, positions, flag, state=True, ctx=ctx)
        if "k" in emit:
            write_prompt(cache, i, emit["k"], emit["v"], ctx)
        if "ssm_state" in emit:
            states.append(emit["ssm_state"])
            bufs.append(emit["conv_buf"])
    if states:
        cache["ssm_state"] = torch.stack(states)
        cache["conv_buf"] = torch.stack(bufs).to(cache["conv_buf"].dtype)
    cache["len"] = torch.full((), s, dtype=torch.int32, device=x.device)
    logits = logits_fn(cfg, top,
                       rms_norm(x[:, -1:], top["out_norm"], cfg.norm_eps), ctx)
    return logits, cache
