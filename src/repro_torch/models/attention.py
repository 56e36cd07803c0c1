"""GQA attention: prefill (full sequence) and decode paths.

Port of ``repro/models/attention.py``.  Layouts, as the
reference's:
  x       (B, S, d_model)
  q       (B, S, Hq, Dh)
  k, v    (B, S, Hkv, Dh)
  cache   (B, S_max, Hkv, Dh)

``attend`` computes what the reference's chunked-q jnp form computes.  On
CUDA tensors with no sliding window in effect it goes through
``kernels/ops.flash_attention`` (kernel B7), on the CPU through the plain
chunked form; a window is applied in plain PyTorch on every device, as it
is plain jnp in the reference (B7 has no window).  A window is in effect
only in a layer that is not global and over a sequence longer than the
window: with S <= window every (query, key) pair lies inside it, and the
windowed mask is the unwindowed one.  B7 carries a gradient:
``ops.flash_attention`` is an autograd Function whose forward is the kernel
and whose backward recomputes B7's plain version from the saved q, k and v
and differentiates it, the gradient the reference takes through its jnp
``attend``; training, the no-grad selection pass and the refresh all see
the kernel's forward.  ``decode_attend`` is plain PyTorch, as the
reference's is plain jnp.  ``update_cache`` writes in place (a ring cache's
index wrapped by the caller, ``models/transformer.py``).  ``cross_attend``
(the encoder-decoder's, ``models/encdec.py``: queries and keys of different
lengths, no mask, no rope) is plain PyTorch on every device, as the
reference's is plain jnp.  Under a model axis the local heads go through
``attend`` (``transformer._attention_tp``); ``decode_attend_sp`` is the
reference's sequence-parallel flash-decode, the cache's sequence dim split
over the model axis: each rank's (max, exp-sum, weighted V) over its span,
one MAX and two SUM all-reduces, plain PyTorch as it is plain jnp there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamDef, rms_norm, rope

NEG_INF = -1e30


def attn_param_defs(d_model: int, n_q: int, n_kv: int, dh: int,
                    qk_norm: bool) -> dict:
    defs = {
        "wq": ParamDef((d_model, n_q, dh), ("fsdp", "tp", None)),
        "wk": ParamDef((d_model, n_kv, dh), ("fsdp", "tp", None)),
        "wv": ParamDef((d_model, n_kv, dh), ("fsdp", "tp", None)),
        "wo": ParamDef((n_q, dh, d_model), ("tp", None, "fsdp")),
    }
    if qk_norm:
        defs["q_norm"] = ParamDef((dh,), (None,), init="ones")
        defs["k_norm"] = ParamDef((dh,), (None,), init="ones")
    return defs


def heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def project_qkv(p: dict, x: torch.Tensor, positions: torch.Tensor,
                theta: float, qk_norm: bool, norm_eps: float):
    q, k, v = heads(x, p["wq"]), heads(x, p["wk"]), heads(x, p["wv"])
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    return rope(q, positions, theta), rope(k, positions, theta), v


def out_proj(a: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matrix product."""
    h, k, d = wo.shape
    return a.reshape(*a.shape[:-2], h * k) @ wo.to(a.dtype).reshape(h * k, d)


def _grouped_scores(q5: torch.Tensor, k: torch.Tensor,
                    scale: float) -> torch.Tensor:
    # q5: (B, Q, Hkv, G, Dh), k: (B, K, Hkv, Dh) -> (B, Hkv, G, Q, K) f32
    return torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * scale


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int | None = None,
           is_global: bool = True, q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention.

    ``window``: sliding-window size, applied unless ``is_global`` or S <=
    ``window`` (where it masks nothing).  Without a window in effect, CUDA
    tensors go through kernel B7 (``ops.flash_attention``).  Otherwise, and
    on the CPU, the reference's form: queries in chunks of ``q_chunk`` when
    S is a multiple of it (so the CPU never holds an S x S score tensor at
    S = 2,048), each chunk's masked scores through a float32 softmax.
    """
    b, s, hq, dh = q.shape
    use_window = window is not None and not bool(is_global) and s > window
    if q.device.type == "cuda" and not use_window:
        return kops.flash_attention(q, k, v, causal)
    hkv = k.shape[2]
    scale = dh ** -0.5
    q5 = q.reshape(b, s, hkv, hq // hkv, dh)
    kpos = torch.arange(s, device=q.device)

    def block(qc: torch.Tensor, q0: int) -> torch.Tensor:
        cq = qc.shape[1]
        scores = _grouped_scores(qc, k, scale)      # (B,Hkv,G,Cq,S) f32
        qpos = q0 + torch.arange(cq, device=q.device)
        mask = torch.ones(cq, s, dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if use_window:
            mask &= qpos[:, None] - kpos[None, :] < window
        scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)

    if s > q_chunk and s % q_chunk == 0:
        out = torch.cat([block(q5[:, i:i + q_chunk], i)
                         for i in range(0, s, q_chunk)], dim=1)
    else:
        out = block(q5, 0)
    return out.reshape(b, s, hq, dh)


def cross_attend(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder cross attention: q (B, Sq, Hq, Dh) against k, v
    (B, Sk, Hkv, Dh), no mask and no rope; GQA by reshape, the scores and
    the softmax in float32 (the reference's ``cross_attend``)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    q5 = q.reshape(b, s, hkv, hq // hkv, dh)
    scores = _grouped_scores(q5, k, dh ** -0.5)     # (B,Hkv,G,Sq,Sk) f32
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, s, hq, dh)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: int, *,
                  window: int | None = None,
                  is_global: bool = True) -> torch.Tensor:
    """One-token attention against a (B, S_max, Hkv, Dh) cache whose first
    ``cache_len`` positions are valid."""
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    b, _, hq, dh = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[1]
    q5 = q.reshape(b, 1, hkv, hq // hkv, dh)
    scores = _grouped_scores(q5, k_cache, dh ** -0.5)   # (B,Hkv,G,1,S)
    kpos = torch.arange(s, device=q.device)
    mask = kpos < cache_len
    if window is not None and not bool(is_global):
        mask &= cache_len - 1 - kpos < window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs,
                        v_cache).reshape(b, 1, hq, dh)


def decode_attend_sp(q: torch.Tensor, k_loc: torch.Tensor,
                     v_loc: torch.Tensor, cache_len: int, start: int,
                     ctx) -> torch.Tensor:
    """One-token attention of q (B, 1, Hq, Dh), every head, against this
    model rank's span of a cache whose sequence dim is split over
    ``"model"`` (``k_loc``/``v_loc`` (B, S_loc, Hkv, Dh) holding positions
    ``start + [0, S_loc)``), the first ``cache_len`` positions valid; no
    window.  The local maximum, then its MAX over ``ctx``'s model ranks,
    the exponentials, and the denominator and the weighted V each summed
    over them (the reference's ``decode_attend_sp``)."""
    k_loc = k_loc.to(q.dtype)
    v_loc = v_loc.to(q.dtype)
    b, _, hq, dh = q.shape
    hkv, s_loc = k_loc.shape[2], k_loc.shape[1]
    kpos = start + torch.arange(s_loc, device=q.device)
    q5 = q.reshape(b, 1, hkv, hq // hkv, dh)
    scores = _grouped_scores(q5, k_loc, dh ** -0.5)      # (B,Hkv,G,1,S_loc)
    scores = scores.masked_fill(~(kpos < cache_len), NEG_INF)
    m = ctx.tp_max(scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m)
    den = ctx.tp_reduce(p.sum(dim=-1))                  # (B,Hkv,G,1)
    num = ctx.tp_reduce(torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype),
                                     v_loc))
    out = num / den[..., None].to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, dh)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, idx: int):
    """Write the new positions at ``idx`` along axis 1, in place and in the
    caches' dtype (the reference returns new arrays; here the caches given
    are the ones written, and are returned).

    The start is placed as the reference's
    ``lax.dynamic_update_slice_in_dim`` places it: a negative ``idx``
    counts from the end (``idx + S_max``), then the start is clamped into
    ``[0, S_max - n]``, so a write that would run past the end overwrites
    the last ``n`` slots."""
    n, s_max = k_new.shape[1], k_cache.shape[1]
    start = int(idx)
    if start < 0:
        start += s_max
    start = min(max(start, 0), s_max - n)
    k_cache[:, start:start + n] = k_new
    v_cache[:, start:start + n] = v_new
    return k_cache, v_cache
