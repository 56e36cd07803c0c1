"""Plain PyTorch reference of the two LM families the cells train, their
per-sample (loss, PA, PC), AdamW, and KAKURENBO's plan.

Written from the published descriptions, in float32 with TF32 off
(``precision``), over a flat ``{name: tensor}`` of weights named as in
``h100_bench/weights.py``:

- dense (Qwen3): RMSNorm, grouped-query attention with RMS-normed q and k
  and rotary embeddings (half-split rotation), causal softmax attention,
  SwiGLU MLP, untied or tied output head;
- ssm (Mamba-2): the fused input projection split into (z, x, B, C, dt), a
  depthwise causal conv over (x, B, C) and SiLU, dt = softplus(dt +
  dt_bias), A = -exp(a_log), the SSD recurrence h_t = exp(dt A) h_{t-1} +
  dt B_t x_t, y_t = C_t h_t + D x_t computed chunk by chunk
  (``ssd_chunked``: the same sums, ordered by chunks), y gated by SiLU(z),
  RMS-normed, projected out; tied embeddings.

A sequence's loss is its mean token cross-entropy, its PC the mean top
probability, its PA whether at least half its tokens are right (the gold
logit at the row's maximum).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 matrix products, exact (TF32 off) unless ``tf32``."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotary(x, theta: float):
    """x (B, S, H, D) rotated by position: the halves (x1, x2) become
    (x1 cos - x2 sin, x2 cos + x1 sin)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(arch, w, pre, h):
    b, s, d = h.shape
    hq, hkv, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    eps = arch["norm_eps"]
    q = (h @ w[pre + "attn.wq"].reshape(d, hq * hd)).reshape(b, s, hq, hd)
    k = (h @ w[pre + "attn.wk"].reshape(d, hkv * hd)).reshape(b, s, hkv, hd)
    v = (h @ w[pre + "attn.wv"].reshape(d, hkv * hd)).reshape(b, s, hkv, hd)
    if arch["qk_norm"]:
        q = rms_norm(q, w[pre + "attn.q_norm"], eps)
        k = rms_norm(k, w[pre + "attn.k_norm"], eps)
    q, k = rotary(q, arch["rope_theta"]), rotary(k, arch["rope_theta"])
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, NEG_INF), dim=-1)
    a = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hq * hd)
    return a @ w[pre + "attn.wo"].reshape(hq * hd, d)


def ssd_chunked(x, dt, a, bm, cm, chunk: int):
    """The SSD recurrence's outputs (without the D skip), x (B, S, H, P),
    dt (B, S, H) after the softplus, a (H,) < 0, bm and cm (B, S, N); S a
    multiple of ``chunk``."""
    bsz, s, nh, p = x.shape
    n, nc = bm.shape[-1], s // chunk
    xr = x.reshape(bsz, nc, chunk, nh, p)
    dtr = dt.reshape(bsz, nc, chunk, nh)
    br, cr = bm.reshape(bsz, nc, chunk, n), cm.reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(dtr * a, dim=2)                   # (B, nc, l, H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(diff.masked_fill(~tri[None, None, :, :, None], NEG_INF))
    scores = (torch.einsum("bctn,bcsn->bcts", cr, br)[..., None] * decay
              * dtr[:, :, None, :, :])
    y = torch.einsum("bctsh,bcshp->bcthp", scores, xr)
    seg = cum[:, :, -1]                                   # (B, nc, H)
    wgt = torch.exp(seg[:, :, None, :] - cum) * dtr
    states = torch.einsum("bcsh,bcsn,bcshp->bchnp", wgt, br, xr)
    state = torch.zeros(bsz, nh, n, p, dtype=x.dtype, device=x.device)
    before = []
    for i in range(nc):
        before.append(state)
        state = state * torch.exp(seg[:, i])[:, :, None, None] + states[:, i]
    y = y + torch.einsum("bctn,bcth,bchnp->bcthp", cr, torch.exp(cum),
                         torch.stack(before, dim=1))
    return y.reshape(bsz, s, nh, p)


def mamba2(arch, w, pre, h):
    ssm = arch["ssm"]
    b, s, d = h.shape
    di, n, width = ssm["expand"] * d, ssm["state_dim"], ssm["conv_width"]
    nh, p = di // ssm["head_dim"], ssm["head_dim"]
    z, xin, bm, cm, dt = torch.split(h @ w[pre + "ssm.w_in"],
                                     [di, di, n, n, nh], dim=-1)
    xbc = F.pad(torch.cat([xin, bm, cm], dim=-1), (0, 0, width - 1, 0))
    cw = w[pre + "ssm.conv_w"]
    conv = sum(xbc[:, i:i + s] * cw[i] for i in range(width))
    xin, bm, cm = torch.split(F.silu(conv + w[pre + "ssm.conv_b"]),
                              [di, n, n], dim=-1)
    dt = F.softplus(dt + w[pre + "ssm.dt_bias"])
    a = -torch.exp(w[pre + "ssm.a_log"])
    xh = xin.reshape(b, s, nh, p)
    y = ssd_chunked(xh, dt, a, bm, cm, ssm["chunk"])
    y = y + w[pre + "ssm.d_skip"][None, None, :, None] * xh
    y = rms_norm(y.reshape(b, s, di) * F.silu(z), w[pre + "ssm.norm_w"],
                 arch["norm_eps"])
    return y @ w[pre + "ssm.w_out"]


def logits(arch, w, tokens):
    """(B, S, V) float32 logits of (B, S) token ids."""
    eps = arch["norm_eps"]
    x = F.embedding(tokens.long(), w["embed"])
    for i in range(arch["num_layers"]):
        pre = f"layers.{i}."
        h = rms_norm(x, w[pre + "ln1"], eps)
        if arch["family"] == "ssm":
            x = x + mamba2(arch, w, pre, h)
            continue
        x = x + attention(arch, w, pre, h)
        h = rms_norm(x, w[pre + "ln2"], eps)
        x = x + (F.silu(h @ w[pre + "mlp.w_gate"]) * (h @ w[pre + "mlp.w_up"])
                 ) @ w[pre + "mlp.w_down"]
    x = rms_norm(x, w["out_norm"], eps)
    return x @ (w["embed"].T if arch["tie_embeddings"] else w["lm_head"])


def per_sample(arch, w, batch):
    """Per-sequence (loss, PA, PC) of a batch, the loss differentiable."""
    lg = logits(arch, w, batch["tokens"])
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, batch["labels"].long()[..., None])[..., 0]
    top = lg.amax(dim=-1)
    ce = lse - gold
    m = batch["mask"].to(torch.float32)
    denom = m.sum(-1).clamp(min=1.0)
    loss = (ce * m).sum(-1) / denom
    acc = ((gold >= top).to(torch.float32) * m).sum(-1) / denom
    pc = (torch.exp(top - lse) * m).sum(-1) / denom
    return loss, acc >= 0.5, pc.detach()


class AdamW:
    """Adam with decoupled weight decay, in float32."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, m: dict | None = None,
                 v: dict | None = None, t: int = 0):
        """From zero moments, or from copies of ``m`` and ``v`` after
        ``t`` steps."""
        self.params = params
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(p) if m is None else m[k].clone()
                  for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) if v is None else v[k].clone()
                  for k, p in params.items()}
        self.t = t

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))


def plan(loss: np.ndarray, seen: np.ndarray, perm: np.ndarray,
         max_fraction: float, moveback: bool, pa=None, pc=None,
         tau: float = 0.7):
    """KAKURENBO's plan of one epoch (paper Sec. 3.1-3.2, "sort"): hide
    the floor(F N) lowest lagging losses (ties by index) among the samples
    seen before, of those (with move-back) only the ones correct with PC >=
    tau; train the others in the epoch's shuffled order; scale the LR by
    1 / (1 - F*), F* the hidden share, in float32.  Returns (hidden mask,
    visible order, hidden in shuffled order, LR factor)."""
    n = loss.shape[0]
    f32 = np.float32
    num_hide = int(np.floor(f32(max_fraction) * f32(n)))
    rank = np.empty(n, np.int64)
    rank[np.argsort(loss, kind="stable")] = np.arange(n)
    hidden = (rank < num_hide) & (seen >= 0)
    if moveback:
        hidden &= pa & (pc >= f32(tau))
    perm = np.asarray(perm)
    order_visible = perm[~hidden[perm]]
    order_hidden = perm[hidden[perm]]
    f_star = f32(hidden.sum()) * (f32(1.0) / f32(n))
    factor = f32(1.0) / (f32(1.0) - min(f_star, f32(0.95)))
    return hidden, order_visible, order_hidden, float(factor)
