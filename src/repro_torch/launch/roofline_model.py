"""Analytic HBM-traffic model for the roofline memory term.

Port of ``repro/launch/roofline_model.py``: the same integers for the same
config and shape (``tests/test_torch_launch.py`` holds them equal).  The
model counts the bytes a step must move through device memory, not what a
compiler's cost analysis counts op by op.  Its denominators for the port
are the H100's (``launch/mesh.py``: ``HBM_BW``, ``PEAK_FLOPS_BF16``).

Assumptions (stated once, used everywhere):
  * weights bf16 (2 B); optimizer moments f32 (AdamW) / factored (Adafactor);
  * layer remat (nothing saved): weights read 3x in training (fwd,
    recompute, bwd), one (B,S,d) carry saved+reloaded per layer;
  * attention runs as a fused flash kernel (scores never touch HBM):
    kernel B7 on the card;
  * MoE: all resident expert weights stream from HBM each step (dispatch
    touches every local expert); capacity buffers stay on-chip;
  * decode reads the whole KV cache once per step, writes one position.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec

BF16 = 2
F32 = 4
I32 = 4
U32 = 4


def _opt_bytes_per_param(optimizer: str) -> float:
    """HBM bytes/param for grads + optimizer state r/w + param write."""
    grad = 2 * BF16          # grad write (bwd) + read (opt)
    pwrite = BF16
    if optimizer == "adamw":
        return grad + pwrite + 4 * F32          # m r/w + v r/w in f32
    if optimizer == "adafactor":
        return grad + pwrite + 1                # factored state ~ negligible
    # sgd-momentum / rmsprop: state in param dtype
    return grad + pwrite + 2 * BF16


def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeSpec,
                       optimizer: str = "adamw",
                       weight_bytes: int = BF16) -> dict[str, float]:
    """Global HBM bytes per step, broken into terms.

    ``weight_bytes``: serving-weight precision (2 = bf16, 1 = fp8-e4m3 —
    the quantized-serving §Perf variant).
    """
    P = cfg.param_count()
    b, s = shape.global_batch, shape.seq_len
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    L_total = L + cfg.num_encoder_layers
    terms: dict[str, float] = {}
    if shape.kind == "train":
        tokens = b * s
        terms["weights"] = 3 * BF16 * P          # fwd + remat + bwd
        terms["optimizer"] = _opt_bytes_per_param(optimizer) * P
        # one saved residual carry per layer: write fwd, read bwd
        terms["activations"] = 2 * BF16 * L_total * tokens * d
        # logits: fwd write + bwd read + grad write (big-vocab dominant)
        terms["logits"] = 3 * BF16 * tokens * V
        terms["embeds"] = 2 * BF16 * tokens * d
    elif shape.kind == "prefill":
        tokens = b * s
        terms["weights"] = weight_bytes * P
        terms["activations"] = BF16 * L_total * tokens * d
        if cfg.num_heads:
            kv = 2 * L * tokens * cfg.num_kv_heads * cfg.resolved_head_dim
            terms["kv_cache_write"] = weight_bytes * kv
        terms["logits"] = BF16 * b * V
    else:  # decode: one token, cache length s
        terms["weights"] = weight_bytes * P
        if cfg.num_heads:
            s_cache = s
            if cfg.attn_window is not None and cfg.sub_quadratic:
                s_cache = min(s, cfg.attn_window)
            kv = 2 * L * b * s_cache * cfg.num_kv_heads * cfg.resolved_head_dim
            terms["kv_cache_read"] = weight_bytes * kv
        if cfg.ssm is not None:
            di = cfg.ssm.d_inner or cfg.ssm.expand * d
            nh = di // cfg.ssm.head_dim
            state = L * b * nh * cfg.ssm.state_dim * cfg.ssm.head_dim
            terms["ssm_state"] = 2 * F32 * state     # read + write
        terms["logits"] = BF16 * b * V
    terms["total"] = sum(terms.values())
    return terms


def kernel_hbm_bytes(kernel: str, **shape) -> int:
    """Minimal HBM traffic of one kernel call, in bytes.

    The per-kernel analogue of ``analytic_hbm_bytes``: every operand read
    once + every output written once (the streaming kernels are
    single-pass by construction, so this floor is what they should
    actually move); divided by the card's stream bandwidth it is a
    kernel's byte bound.

    Shapes (keyword-only, mirroring each kernel's bench record):
      flash_attention: b, s, hq, hkv, d     (q + k + v read, o written; f32)
      ssd_scan:        b, s, nh, p, n       (x/dt/b/c read, y + state written)
      loss_confidence: t, v                 (logits + labels read; 3 outs)
      fused_scoring:   t, v                 (same traffic as loss_confidence)
      loss_histogram:  n [, bins]           (loss + valid read, hist written)
      loss_minmax:     n                    (loss + valid read, 2 scalars)
      rank_select:     n                    (5 streaming passes: 4 radix
                                             histograms + the select pass
                                             over the uint32 keys + mask out)
    """
    if kernel == "flash_attention":
        b, s, hq, hkv, d = (shape[k] for k in ("b", "s", "hq", "hkv", "d"))
        return F32 * (b * s * hq * d * 2 + b * s * hkv * d * 2)
    if kernel == "ssd_scan":
        b, s, nh, p, n = (shape[k] for k in ("b", "s", "nh", "p", "n"))
        return F32 * (b * s * nh * p * 2      # x read + y written
                      + b * s * nh            # dt
                      + b * s * n * 2         # b + c
                      + b * nh * n * p)       # final state written
    if kernel in ("loss_confidence", "fused_scoring"):
        t, v = shape["t"], shape["v"]
        return F32 * t * v + I32 * t + 3 * F32 * t
    if kernel == "loss_histogram":
        n = shape["n"]
        return F32 * n + n + I32 * shape.get("bins", 512)
    if kernel == "loss_minmax":
        n = shape["n"]
        return F32 * n + n + 2 * F32
    if kernel == "rank_select":
        n = shape["n"]
        return 5 * U32 * n + n
    raise ValueError(f"no HBM byte model for kernel {kernel!r}")
