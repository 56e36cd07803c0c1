"""Architecture and shape configuration schema of the model zoo.

The port's own copy of ``repro/configs/base.py`` (``MoEConfig``,
``SSMConfig``, ``ArchConfig`` with ``reduced()``, ``attn_free``,
``sub_quadratic``, ``param_count()`` and ``active_param_count()``, the
``ShapeSpec`` cells of ``SHAPES`` with ``shape_applicable`` and
``tokens_per_step``, ``round_up``): the same fields, defaults, reduction
and integer arithmetic, so a config of either package describes the same
model and the launcher's counts agree.  Nothing here is imported from the
JAX package.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int          # N (ssm_state)
    head_dim: int = 64      # P
    expand: int = 2         # d_inner = expand * d_model (mamba2 default)
    conv_width: int = 4
    chunk: int = 128        # SSD chunk length
    d_inner: int | None = None  # override (hybrid archs size it to heads)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                # 0 for attn-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None   # default d_model // num_heads
    qk_norm: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_window: int | None = None
    num_encoder_layers: int = 0
    encoder_input_dim: int = 0
    num_patch_tokens: int = 0
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""
    optimizer: str = "adamw"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        assert self.num_heads > 0
        return self.d_model // self.num_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context (500K) decode/prefill is feasible."""
        return self.family == "ssm" or (
            self.family == "hybrid" and self.attn_window is not None
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim if self.num_heads else 0
        n = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.num_heads:
            per_layer += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
            per_layer += self.num_heads * hd * d
        if self.moe is not None:
            per_layer += self.moe.num_experts * 3 * d * self.moe.d_ff_expert
            per_layer += d * self.moe.num_experts  # router
        elif ff > 0:
            per_layer += 3 * d * ff  # gated MLP
        if self.ssm is not None:
            di = self.ssm.d_inner or self.ssm.expand * d
            nh = di // self.ssm.head_dim
            # in_proj -> (z, x, B, C, dt), conv over (x,B,C), out_proj.
            per_layer += d * (2 * di + 2 * self.ssm.state_dim + nh)
            per_layer += self.ssm.conv_width * (di + 2 * self.ssm.state_dim)
            per_layer += di * d + 2 * nh  # out_proj + A_log + D
        n += L * per_layer
        if self.num_encoder_layers:
            enc_layer = (d * self.num_heads * hd * 2 +
                         2 * d * self.num_kv_heads * hd + 3 * d * ff)
            n += self.num_encoder_layers * enc_layer + self.encoder_input_dim * d
        return n

    def active_param_count(self) -> int:
        """Active (per-token) params: an MoE counts only top_k experts."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        full = self.param_count()
        all_experts = L * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        active = L * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return full - all_experts + active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        heads = 0 if self.num_heads == 0 else 4
        kv = 0 if self.num_kv_heads == 0 else 2
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=257,
            head_dim=16 if heads else None,
            moe=None if self.moe is None else MoEConfig(
                num_experts=4, top_k=min(2, self.moe.top_k), d_ff_expert=64),
            ssm=None if self.ssm is None else dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16), head_dim=16,
                chunk=16, d_inner=64 if self.ssm.d_inner else None),
            attn_window=None if self.attn_window is None else 32,
            num_encoder_layers=2 if self.num_encoder_layers else 0,
            encoder_input_dim=32 if self.encoder_input_dim else 0,
            num_patch_tokens=8 if self.num_patch_tokens else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn): 512K ctx needs sub-quadratic attention"
    return True, ""


def tokens_per_step(shape: ShapeSpec) -> int:
    """Tokens a step processes: the whole (batch, seq) for train and
    prefill, one new token a sequence for decode."""
    if shape.kind in ("train", "prefill"):
        return shape.seq_len * shape.global_batch
    return shape.global_batch


def round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
