"""Architecture configuration schema of the model zoo.

The port's own copy of ``repro/configs/base.py`` (``MoEConfig``,
``SSMConfig``, ``ArchConfig`` with ``reduced()``, ``round_up``): the same
fields, defaults and reduction, so a config of either package describes the
same model.  Nothing here is imported from the JAX package.
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


def round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
