"""``--arch <id>`` registry: the JAX package's ten architectures (the
dense, MoE, SSM, hybrid, VLM and encoder-decoder families)."""
from repro_torch.configs import (
    hymba_1_5b, internlm2_20b, kimi_k2_1t, llava_next_mistral_7b,
    mamba2_130m, mistral_large_123b, phi35_moe_42b, qwen3_1_7b,
    seamless_m4t_large_v2, smollm_135m,
)
from repro_torch.configs.base import SHAPES, ArchConfig, shape_applicable

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_1_7b, smollm_135m, internlm2_20b, mistral_large_123b,
              phi35_moe_42b, kimi_k2_1t, mamba2_130m, llava_next_mistral_7b,
              hymba_1_5b, seamless_m4t_large_v2)
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every (arch, shape) pair with its applicability verdict."""
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            ok, reason = shape_applicable(cfg, shape)
            yield cfg, shape, ok, reason
