"""``--arch <id>`` registry over the architectures the port runs.

The JAX package's registry holds ten architectures; the port has its nine
decoder-only ones (the dense, MoE, SSM, hybrid and VLM families).  The
encoder-decoder seamless-m4t-large-v2 waits for ``models/encdec.py``
(ROADMAP A.6(d)) and raises a ``KeyError`` until then.
"""
from repro_torch.configs import (
    hymba_1_5b, internlm2_20b, kimi_k2_1t, llava_next_mistral_7b,
    mamba2_130m, mistral_large_123b, phi35_moe_42b, qwen3_1_7b, smollm_135m,
)
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_1_7b, smollm_135m, internlm2_20b, mistral_large_123b,
              phi35_moe_42b, kimi_k2_1t, mamba2_130m, llava_next_mistral_7b,
              hymba_1_5b)
}

#: Registered in the JAX package, not ported yet, and where each waits.
NOT_PORTED = {"seamless-m4t-large-v2": "ROADMAP A.6(d), models/encdec.py"}


def get_arch(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet ({NOT_PORTED[name]}); "
                       f"the port runs {sorted(ARCHS)}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
