"""``--arch <id>`` registry over the architectures the port runs.

The JAX package's registry holds ten architectures; the port has the dense
family's smollm-135m and the SSM family's mamba2-130m so far.  The others
come with the rest of the model zoo (ROADMAP A.6) and raise a ``KeyError``
until then.
"""
from repro_torch.configs import mamba2_130m, smollm_135m
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                for m in (smollm_135m, mamba2_130m)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP A.6: the "
                       f"model zoo); the port runs {sorted(ARCHS)}")
    return ARCHS[name]
