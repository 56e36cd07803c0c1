"""Model facade: one API over the architecture families the port runs.

Port of ``repro/models/model.py``: parameter construction, prefill/decode
and caches for the server (the full forward is ``transformer.forward``;
the LM trainer's loss comes with LM training, ROADMAP A.13).  The dense
and SSM families are ported; building a model of another family raises
``NotImplementedError`` (ROADMAP A.13).  A ``Model`` lives on one device:
``device=None`` means CUDA and raises without a CUDA device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import init_params


class Model:
    def __init__(self, cfg: ArchConfig,
                 device: str | torch.device | None = None):
        transformer.check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def param_defs(self):
        return transformer.param_defs(self.cfg)

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Parameters drawn from ``generator``, on the model's device."""
        return init_params(self.param_defs(), generator, dtype, self.device)

    def prefill(self, params, batch: dict, max_len: int | None = None):
        return transformer.prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, token, cache):
        return transformer.decode_step(self.cfg, params, token, cache)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      self.device)


def build_model(cfg: ArchConfig,
                device: str | torch.device | None = None) -> Model:
    return Model(cfg, device)
