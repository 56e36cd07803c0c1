"""Model facade: one API over the architecture families the port runs.

Port of ``repro/models/model.py``: parameter construction, the training
loss (``loss_and_metrics``), prefill/decode and caches for the server,
dispatched by family: ``models/encdec.py`` for the encoder-decoder
(seamless-m4t; its batches carry ``frames``), ``models/transformer.py``
for the decoder-only families (dense, MoE, SSM, hybrid, VLM).  A ``Model``
lives on one device: ``device=None`` means CUDA and raises without a CUDA
device.

``LM`` is the trainable form of the same model, an ``nn.Module`` for
``train/trainer.py``: one parameter per leaf of every layer (not one
stacked (L, ...) tensor per leaf, whose per-layer selects would each give
back a whole (L, ...) zero gradient), with ``state_dict`` keys that name
the reference tree's paths (``embed``, ``layers.3.attn.wq``, ...;
``enc_layers.3.attn.wq``, ``dec_layers.0.xattn.wo`` for the encdec).
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.common import init_params

#: The encoder's input width: the stub audio frontend's (w2v-BERT-style)
#: frame embeddings.
ENC_FRAME_DIM = 1024
#: The encoder-decoder's decoder length: S_dec = seq_len // DEC_FRACTION
#: (and a serving cache's encoder length max_len // DEC_FRACTION).
DEC_FRACTION = 4


def family_module(cfg: ArchConfig):
    """The module that builds and runs ``cfg``'s family."""
    return encdec if cfg.family == "encdec" else transformer


def loss_and_metrics(cfg: ArchConfig, params: dict, batch: dict):
    """Returns (scalar loss, (per-sample loss, PA, PC)): the mean of the
    per-sequence losses, weighted by ``batch["weight"]`` when the batch
    carries one, plus ``router_aux_weight`` times the summed aux term for
    an MoE.  The VLM's patch positions (logits longer than the labels) are
    dropped before the metrics."""
    mod = family_module(cfg)
    logits, mask, aux = mod.forward(cfg, params, batch)
    labels = batch["labels"]
    if cfg.family == "vlm" and logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
        mask = mask[:, -labels.shape[1]:]
    loss, pa, pc = mod.per_sample_metrics(cfg, logits, labels, mask)
    w = batch.get("weight")
    scalar = (loss * w).mean() if w is not None else loss.mean()
    if cfg.moe is not None:
        scalar = scalar + cfg.moe.router_aux_weight * aux
    return scalar, (loss, pa, pc)


class Model:
    def __init__(self, cfg: ArchConfig,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._mod = family_module(cfg)

    def param_defs(self):
        return self._mod.param_defs(self.cfg)

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Parameters drawn from ``generator``, on the model's device."""
        return init_params(self.param_defs(), generator, dtype, self.device)

    def loss_and_metrics(self, params, batch: dict):
        return loss_and_metrics(self.cfg, params, batch)

    def prefill(self, params, batch: dict, max_len: int | None = None):
        return self._mod.prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, token, cache):
        return self._mod.decode_step(self.cfg, params, token, cache)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   ring: bool = False):
        """Zero caches; the encdec's encoder length is ``max_len //
        DEC_FRACTION``, as the reference sizes it."""
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, batch, max_len,
                                     max_len // DEC_FRACTION, dtype,
                                     self.device)
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      self.device, ring=ring)


def build_model(cfg: ArchConfig,
                device: str | torch.device | None = None) -> Model:
    return Model(cfg, device)


class _Tree(nn.Module):
    """A nested dict of tensors as parameters (leaves) and submodules (dicts;
    lists as ``ModuleList``s), ``tree()`` the same dict of the parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(_Tree(t) for t in v))
            else:
                self.register_parameter(k, nn.Parameter(v.detach()))

    def tree(self) -> dict:
        out: dict[str, Any] = dict(self.named_parameters(recurse=False))
        for k, m in self.named_children():
            out[k] = ([t.tree() for t in m] if isinstance(m, nn.ModuleList)
                      else m.tree())
        return out


class LM(_Tree):
    """The LM as an ``nn.Module`` over ``params`` (a stacked tree from
    ``Model.init`` or a per-layer one from ``transformer.params_from_jax(...,
    unstack=True)``; stacked leaves are copied per layer, per-layer ones
    taken as they are; the encdec's two stacks alike).  ``forward`` and
    ``loss_and_metrics`` take a batch (``tokens``, ``labels``, ``mask``,
    optionally ``weight``; the encdec's ``frames``); ``params()`` is the
    tree that ``Model.prefill``/``decode_step`` serve from."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__(transformer.unstack_layers(params))
        self.cfg = cfg

    @classmethod
    def init(cls, cfg: ArchConfig, generator: torch.Generator,
             device: str | torch.device | None = None,
             dtype=torch.float32) -> "LM":
        """``Model(cfg, device).init(generator)``'s draws as an ``LM``."""
        return cls(cfg, Model(cfg, device).init(generator, dtype))

    def params(self) -> dict:
        return self.tree()

    def forward(self, batch: dict):
        """(logits, loss mask, moe aux), as the family's ``forward``."""
        return family_module(self.cfg).forward(self.cfg, self.params(), batch)

    def loss_and_metrics(self, batch: dict):
        return loss_and_metrics(self.cfg, self.params(), batch)
