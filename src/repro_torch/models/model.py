"""Model facade: one API over the architecture families the port runs.

Port of ``repro/models/model.py``: parameter construction, the training
loss (``loss_and_metrics``), prefill/decode and caches for the server,
dispatched by family: ``models/encdec.py`` for the encoder-decoder
(seamless-m4t; its batches carry ``frames``), ``models/transformer.py``
for the decoder-only families (dense, MoE, SSM, hybrid, VLM), plus the
launcher's abstract views: ``param_specs`` (the reference's sharding
specs, through each ``ParamDef``'s logical axes), ``abstract_params``
(meta tensors), ``input_specs``/``input_logical``/``input_shardings``.
``device=None`` means CUDA and raises without a CUDA device.

With a ``ParallelCtx`` over a ``("data", "model")`` mesh (``ctx``), a
``Model`` trains and serves on each rank's shards: ``shard`` (or
``transformer.params_from_jax(..., shard=model)``) gives a rank its block
of every leaf by its spec, as per-layer lists; ``loss_and_metrics`` takes
the global batch, runs this rank's data rows through the family's
``forward``, and returns the global loss (each data rank's share summed:
a masked mean over the global batch) and the global per-sample metrics;
``prefill`` and ``decode_step`` take the global batch (or token) too,
return the global logits and keep this rank's block of the cache (the
reference's decode layout, ``input_logical``); a batch that does not
divide the data ranks is taken whole by each of them, as the reference's
spec guard replicates it (``ParallelCtx.splits_batch``); ``gather`` and
``gather_cache`` give the global tree and the one-device cache back.
Every family runs on the model axis: expert parallelism for the MoE in
both FSDP layouts, and the sequence-parallel decode under
``seq_parallel_kv``, under either recompute policy (``remat_policy``
``"nothing"`` or ``"dots"``, ``common.remat``).

``LM`` is the trainable form of the same model, an ``nn.Module`` for
``train/trainer.py``: one parameter per leaf of every layer (not one
stacked (L, ...) tensor per leaf, whose per-layer selects would each give
back a whole (L, ...) zero gradient), with ``state_dict`` keys that name
the reference tree's paths (``embed``, ``layers.3.attn.wq``, ...;
``enc_layers.3.attn.wq``, ``dec_layers.0.xattn.wo`` for the encdec).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist.sharding import (ParallelCtx, entry_axes, gather_dim,
                                       map_specs, spec_tree_for)
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.common import abstract_params, init_params, logical_tree
from repro_torch.models.transformer import LAYER_STACKS, VLM_PATCH_DIM

#: The encoder's input width: the stub audio frontend's (w2v-BERT-style)
#: frame embeddings.
ENC_FRAME_DIM = 1024
#: The encoder-decoder's decoder length: S_dec = seq_len // DEC_FRACTION
#: (and a serving cache's encoder length max_len // DEC_FRACTION).
DEC_FRACTION = 4
#: The stub vision frontend's patches a sample (24 x 24, anyres base).
VLM_NUM_PATCHES = 576


def family_module(cfg: ArchConfig):
    """The module that builds and runs ``cfg``'s family."""
    return encdec if cfg.family == "encdec" else transformer


def loss_and_metrics(cfg: ArchConfig, params: dict, batch: dict,
                     ctx: ParallelCtx | None = None,
                     specs: dict | None = None):
    """Returns (scalar loss, (per-sample loss, PA, PC)): the mean of the
    per-sequence losses, weighted by ``batch["weight"]`` when the batch
    carries one, plus ``router_aux_weight`` times the summed aux term for
    an MoE.  The VLM's patch positions (logits longer than the labels) are
    dropped before the metrics.

    On a mesh (``ctx`` and ``specs``, the shards' per-layer specs)
    ``params`` are this rank's shards and ``batch`` the global batch: the
    data rank's rows run through the model, the scalar is the global loss
    (each rank's mean times its share of the batch, summed over the data
    ranks; an MoE's aux term averaged over them), the per-sample metrics
    are gathered in batch order.  The gradient of the scalar on a rank is
    its share's; ``launch/train.py`` sums the replicated leaves' over the
    data ranks, FSDP's gathers sum the sharded ones'.  A batch that does
    not divide the data ranks is not split (``ParallelCtx.splits_batch``):
    every data rank runs it whole, the scalar and metrics are one
    device's, and ``dp_share`` divides the scalar's gradient by the data
    ranks, so the sums are one device's gradient."""
    local, n = batch, batch["labels"].shape[0]
    split = specs is not None and ctx.splits_batch(n)
    if split:
        local = {k: ctx.shard_rows(v) for k, v in batch.items()}
    logits, mask, aux = family_module(cfg).forward(cfg, params, local, ctx,
                                                   specs)
    scalar, (loss, pa, pc) = _mean_and_metrics(cfg, logits, mask, local)
    if not split:
        if cfg.moe is not None:
            scalar = scalar + cfg.moe.router_aux_weight * aux
        # One device, or a batch every data rank took whole.
        return (scalar if specs is None else ctx.dp_share(scalar),
                (loss, pa, pc))
    scalar = scalar * (loss.shape[0] / n)
    if cfg.moe is not None:
        scalar = scalar + cfg.moe.router_aux_weight * aux / ctx.dp_size
    scalar = ctx.dp_sum(scalar)
    if ctx.dp_size > 1:
        got = ctx.gather_rows(torch.stack(
            [loss.detach(), pa.to(torch.float32), pc.detach()], dim=1))
        loss, pa, pc = got[:, 0], got[:, 1] != 0, got[:, 2]
    return scalar, (loss, pa, pc)


def _mean_and_metrics(cfg: ArchConfig, logits, mask, batch: dict):
    """The (weighted) mean of the per-sequence losses and the per-sample
    (loss, PA, PC), the VLM's patch positions dropped."""
    labels = batch["labels"]
    if cfg.family == "vlm" and logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]
        mask = mask[:, -labels.shape[1]:]
    loss, pa, pc = family_module(cfg).per_sample_metrics(cfg, logits, labels,
                                                         mask)
    w = batch.get("weight")
    scalar = (loss * w).mean() if w is not None else loss.mean()
    return scalar, (loss, pa, pc)


def per_layer_specs(specs: dict) -> dict:
    """``specs`` with each layer stack's spec as one layer's (the leading
    layer dim's entry dropped): the specs of the per-layer lists."""
    return {k: (map_specs(lambda sp: sp[1:], v) if k in LAYER_STACKS else v)
            for k, v in specs.items()}


class Model:
    def __init__(self, cfg: ArchConfig, ctx: ParallelCtx | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.ctx = ctx or ParallelCtx()
        self.device = resolve_device(device)
        self._mod = family_module(cfg)
        self._local_specs = None
        #: The global batch of the last ``prefill`` or ``init_cache`` on a
        #: mesh: whether ``gather_cache`` gathers rows.
        self.batch: int | None = None

    @property
    def sharded(self) -> bool:
        """Whether the model runs on a mesh's shards."""
        return self.ctx.mesh is not None

    # -- params -----------------------------------------------------------

    def param_defs(self):
        if self.cfg.family == "encdec":
            return self._mod.param_defs(self.cfg)
        return self._mod.param_defs(self.cfg, self.ctx.moe_fsdp_mode)

    def abstract_params(self, dtype=torch.bfloat16):
        """The global parameter tree as meta tensors."""
        return abstract_params(self.param_defs(), dtype)

    def param_specs(self, dtype=torch.bfloat16):
        """Each leaf's spec on the context's mesh (the reference's
        ``Model.param_specs``): logical axes resolved, a dim that does not
        divide replicated."""
        defs = self.param_defs()
        return spec_tree_for(logical_tree(defs), self.ctx,
                             abstract_params(defs, dtype))

    def local_specs(self) -> dict:
        """The specs of ``shard``'s per-layer tree."""
        if self._local_specs is None:
            self._local_specs = per_layer_specs(self.param_specs())
        return self._local_specs

    def leaf_specs(self, params: dict) -> list[tuple]:
        """The spec of each leaf of ``shard``'s tree ``params``, in
        ``checkpoint.flatten``'s order of its leaves."""
        class _Spec:
            def __init__(self, spec):
                self.spec = spec
        held = map_specs(lambda t, sp: _Spec(sp), params, self.local_specs())
        return [h.spec for _, h in flatten(held)]

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Parameters drawn from ``generator``, on the model's device (the
        global tree: ``shard`` gives a rank its blocks)."""
        return init_params(self.param_defs(), generator, dtype, self.device)

    def shard(self, params: dict) -> dict:
        """This rank's block of every leaf of a global tree (tensors or
        numpy arrays, layer stacks stacked or per-layer), as per-layer
        lists of tensors on the model's device, each with its own
        storage.  Off-mesh: the whole tree, per-layer."""
        def one(x, spec):
            loc = self.ctx.local_shard(x, spec)
            if isinstance(loc, torch.Tensor):
                return loc.to(self.device, copy=True)
            return torch.from_numpy(np.array(loc, dtype=np.float32)).to(
                self.device)
        return map_specs(one, transformer.unstack_layers(params, copy=False),
                         self.local_specs())

    @torch.no_grad()
    def gather(self, local: dict) -> dict:
        """The global tree (per-layer lists) from every rank's ``shard``s
        (or their gradients): each leaf all-gathered over the axes of its
        spec."""
        ctx = self.ctx

        def one(x, spec):
            for dim, entry in enumerate(spec):
                axes = entry_axes(entry)
                size = 1
                for a in axes:
                    size *= ctx.axis_size(a)
                if size > 1:
                    x = gather_dim(x, dim, ctx.group_for(axes), size)
            return x
        return map_specs(one, local, self.local_specs())

    # -- training ---------------------------------------------------------

    def loss_and_metrics(self, params, batch: dict):
        """Returns (scalar loss, (per-sample loss, PA, PC)); on a mesh
        ``params`` are this rank's shards and ``batch`` the global batch."""
        if not self.sharded:
            return loss_and_metrics(self.cfg, params, batch)
        return loss_and_metrics(self.cfg, params, batch, self.ctx,
                                self.local_specs())

    # -- serving ----------------------------------------------------------

    def prefill(self, params, batch: dict, max_len: int | None = None):
        """(last-position logits (B, 1, V), cache).  On a mesh ``params``
        are this rank's shards and ``batch`` the global batch: the logits
        are the global batch's, the cache this rank's block."""
        if not self.sharded:
            return self._mod.prefill(self.cfg, params, batch, max_len)
        ctx = self.ctx
        self.batch = n = next(iter(batch.values())).shape[0]
        local = {k: ctx.shard_batch(v) for k, v in batch.items()}
        logits, cache = self._mod.prefill(self.cfg, params, local, max_len,
                                          ctx, self.local_specs())
        return ctx.gather_batch(logits, n), cache

    def decode_step(self, params, token, cache):
        """(logits (B, 1, V), the cache after the step).  On a mesh
        ``token`` is the global batch's (B, 1), ``cache`` this rank's
        block, and the logits are the global batch's."""
        if not self.sharded:
            return self._mod.decode_step(self.cfg, params, token, cache)
        ctx = self.ctx
        logits, cache = self._mod.decode_step(
            self.cfg, params, ctx.shard_batch(token), cache, ctx,
            self.local_specs())
        return ctx.gather_batch(logits, token.shape[0]), cache

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   ring: bool = False):
        """Zero caches for a global batch of ``batch``; the encdec's
        encoder length is ``max_len // DEC_FRACTION``, as the reference
        sizes it.  On a mesh: this rank's block (its rows; its span of
        the sequence under ``seq_parallel_kv``).  ``len`` is a 0-d int32
        tensor on the model's device, as the reference's."""
        ctx = self.ctx
        if self.sharded:
            self.batch = batch
            start, stop = ctx.batch_rows(batch)
            batch = stop - start
        shards = transformer.seq_shards(ctx)
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, batch, max_len,
                                     max_len // DEC_FRACTION, dtype,
                                     self.device, seq_shards=shards)
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      self.device, ring=ring,
                                      seq_shards=shards)

    @torch.no_grad()
    def gather_cache(self, cache: dict) -> dict:
        """The one-device cache from every rank's block: each (L, B, ...)
        entry's rows all-gathered over the data axes where the batch of
        this model's last ``prefill`` or ``init_cache`` split over them (a
        replicated batch's cache is whole on every rank), ``k`` and
        ``v``'s sequence over "model" under ``seq_parallel_kv``; ``len``
        (the same 0-d tensor value on every rank) as it is.  Off-mesh: the
        cache itself."""
        if not self.sharded:
            return cache
        ctx = self.ctx
        split = self.batch is None or ctx.splits_batch(self.batch)
        out = dict(cache)
        for name, x in cache.items():
            if name == "len":
                continue
            if split and ctx.dp_size > 1:
                x = gather_dim(x, 1, ctx.group, ctx.dp_size)
            if name in ("k", "v") and transformer.seq_shards(ctx) > 1:
                x = gather_dim(x, 2, ctx.tp_group, ctx.tp_size)
            out[name] = x
        return out


    # -- abstract inputs for the launcher ----------------------------------

    def input_specs(self, shape: ShapeSpec, dtype=torch.bfloat16) -> dict:
        """Meta-tensor stand-ins for every model input (no allocation)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(shp, dt):
            return torch.empty(shp, dtype=dt, device="meta")

        if shape.kind in ("train", "prefill"):
            if cfg.family == "encdec":
                batch = {"frames": meta((b, s, ENC_FRAME_DIM), dtype),
                         "tokens": meta((b, s // DEC_FRACTION), torch.int32)}
            elif cfg.family == "vlm":
                batch = {"patch_embeds": meta((b, VLM_NUM_PATCHES,
                                               VLM_PATCH_DIM), dtype),
                         "tokens": meta((b, s), torch.int32)}
            else:
                batch = {"tokens": meta((b, s), torch.int32)}
            if shape.kind == "train":
                lab = tuple(batch["tokens"].shape)
                batch["labels"] = meta(lab, torch.int32)
                batch["mask"] = meta(lab, torch.bool)
            return batch
        # decode: one new token against a cache of length s
        ring = (cfg.attn_window is not None and s > cfg.attn_window
                and cfg.sub_quadratic)
        if cfg.family == "encdec":
            cache = encdec.init_cache(cfg, b, s, s // DEC_FRACTION, dtype,
                                      "meta")
        else:
            cache = transformer.init_cache(cfg, b, s, dtype, "meta",
                                           ring=ring)
        cache["len"] = meta((), torch.int32)
        return {"token": meta((b, 1), torch.int32), "cache": cache}

    def input_logical(self, shape: ShapeSpec) -> dict:
        """Logical sharding axes matching ``input_specs``' structure."""
        cfg = self.cfg
        if shape.kind in ("train", "prefill"):
            out: dict[str, Any] = {"tokens": ("batch", None)}
            if cfg.family == "encdec":
                out["frames"] = ("batch", None, None)
            if cfg.family == "vlm":
                out["patch_embeds"] = ("batch", None, None)
            if shape.kind == "train":
                out["labels"] = ("batch", None)
                out["mask"] = ("batch", None)
            return out
        seq_ax = "seq_tp" if self.ctx.seq_parallel_kv else None
        cache: dict[str, Any] = {"len": ()}
        if cfg.family != "ssm" and cfg.num_heads:
            cache["k"] = (None, "batch", seq_ax, None, None)
            cache["v"] = (None, "batch", seq_ax, None, None)
        if cfg.family == "encdec":
            cache["xk"] = (None, "batch", None, None, None)
            cache["xv"] = (None, "batch", None, None, None)
        if cfg.family in ("ssm", "hybrid"):
            cache["ssm_state"] = (None, "batch", None, None, None)
            cache["conv_buf"] = (None, "batch", None, None)
        return {"token": ("batch", None), "cache": cache}

    def input_shardings(self, shape: ShapeSpec, dtype=torch.bfloat16):
        """``input_logical`` resolved against the inputs' shapes."""
        return map_specs(lambda lg, t: self.ctx.spec(*lg, dims=tuple(t.shape)),
                         self.input_logical(shape),
                         self.input_specs(shape, dtype))


def build_model(cfg: ArchConfig, ctx: ParallelCtx | None = None,
                device: str | torch.device | None = None) -> Model:
    return Model(cfg, ctx, device)


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
        """``Model(cfg, device=device).init(generator)``'s draws as an ``LM``."""
        return cls(cfg, Model(cfg, device=device).init(generator, dtype))

    def params(self) -> dict:
        return self.tree()

    def forward(self, batch: dict):
        """(logits, loss mask, moe aux), as the family's ``forward``."""
        return family_module(self.cfg).forward(self.cfg, self.params(), batch)

    def loss_and_metrics(self, batch: dict):
        return loss_and_metrics(self.cfg, self.params(), batch)
