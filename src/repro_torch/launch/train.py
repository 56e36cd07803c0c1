"""The pod-scale train step and its sharding arithmetic.

Port of ``repro/launch/train.py``: what a launcher needs to train a model
over a ``("data", "model")`` mesh (``launch/mesh.py``), and the plan
helpers that feed it a KAKURENBO epoch.

- ``build_ctx`` resolves the ``ParallelCtx`` for a config on a mesh: FSDP
  (ZeRO-3) when the bf16 parameters a model rank holds pass
  ``FSDP_THRESHOLD_BYTES``, or under ``dp_only``; layers recomputed in the
  backward (``remat``) by default.
- ``make_train_step(model, opt)`` gives ``train_step(params, batch, lr)``
  over this rank's shards (``Model.shard``) and the global batch: the
  forward and backward (``Model.loss_and_metrics``), every parameter a
  gradient (zeros where the loss does not reach it, as the reference's
  ``jax.grad`` of the whole tree gives), the gradients of the leaves not
  sharded over the data axes summed over them (one all-reduce of their
  concatenation; FSDP's gathers sum the sharded ones in the backward), and
  the optimizer's step in place.  Off-mesh the same step runs on one
  device.  Adafactor reduces its moments and RMS over the mesh axes of
  each leaf's spec (``Adafactor.shard_over``, given ``Model.leaf_specs``).
- ``opt_state_specs``, ``abstract_train_state`` (meta tensors) and
  ``optimizer_for`` are the reference's state layout for sgd, adamw,
  rmsprop and adafactor: ``optimizer_for`` hands Adafactor the layer
  stacks of a tree (``stack_groups``), so the live state has the shapes
  ``abstract_train_state`` gives.
- ``plan_worker_indices``, ``plan_lr``, ``plan_summary`` and
  ``plan_global_batches`` read an ``EpochPlan``: every worker slices the
  same plan (strategies are seeded), the union of the slices, batch by
  batch, is the single-host order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs.base import ArchConfig
from repro_torch.core.strategy import EpochPlan
from repro_torch.data.pipeline import worker_slice
from repro_torch.dist.sharding import ParallelCtx, entry_axes, map_specs
from repro_torch.models.transformer import LAYER_STACKS
from repro_torch.optim.optimizers import make_optimizer

FSDP_THRESHOLD_BYTES = 1 << 30  # shard params over data axes above 1 GB/chip


def build_ctx(cfg: ArchConfig, mesh, *, fsdp: bool | None = None,
              seq_parallel_kv: bool = False, remat: bool = True,
              dp_only: bool = False, remat_policy: str = "nothing",
              moe_fsdp_mode: str = "gather") -> ParallelCtx:
    ctx = ParallelCtx(mesh=mesh, fsdp=False, seq_parallel_kv=seq_parallel_kv,
                      remat=remat, dp_only=dp_only, remat_policy=remat_policy,
                      moe_fsdp_mode=moe_fsdp_mode)
    if fsdp is None and mesh is not None:
        per_chip = cfg.param_count() * 2 / max(ctx.tp_size, 1)
        fsdp = per_chip > FSDP_THRESHOLD_BYTES or dp_only
    return dataclasses.replace(ctx, fsdp=bool(fsdp))


def _leaves(tree: Any) -> list:
    """The leaves of a parameter tree (per-layer lists allowed) in
    ``flatten``'s order."""
    return [t for _, t in flatten(tree)]


def make_train_step(model, opt):
    """``train_step(params, batch, lr) -> (loss, (per-sample loss, PA,
    PC))``: one update of ``params`` (this rank's shards, the tensors
    ``opt`` was built on) from the global ``batch``, in place.  The loss
    and metrics returned are the global batch's, detached."""
    ctx = model.ctx

    def data_sharded(spec) -> bool:
        dp = set(ctx.dp_axes)
        return any(entry_axes(e) and set(entry_axes(e)) <= dp for e in spec)

    def train_step(params, batch: dict, lr):
        leaves = _leaves(params)
        specs = model.leaf_specs(params) if model.sharded else None
        if specs is not None:
            opt.shard_over(ctx, specs)
        scalar, (lv, pa, pc) = model.loss_and_metrics(params, batch)
        opt.zero_grad()
        scalar.backward()
        opt.fill_missing_grads()
        if specs is not None and ctx.dp_size > 1:
            rep = [p.grad for p, sp in zip(leaves, specs)
                   if not data_sharded(sp)]
            if rep:
                flat = torch.cat([g.reshape(-1) for g in rep])
                ctx.all_reduce(flat)
                off = 0
                for g in rep:
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
        opt.step(lr)
        return scalar.detach(), (lv.detach(), pa, pc.detach())

    return train_step


# ---------------------------------------------------------------------------
# EpochPlan consumption (strategy protocol -> pod-scale step feeding)
# ---------------------------------------------------------------------------


def plan_worker_indices(plan: EpochPlan, world_size: int, rank: int,
                        batch_per_worker: int) -> np.ndarray:
    """One data-parallel worker's view of a plan's visible set: the union
    of the per-rank slices, batch by batch, is the single-host order."""
    return worker_slice(plan.visible_indices, world_size, rank,
                        batch_per_worker)


def plan_lr(base_lr: float, plan: EpochPlan) -> float:
    """Fold the plan's Eq. 8 factor into the step LR."""
    return float(base_lr) * float(plan.lr_scale)


def plan_summary(plan: EpochPlan) -> dict:
    """One JSON-able record per epoch plan: its shape and the device->host
    syncs producing it cost."""
    return {
        "epoch": int(plan.epoch),
        "visible": int(len(plan.visible_indices)),
        "hidden": int(len(plan.hidden_indices)),
        "moveback": int(len(plan.moveback_indices)),
        "max_fraction": float(plan.max_fraction),
        "hidden_fraction": float(plan.hidden_fraction),
        "lr_scale": float(plan.lr_scale),
        "needs_refresh": bool(plan.needs_refresh),
        "host_syncs": int(plan.host_syncs),
    }


def plan_global_batches(plan: EpochPlan, world_size: int,
                        batch_per_worker: int) -> Iterator[np.ndarray]:
    """Global-batch index arrays of ``world_size * batch_per_worker`` ids:
    reshaped to (world_size, batch_per_worker) they are each rank's
    sub-batch (``worker_slice``'s column r), so global batch s is the s-th
    consecutive chunk of the visible set."""
    gb = world_size * batch_per_worker
    v = plan.visible_indices
    for start in range(0, (len(v) // gb) * gb, gb):
        yield v[start:start + gb]


# ---------------------------------------------------------------------------
# Optimizer state layout
# ---------------------------------------------------------------------------


def _pad_spec(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def opt_state_specs(opt_name: str, param_specs: Any, params_abs: Any,
                    momentum: bool = True) -> Any:
    """The spec tree of the optimizer state (sharded as its parameters)."""
    if opt_name == "sgd":
        return param_specs if momentum else ()
    if opt_name == "adamw":
        return {"m": param_specs, "v": param_specs, "t": ()}
    if opt_name == "rmsprop":
        return {"v": param_specs, "m": param_specs}
    if opt_name == "adafactor":
        def one(spec, ab):
            s = _pad_spec(spec, ab.dim())
            if ab.dim() >= 2:
                return {"r": s[:-1], "c": s[:-2] + (s[-1],)}
            return {"v": s}
        return {"s": map_specs(one, param_specs, params_abs), "t": ()}
    raise ValueError(opt_name)


def _opt_abstract(opt_name: str, params_abs: Any, momentum: bool) -> Any:
    """The optimizer state's tree as meta tensors (the reference's
    ``jax.eval_shape(opt.init, params)`` layout; AdamW's moments in
    float32, as ``optimizer_for`` makes them)."""
    def like(dtype=None):
        return map_specs(lambda p: torch.empty(
            p.shape, dtype=dtype or p.dtype, device="meta"), params_abs)
    step = torch.empty((), dtype=torch.int32, device="meta")
    if opt_name == "sgd":
        return like() if momentum else ()
    if opt_name == "adamw":
        return {"m": like(torch.float32), "v": like(torch.float32), "t": step}
    if opt_name == "rmsprop":
        return {"v": like(), "m": like()}
    if opt_name == "adafactor":
        def one(p):
            f32 = dict(dtype=torch.float32, device="meta")
            if p.dim() >= 2:
                return {"r": torch.empty(p.shape[:-1], **f32),
                        "c": torch.empty(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.empty(p.shape, **f32)}
        return {"s": map_specs(one, params_abs), "t": step}
    raise ValueError(opt_name)


def abstract_train_state(model, opt_name: str, dtype=torch.bfloat16,
                         momentum: bool | None = None):
    """(params_abs, opt_abs, param_specs, opt_specs), all abstract: meta
    tensors and specs of the global trees.  ``momentum`` (SGD's state or
    none) defaults to the reference's default SGD: none."""
    if momentum is None:
        momentum = opt_name != "sgd"
    params_abs = model.abstract_params(dtype)
    param_specs = model.param_specs(dtype)
    opt_abs = _opt_abstract(opt_name, params_abs, momentum)
    opt_specs = opt_state_specs(opt_name, param_specs, params_abs, momentum)
    return params_abs, opt_abs, param_specs, opt_specs


def stack_groups(params: dict) -> list[list[int]]:
    """The positions, among ``params``' leaves in ``flatten``'s order, of
    each stacked leaf of the reference's tree: the L per-layer tensors of
    one leaf of a layer stack (``transformer.LAYER_STACKS``, as per-layer
    lists)."""
    groups: dict[tuple[str, str], list[int]] = {}
    for pos, (path, _) in enumerate(flatten(params)):
        parts = path.split("/")
        if len(parts) > 2 and parts[1] in LAYER_STACKS and parts[2].isdigit():
            key = (parts[1], "/".join(parts[3:]))
            groups.setdefault(key, []).append(pos)
    return list(groups.values())


def optimizer_for(cfg: ArchConfig, params):
    """The config's optimizer over ``params`` (AdamW with float32 moments,
    Adafactor for the 1T config).  ``params`` is a tree (per-layer lists,
    ``Model.shard``'s) or a list of tensors; a tree's layer stacks are
    Adafactor's stacked leaves (``stack_groups``), a list's tensors leaves
    of their own."""
    leaves = _leaves(params) if isinstance(params, dict) else list(params)
    if cfg.optimizer == "adamw":
        return make_optimizer("adamw", leaves, state_dtype=torch.float32)
    if cfg.optimizer == "adafactor" and isinstance(params, dict):
        return make_optimizer("adafactor", leaves,
                              stacks=stack_groups(params))
    return make_optimizer(cfg.optimizer, leaves)
