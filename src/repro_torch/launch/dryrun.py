"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on meta
tensors over torch's fake process group.

Port of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each cell for the production mesh, the port runs rank 0's step
itself, on meta tensors (shapes and dtypes, no storage, no arithmetic), in
one process joined to a fake group of 256 or 512 ranks (``backend="fake"``
with ``FakeStore``; its collectives return at once).  For each cell this
shows, without hardware:

  * the sharding is coherent: rank 0 builds its shards (``Model.shard``)
    and runs ``launch/train.py::make_train_step`` (``train``) or
    ``Model.prefill`` / ``Model.decode_step`` (``prefill``, ``decode``)
    with every collective of the model axis and FSDP;
  * what the step holds (``memory``), and the operations, bytes and
    collective volume of the roofline.

The record keeps the reference's keys, so one reader takes both:

  ``hlo_flops``     rank 0's operations x chips: ``torch.utils.flop_counter``
                    over the aten ops (matmuls), plus each kernel's
                    operations by formula (``kernels/backend.py``'s
                    ``META_WORK``: B7 and B6 as ``chip_smoke.py`` counts them
                    for their bounds, their plain backward three times the
                    forward, B1 forward and backward 5 an element);
  ``hlo_bytes``     ``roofline_model.analytic_hbm_bytes(...)["total"]``;
  ``collective_bytes``, ``collective_bytes_total``
                    ``hlo_analysis.collective_bytes`` of the collectives
                    rank 0 issued (wire bytes a participant);
  ``memory``        ``argument_size_in_bytes`` (rank 0's parameters, its
                    optimizer state with the LR, and its block of the
                    inputs), ``output_size_in_bytes`` (the tensors the step
                    returns) and ``temp_size_in_bytes`` (the step's peak of
                    live bytes it allocated beyond the arguments, traced op
                    by op).  XLA's ``alias_size_in_bytes`` and
                    ``generated_code_size_in_bytes`` have no counterpart: the
                    step updates in place and compiles no program;
  ``model_flops``, ``useful_flops_ratio``, ``roofline`` (H100 constants),
  ``total_s``, ``status``, ``fsdp``.

The FSDP backward's scatter is a reduce-scatter under the fake group, as
under NCCL (``dist/sharding.py``): the dry run models the NCCL deployment.
Inside the step ``kernels/backend.py::crediting`` is on: a kernel wrapper
given meta tensors returns empty outputs and credits its work, so no
plain attention's (S, S) scores are made.
The reference's ``--rolled`` (a rolled layer scan) has no counterpart: the
port's layer loop is Python, and every layer is run and counted.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--extrapolate]

One JSON per cell under ``--out`` (default ``results/torch_dryrun``);
existing files are skipped.  Nothing runs at import.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeSpec,
                                      shape_applicable, tokens_per_step)
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.dist.sharding import map_specs
from repro_torch.kernels import backend
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_data_model_mesh, make_production_mesh
from repro_torch.launch.roofline_model import analytic_hbm_bytes
from repro_torch.launch.train import build_ctx, make_train_step, optimizer_for
from repro_torch.models.model import Model

#: The LR of the dry run's train step (it moves nothing: meta tensors).
_LR = 1e-3


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages the ops inside the block allocate, live and
    at their peak: each new storage counted once, until it is freed.  An
    output on the storage of one of its op's inputs (a view, an in-place
    op) allocated nothing."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: dict[int, weakref.finalize] = {}

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._held.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {id(a.untyped_storage()) for a in tree_leaves((args, kwargs))
                  if isinstance(a, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = id(st)
                if key not in self._held and key not in inputs:
                    n = st.nbytes()
                    self._held[key] = weakref.finalize(st, self._free, key, n)
                    self.live += n
                    self.peak = max(self.peak, self.live)
        return out


def join_fake_group(world: int) -> None:
    """Join torch's fake process group of ``world`` ranks as rank 0 (a
    group already joined of another backend or size is left first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (str(dist.get_backend()) == "fake"
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(multi_pod: bool, mesh_shape: tuple[int, int] | None):
    """The cell's mesh over a fake group of its size: the production mesh,
    or a ``(data, model)`` mesh of ``mesh_shape``."""
    if mesh_shape is None:
        join_fake_group(512 if multi_pod else 256)
        return make_production_mesh(multi_pod=multi_pod)
    join_fake_group(math.prod(mesh_shape))
    return make_data_model_mesh(*mesh_shape)


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _local_inputs_bytes(model: Model, shape: ShapeSpec, dtype) -> int:
    """Bytes of rank 0's block of the cell's inputs, by their specs."""
    ctx = model.ctx
    sizes = map_specs(lambda t, sp: math.prod(ctx.local_shape(
        sp, tuple(t.shape))) * t.element_size(),
        model.input_specs(shape, dtype), model.input_shardings(shape, dtype))
    return sum(n for _, n in flatten(sizes))


def _step(model: Model, cfg: ArchConfig, shape: ShapeSpec, dtype):
    """(the step as a thunk, the tensors of its arguments beside the
    inputs): rank 0's shards and its optimizer (train)."""
    local = model.shard(model.abstract_params(dtype))
    inputs = model.input_specs(shape, dtype)
    leaves = [t for _, t in flatten(local)]
    if shape.kind == "train":
        for t in leaves:
            t.requires_grad_(True)
        opt = optimizer_for(cfg, local)
        step = make_train_step(model, opt)
        args = leaves + opt.state_tensors() + [opt.lr]
        return (lambda: step(local, inputs, _LR)), args
    if shape.kind == "prefill":
        return (lambda: model.prefill(local, inputs)), leaves
    ring = (cfg.attn_window is not None and shape.seq_len > cfg.attn_window
            and cfg.sub_quadratic)
    cache = model.init_cache(shape.global_batch, shape.seq_len, dtype,
                             ring=ring)
    cache["len"] = torch.full((), shape.seq_len - 1, dtype=torch.int32,
                              device=cache["len"].device)
    # The cache is an input: ``_local_inputs_bytes`` counts its block.
    return (lambda: model.decode_step(local, inputs["token"], cache)), leaves


def _analyze(flops: float, chips: int, coll: dict, memory: dict,
             cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The record's numbers from the step's global operations, its
    collective wire bytes a rank (by kind, with ``count``) and its
    memory."""
    factor = 6 if shape.kind == "train" else 2
    model_flops = factor * cfg.active_param_count() * tokens_per_step(shape)
    hbm = analytic_hbm_bytes(cfg, shape, cfg.optimizer)
    coll_total = sum(v for k, v in coll.items() if k != "count")
    roof = hlo_analysis.Roofline(flops=flops, hbm_bytes=hbm["total"],
                                 coll_bytes=coll_total, chips=chips)
    return {
        "hlo_flops": flops,
        "hlo_bytes": hbm["total"],
        "hbm_terms": hbm,
        "collective_bytes": coll,
        "collective_bytes_total": coll_total,
        "memory": memory,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else None,
        "roofline": roof.as_dict(),
    }


def run_cell(arch: str | ArchConfig, shape: str | ShapeSpec, *,
             multi_pod: bool = False, seq_parallel_kv: bool = False,
             fsdp: bool | None = None, remat: bool = True,
             dtype=torch.bfloat16, dp_only: bool = False,
             remat_policy: str = "nothing", moe_fsdp_mode: str = "gather",
             mesh_shape: tuple[int, int] | None = None) -> dict:
    """One cell's record.  ``arch`` and ``shape`` are registry names or
    configs; ``mesh_shape`` replaces the production mesh by a ``(data,
    model)`` mesh of that shape (a fake group of its size)."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "pod2x16x16" if multi_pod else "pod16x16")
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
           "kind": shape.kind, "seq_parallel_kv": seq_parallel_kv,
           "unrolled": True, "dp_only": dp_only,
           "remat_policy": remat_policy, "moe_fsdp_mode": moe_fsdp_mode}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec
    t0 = time.perf_counter()
    try:
        mesh = _mesh(multi_pod, mesh_shape)
        chips = mesh.size()
        ctx = build_ctx(cfg, mesh, fsdp=fsdp, seq_parallel_kv=seq_parallel_kv,
                        remat=remat, dp_only=dp_only,
                        remat_policy=remat_policy,
                        moe_fsdp_mode=moe_fsdp_mode)
        rec["fsdp"] = ctx.fsdp
        model = Model(cfg, ctx, device="meta")
        run, args = _step(model, cfg, shape, dtype)
        arg_bytes = _nbytes(args) + _local_inputs_bytes(model, shape, dtype)
        backend.META_WORK.clear()
        t1 = time.perf_counter()
        with (backend.crediting(), FlopCounterMode(display=False) as fc,
              LiveBytes() as live,
              hlo_analysis.record_collectives() as record):
            out = run()
            out_bytes = _nbytes(tree_leaves(out))
        rec["run_s"] = time.perf_counter() - t1
        kernels = {f"{name}:{what}": v
                   for (name, what), v in sorted(backend.META_WORK.items())}
        kernel_ops = sum(v for (_, what), v in backend.META_WORK.items()
                         if what == "ops")
        memory = {"argument_size_in_bytes": arg_bytes,
                  "output_size_in_bytes": out_bytes,
                  "temp_size_in_bytes": live.peak}
        rec.update(_analyze((fc.get_total_flops() + kernel_ops) * chips,
                            chips, hlo_analysis.collective_bytes(record),
                            memory, cfg, shape))
        rec["aten_flops"] = fc.get_total_flops() * chips
        rec["kernel_work"] = kernels
        rec["collective_largest_bytes"] = hlo_analysis.largest_bytes(record)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — any failure here is a finding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["total_s"] = time.perf_counter() - t0
    return rec


def _scale_layers(cfg: ArchConfig, n: int) -> ArchConfig:
    """Same-family config with n layers (for per-layer cost extraction)."""
    return dataclasses.replace(
        cfg, num_layers=n,
        num_encoder_layers=n if cfg.num_encoder_layers else 0)


#: The record's numbers that are linear in the layer count.
_LINEAR_MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes")


def run_cell_extrapolated(arch: str | ArchConfig, shape: str | ShapeSpec,
                          **kw) -> dict:
    """Roofline via exact linear extrapolation in layer count.

    Every count of the step is ``outside + L * per_layer`` (operations,
    collective payloads, argument and output bytes): the L = 2 and L = 4
    probes solve for both terms, as the reference's do.  The port's layer
    loop is Python, so a full-depth meta run (``run_cell``) gives the same
    numbers exactly; the probes are quicker for the deep configs.  The
    peak of temporaries is extrapolated too, which holds while one layer's
    work sets it (``temp_size_in_bytes``).  Unless ``fsdp`` is given,
    each probe decides FSDP for its own depth (``build_ctx`` on the
    scaled config), as the reference's do, and the record keeps both
    decisions (``probe_fsdp``): a config over the FSDP threshold whose
    probes are under it extrapolates unsharded parameters, as the
    reference does (``run_cell`` at full depth decides for the config
    itself)."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, reason = shape_applicable(cfg, shape)
    mesh_shape = kw.get("mesh_shape")
    base = {"arch": cfg.name, "shape": shape.name,
            "mesh": ("x".join(map(str, mesh_shape)) if mesh_shape
                     else "pod2x16x16" if kw.get("multi_pod")
                     else "pod16x16"),
            "kind": shape.kind, "method": "extrapolate_L2_L4"}
    if not ok:
        base.update(status="skip", reason=reason)
        return base
    t0 = time.perf_counter()
    recs = {}
    for n in (2, 4):
        recs[n] = run_cell(_scale_layers(cfg, n), shape, **kw)
        if recs[n]["status"] != "ok":
            base.update(status="error",
                        error=f"L={n} probe failed: {recs[n].get('error')}",
                        traceback=recs[n].get("traceback"))
            return base
    L = cfg.num_layers

    def extrap(get):
        m2, m4 = get(recs[2]), get(recs[4])
        per_layer = (m4 - m2) / 2.0
        outside = m2 - 2.0 * per_layer
        return max(outside + L * per_layer, 0.0)

    rec = dict(base, fsdp=recs[4]["fsdp"],
               probe_fsdp=[recs[2]["fsdp"], recs[4]["fsdp"]])
    coll = {k: extrap(lambda r, k=k: float(r["collective_bytes"][k]))
            for k in recs[2]["collective_bytes"]}
    memory = {k: extrap(lambda r, k=k: float(r["memory"][k]))
              for k in _LINEAR_MEMORY}
    rec.update(_analyze(extrap(lambda r: r["hlo_flops"]), _chips(kw), coll,
                        memory, cfg, shape))
    rec["probe_run_s"] = [recs[2].get("run_s"), recs[4].get("run_s")]
    rec["status"] = "ok"
    rec["total_s"] = time.perf_counter() - t0
    return rec


def _chips(kw: dict) -> int:
    mesh_shape = kw.get("mesh_shape")
    if mesh_shape:
        return math.prod(mesh_shape)
    return 512 if kw.get("multi_pod") else 256


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="The dry run on meta tensors over torch's fake process "
                    "group.  The reference's --rolled has no counterpart: "
                    "the layer loop is Python, and every layer is run and "
                    "counted.")
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--seq-parallel-kv", action="store_true")
    p.add_argument("--dp-only", action="store_true",
                   help="map the model axis to data parallelism (ZeRO-3, "
                        "no TP)")
    p.add_argument("--remat-dots", action="store_true",
                   help="remat policy: save matmul outputs (recompute the "
                        "rest)")
    p.add_argument("--moe-partial", action="store_true",
                   help="MoE partial-ff mode (no expert weight gathers)")
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--extrapolate", action="store_true",
                   help="true-L terms from L=2/L=4 probes (exact linear "
                        "extrapolation)")
    p.add_argument("--out", default="results/torch_dryrun")
    p.add_argument("--tag", default="")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    try:
        for mp in meshes:
            for a in archs:
                for s in shapes:
                    _one(args, a, s, mp)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _one(args, a: str, s: str, mp: bool) -> None:
    tag = f"{args.tag}_" if args.tag else ""
    name = f"{tag}{a}_{s}_{'mp' if mp else 'sp'}"
    if args.seq_parallel_kv:
        name += "_spkv"
    if args.dp_only:
        name += "_dponly"
    if args.remat_dots:
        name += "_rematdots"
    if args.moe_partial:
        name += "_moepartial"
    path = os.path.join(args.out, name + ".json")
    if os.path.exists(path):
        print(f"[skip existing] {name}")
        return
    print(f"[run] {name}", flush=True)
    kw = dict(multi_pod=mp, seq_parallel_kv=args.seq_parallel_kv,
              fsdp=False if args.no_fsdp else None, dp_only=args.dp_only,
              remat_policy="dots" if args.remat_dots else "nothing",
              moe_fsdp_mode="partial" if args.moe_partial else "gather")
    rec = (run_cell_extrapolated(a, s, **kw) if args.extrapolate
           else run_cell(a, s, **kw))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" t={r['step_time_s']:.4f}s total={rec['total_s']:.1f}s")
    elif status == "error":
        extra = " " + rec["error"][:200]
    print(f"  -> {status}{extra}", flush=True)


if __name__ == "__main__":
    main()
