"""PyTorch port, the launcher's arithmetic, exact against the JAX package
on the CPU (no devices: the meshes are stand-ins or torch's fake process
group).

- ``ArchConfig.param_count``, ``active_param_count``, ``attn_free``,
  ``sub_quadratic`` and ``shape_applicable`` for all ten registry configs;
- ``tokens_per_step`` and ``analytic_hbm_bytes`` (each optimizer, bf16
  and fp8 weights) for every (arch, shape) pair of ``all_cells()``, and
  ``kernel_hbm_bytes`` for every kernel name: the same numbers;
- ``plan_worker_indices``, ``plan_lr``, ``plan_summary`` and
  ``plan_global_batches`` on the same plans, element for element;
- ``Model.param_specs``, ``input_logical`` and ``input_shardings`` (and
  ``input_specs``' shapes) for all ten configs at (2, 4), (16, 16) and
  (2, 16, 16), FSDP on and off, ``dp_only`` too, against the reference's
  over a stub mesh (a spec entry for entry equal to its ``PartitionSpec``);
- ``build_ctx``'s FSDP rule, ``opt_state_specs`` and
  ``abstract_train_state`` for sgd, adamw, rmsprop and adafactor;
- ``make_production_mesh`` over torch's fake process group (256 and 512
  ranks, one process), its specs the stand-in's; the H100's roofline
  constants, and no TPU one.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import all_cells as jall_cells
from repro.core.strategy import EpochPlan as JEpochPlan
from repro.dist.sharding import ParallelCtx as JParallelCtx
from repro.launch import roofline_model as jroof
from repro.launch import train as jtrain
from repro.models.model import Model as JModel
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHS, all_cells
from repro_torch.core.strategy import EpochPlan
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline_model as roof
from repro_torch.launch import train
from repro_torch.models.model import Model

NAMES = sorted(JARCHS)
MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
OPTIMIZERS = ("sgd", "adamw", "rmsprop", "adafactor")


def _stub(shape):
    names = MESHES[shape]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _specs(tree) -> dict:
    """``{path: spec tuple}`` of a reference tree of ``PartitionSpec``s."""
    leaves = jax.tree.leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(v) for path, v in leaves}


def _walk(tree, pre=()):
    """``{path: leaf}`` of the port's nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_walk(v, pre + (k,)))
        return out
    return {pre: tree}


def test_config_counts_and_flags():
    for name in NAMES:
        j, t = JARCHS[name], ARCHS[name]
        assert t.param_count() == j.param_count(), name
        assert t.active_param_count() == j.active_param_count(), name
        assert (t.attn_free, t.sub_quadratic) == (j.attn_free,
                                                  j.sub_quadratic), name
        for sname, shape in base.SHAPES.items():
            assert (base.shape_applicable(t, shape)
                    == jbase.shape_applicable(j, jbase.SHAPES[sname]))
    assert {k: tuple(vars(v).values()) for k, v in base.SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in jbase.SHAPES.items()}


def test_cells_tokens_and_hbm_bytes():
    mine = {(c.name, s.name): (ok, why) for c, s, ok, why in all_cells()}
    theirs = {(c.name, s.name): (ok, why) for c, s, ok, why in jall_cells()}
    assert mine == theirs and len(mine) == 40
    for (aname, sname) in mine:
        cfg, jcfg = ARCHS[aname], JARCHS[aname]
        shape, jshape = base.SHAPES[sname], jbase.SHAPES[sname]
        assert base.tokens_per_step(shape) == jbase.tokens_per_step(jshape)
        for opt in OPTIMIZERS:
            for wb in (1, 2):
                got = roof.analytic_hbm_bytes(cfg, shape, opt, wb)
                want = jroof.analytic_hbm_bytes(jcfg, jshape, opt, wb)
                assert got == want, (aname, sname, opt, wb)


@pytest.mark.parametrize("kernel,shape", [
    ("flash_attention", dict(b=4, s=2048, hq=32, hkv=8, d=128)),
    ("ssd_scan", dict(b=4, s=2048, nh=24, p=64, n=128)),
    ("loss_confidence", dict(t=1024, v=151936)),
    ("fused_scoring", dict(t=128, v=10)),
    ("loss_histogram", dict(n=1_281_167)),
    ("loss_histogram", dict(n=50_000, bins=256)),
    ("loss_minmax", dict(n=50_000)),
    ("rank_select", dict(n=1_281_167))])
def test_kernel_hbm_bytes(kernel, shape):
    assert roof.kernel_hbm_bytes(kernel, **shape) == \
        jroof.kernel_hbm_bytes(kernel, **shape)
    with pytest.raises(ValueError, match="no HBM byte model"):
        roof.kernel_hbm_bytes("conv", n=1)


def _plans():
    """Pairs of equal plans: shuffled visible sets of several lengths,
    hidden and moved-back ids, an Eq. 8 factor."""
    rng = np.random.default_rng(0)
    out = []
    for e, n in enumerate((1000, 1024, 777, 64)):
        perm = rng.permutation(1200)
        kw = dict(epoch=e, visible_indices=perm[:n],
                  hidden_indices=perm[n:], max_fraction=0.3,
                  hidden_fraction=(1200 - n) / 1200,
                  lr_scale=1.0 / (1 - (1200 - n) / 1200),
                  needs_refresh=bool(e % 2), host_syncs=e % 3,
                  moveback_indices=perm[n:n + 5])
        out.append((EpochPlan(**kw), JEpochPlan(**kw)))
    return out


def test_plan_helpers():
    for plan, jplan in _plans():
        assert train.plan_summary(plan) == jtrain.plan_summary(jplan)
        assert train.plan_lr(0.05, plan) == jtrain.plan_lr(0.05, jplan)
        for world, per in ((1, 16), (2, 8), (4, 16), (8, 3)):
            for r in range(world):
                np.testing.assert_array_equal(
                    train.plan_worker_indices(plan, world, r, per),
                    jtrain.plan_worker_indices(jplan, world, r, per))
            got = list(train.plan_global_batches(plan, world, per))
            want = list(jtrain.plan_global_batches(jplan, world, per))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", list(MESHES))
def test_param_and_input_specs(shape):
    stub = _stub(shape)
    for name in NAMES:
        for kw in (dict(fsdp=True), dict(fsdp=False), dict(dp_only=True),
                   dict(fsdp=True, seq_parallel_kv=True)):
            jm = JModel(JARCHS[name], JParallelCtx(mesh=stub, **kw))
            tm = Model(ARCHS[name], ParallelCtx(mesh=stub, **kw),
                       device="cpu")
            assert _walk(tm.param_specs()) == _specs(jm.param_specs()), \
                (name, kw)
            for sname, s in base.SHAPES.items():
                js = jbase.SHAPES[sname]
                assert tm.input_logical(s) == jm.input_logical(js)
                assert (_walk(tm.input_shardings(s))
                        == _specs(jm.input_shardings(js))), (name, sname)
                got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                       for k, v in _walk(tm.input_specs(s)).items()}
                want = {tuple(getattr(p, "key", None) for p in path):
                        (tuple(v.shape), str(v.dtype))
                        for path, v in jax.tree.leaves_with_path(
                            jm.input_specs(js))}
                assert got == want, (name, sname)


def test_build_ctx_fsdp_rule():
    for shape in MESHES:
        for name in NAMES:
            for kw in (dict(), dict(dp_only=True), dict(fsdp=False)):
                c = train.build_ctx(ARCHS[name], _stub(shape), **kw)
                j = jtrain.build_ctx(JARCHS[name], _stub(shape), **kw)
                assert (c.fsdp, c.remat, c.dp_axes, c.tp_axis, c.tp_size,
                        c.dp_size) == (j.fsdp, j.remat, j.dp_axes, j.tp_axis,
                                       j.tp_size, j.dp_size), (shape, name)
    assert train.FSDP_THRESHOLD_BYTES == jtrain.FSDP_THRESHOLD_BYTES
    assert not train.build_ctx(ARCHS["smollm-135m"], None).fsdp


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_optimizer_state_specs(opt):
    stub = _stub((16, 16))
    for name in ("qwen3-1.7b", "kimi-k2-1t-a32b", "mamba2-130m",
                 "seamless-m4t-large-v2"):
        ctx = ParallelCtx(mesh=stub, fsdp=True)
        jctx = JParallelCtx(mesh=stub, fsdp=True)
        model = Model(ARCHS[name], ctx, device="cpu")
        jm = JModel(JARCHS[name], jctx)
        hp = dict(state_dtype=jnp.float32) if opt == "adamw" else {}
        pa, oa, ps, os_ = train.abstract_train_state(model, opt)
        jpa, joa, jps, jos = jtrain.abstract_train_state(
            jm, jmake_optimizer(opt, **hp))
        if opt == "sgd":        # the reference's default SGD keeps no state
            assert os_ == jos == () and oa == joa == ()
            pa, oa, ps, os_ = train.abstract_train_state(model, opt,
                                                         momentum=True)
            jpa, joa, jps, jos = jtrain.abstract_train_state(
                jm, jmake_optimizer(opt, momentum=0.9))
        assert _walk(os_) == _specs(jos), (name, opt)
        assert _walk(ps) == _specs(jps)
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in _walk(oa).items() if isinstance(v, torch.Tensor)}
        want = {tuple(getattr(p, "key", None) for p in path):
                (tuple(v.shape), str(v.dtype))
                for path, v in jax.tree.leaves_with_path(joa)}
        assert got == want, (name, opt)


def test_production_mesh_over_the_fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    for multi, world in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"{world} ranks"):
            tmesh.make_production_mesh(multi_pod=multi)
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = tmesh.make_production_mesh(multi_pod=multi)
            shape = (2, 16, 16) if multi else (16, 16)
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == MESHES[shape]
            ctx = train.build_ctx(ARCHS["qwen3-1.7b"], mesh, fsdp=True)
            assert ctx.tp_size == 16 and ctx.dp_size == world // 16
            jm = JModel(JARCHS["qwen3-1.7b"],
                        JParallelCtx(mesh=_stub(shape), fsdp=True))
            model = Model(ARCHS["qwen3-1.7b"], ctx, device="cpu")
            assert _walk(model.param_specs()) == _specs(jm.param_specs())
            wq = model.param_specs()["layers"]["attn"]["wq"]
            assert ctx.local_shape(wq, (28, 2048, 16, 128)) == (
                (28, 2048 // (world // 16), 1, 128))
        finally:
            dist.destroy_process_group()


def test_h100_constants():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 900e9
    assert not hasattr(tmesh, "ICI_BW")


def test_spec_guard_and_local_blocks():
    """The divisibility guard, and a rank's block on a stand-in mesh
    (coordinate 0 on every axis)."""
    ctx = ParallelCtx(mesh=_stub((2, 4)), fsdp=True)
    spec = ctx.spec("fsdp", "tp", None, dims=(64, 8, 16))
    assert spec == ("data", "model", None)
    assert ctx.local_shape(spec, (64, 8, 16)) == (32, 2, 16)
    x = torch.arange(64 * 8 * 16).reshape(64, 8, 16)
    assert torch.equal(ctx.local_shard(x, spec), x[:32, :2])
    assert ctx.spec("tp", dims=(9,)) == (None,)         # 9 heads, 4 ranks
    assert ParallelCtx().spec("fsdp", "tp") == ()
