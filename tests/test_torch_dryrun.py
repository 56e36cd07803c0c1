"""PyTorch port, the dry run (``launch/dryrun.py``), its collective
accounting (``launch/hlo_analysis.py``) and Adafactor on sharded leaves.

- the wire rules: the reference's ``collective_bytes`` on HLO lines of
  each kind (``-start``/``-done``, tuple results) against the port's on
  records of the same calls, kind for kind; ``Roofline`` equal to the
  reference's on the same inputs and constants (its ``ici_links`` 1: the
  port's interconnect rate is a card's aggregate), its defaults the
  H100's;
- the fake group against a real world: the dry run at (2, 4) with FSDP of
  small dense, SSM and MoE configs issues the collectives, operand shapes
  and groups a gloo world of 8 CPU ranks issues running that step, call
  for call, but where the fake group reduce-scatters (the NCCL branch of
  ``dist/sharding.py``) gloo all-reduces;
- ``run_cell_extrapolated`` at L = 6 equals the full-depth meta run
  exactly, in the operations and each collective kind;
- all ten archs at (16, 16) ``train_4k``: ``argument_size_in_bytes`` is
  what the reference's ``abstract_train_state`` specs and shapes give one
  device (with its inputs' blocks and the LR), and ``model_flops``,
  ``hlo_bytes`` and the skip reasons equal the reference's;
- the whole matrix on both production meshes (``--extrapolate``): 64
  cells ``ok``, 16 ``skip``, none ``error``, each probe's FSDP decision the
  reference's ``build_ctx`` on the scaled config; the ``long_500k`` cells
  (batch 1, replicated over the data axes) at the reference's argument
  bytes;
- Adafactor on sharded leaves: three steps of ``dense-d`` (FSDP, LR
  1e-2) and ``moe-d`` (LR 1e-3) at (2, 4) and (1, 8), gathered, within
  1e-5 of the port on one device (``moe-d`` at (2, 4) in the ``"partial"`` layout, which
  routes the whole batch as one device does).

The gloo world is spawned once (``tests/torch_model_axis_scenarios.py``),
in the background while the tests that do not read it run.
The dry run joins torch's fake process group in this process; a fixture
leaves it after each test.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import shape_applicable as jshape_applicable
from repro.configs.base import tokens_per_step as jtokens_per_step
from repro.configs.registry import ARCHS as JARCHS
from repro.launch import hlo_analysis as jhlo
from repro.launch import roofline_model as jroof
from repro.launch import train as jtrain
from repro.models.model import Model as JModel
from repro_torch.configs.base import ArchConfig, MoEConfig, ShapeSpec, SSMConfig
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.hlo_analysis import Collective
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, spawn
from repro_torch.models import transformer

import torch_model_axis_scenarios as sc


@pytest.fixture(autouse=True)
def _leave_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Wire rules and the roofline


#: (HLO line, the same call as a record): each kind, async pairs, tuples.
HLO = [
    ("%ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %x), "
     "replica_groups={}", ("all-reduce", (1024, 512), (1024, 512), 4)),
    ("%ag = bf16[64,256]{1,0} all-gather(bf16[4,256]{1,0} %y), dimensions={0}",
     ("all-gather", (4, 256), (64, 256), 2)),
    ("%rs = f32[8,128]{1,0} reduce-scatter(f32[128,128]{1,0} %g), "
     "dimensions={0}", ("reduce-scatter", (128, 128), (8, 128), 4)),
    ("%a2a = bf16[16,32]{1,0} all-to-all(bf16[16,32]{1,0} %t), "
     "dimensions={0}", ("all-to-all", (16, 32), (16, 32), 2)),
    ("%cp = s32[7]{0} collective-permute(s32[7]{0} %p), "
     "source_target_pairs={{0,1}}", ("collective-permute", (7,), (7,), 4)),
    ("%ags = (bf16[2,256]{1,0}, bf16[32,256]{1,0}) all-gather-start("
     "bf16[2,256]{1,0} %z), dimensions={0}",
     ("all-gather", (2, 256), [(2, 256), (32, 256)], 2)),
    ("%agd = bf16[32,256]{1,0} all-gather-done((bf16[2,256]{1,0}, "
     "bf16[32,256]{1,0}) %ags)", None),
    ("%ars = f32[3,5]{1,0} all-reduce-start(f32[3,5]{1,0} %w)",
     ("all-reduce", (3, 5), (3, 5), 4)),
    ("%ard = f32[3,5]{1,0} all-reduce-done(f32[3,5]{1,0} %ars)", None),
]


def _record(kind, src, out, elt) -> Collective:
    """The call as a record: a tuple result (a list of shapes) counts
    every part, as the reference counts an async start's."""
    outs = out if isinstance(out, list) else [out]
    n_src = math.prod(src) * elt
    n_out = sum(math.prod(o) for o in outs) * elt
    return Collective(kind=kind, op="?", operand_bytes=n_src,
                      result_bytes=n_out, operand_shape=src,
                      result_shape=outs[-1],
                      dtype="?", group_size=8, largest=max(n_src, n_out))


def test_wire_rules_match_the_reference():
    """Kind for kind, the reference's bytes of the HLO text equal the
    port's of the same calls' records; a ``-done`` is not a second call."""
    want = jhlo.collective_bytes("\n".join(line for line, _ in HLO))
    got = hlo_analysis.collective_bytes(
        [_record(*r) for _, r in HLO if r is not None])
    assert got == want
    assert got["count"] == 7 and got["reduce-scatter"] == 128 * 128 * 4
    assert hlo_analysis.largest_bytes(
        [_record(*HLO[0][1])]) == {"?": 1024 * 512 * 4}


def test_roofline_matches_the_reference():
    args = dict(flops=3.1e18, hbm_bytes=4.2e14, coll_bytes=5.3e10, chips=256,
                peak_flops=1.5e14, hbm_bw=2e12)
    for ici in (4.5e10, 9e11):
        got = hlo_analysis.Roofline(**args, ici_bw=ici)
        want = jhlo.Roofline(**args, ici_bw=ici, ici_links=1)
        assert got.as_dict() == want.as_dict()
    roof = hlo_analysis.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0,
                                 chips=1)
    assert (roof.peak_flops, roof.hbm_bw, roof.ici_bw) == (
        PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 900e9)
    assert not hasattr(roof, "ici_links")


def test_kernel_wrappers_credit_meta_only_in_the_dry_run():
    """Inside ``backend.crediting`` a kernel wrapper given meta tensors
    returns outputs of the right shapes and credits the operations
    ``chip_smoke.py`` bounds it by; outside it a meta tensor is refused
    like any tensor off the CPU and the card."""
    from repro_torch.kernels import backend, ops
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ssd_scan as tssd
    q, kv = (torch.empty(2, 64, h, 32, device="meta") for h in (4, 2))
    x, dt = torch.empty(2, 64, 3, 8, device="meta"), torch.empty(
        2, 64, 3, device="meta")
    bc, nh = torch.empty(2, 64, 16, device="meta"), torch.empty(
        3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, kv, kv)
    backend.META_WORK.clear()
    with backend.crediting():
        out = ops.flash_attention(q, kv, kv, True)
        y, state = ops.ssd_scan(x, dt, nh, bc, bc, nh, 16)
    assert out.shape == q.shape and out.device.type == "meta"
    assert y.shape == x.shape and state.shape == (2, 3, 16, 8)
    assert backend.META_WORK["flash_attention", "ops"] == \
        4 * 2 * 4 * 32 * (64 * 65 // 2)
    assert backend.META_WORK["ssd_scan", "ops"] == tssd.scan_ops(
        2, 64, 3, 8, 16, 16)
    assert backend.META_WORK["flash_attention", "calls"] == 1
    assert not backend.on_meta([q])


# ---------------------------------------------------------------------------
# The gloo world: the fake group's collectives and sharded Adafactor

B, S = 8, 32
DENSE = dict(name="dense-d", family="dense", num_layers=2, d_model=64,
             num_heads=8, num_kv_heads=4, d_ff=128, vocab_size=256,
             head_dim=16, qk_norm=True)
SSM = dict(name="ssm-d", family="ssm", num_layers=2, d_model=64,
           num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256)
MOE = dict(name="moe-d", family="moe", num_layers=2, d_model=64, num_heads=8,
           num_kv_heads=4, d_ff=0, vocab_size=256, head_dim=16)


def _configs() -> dict:
    return {"dense-d": ArchConfig(**DENSE),
            "ssm-d": ArchConfig(**SSM, ssm=SSMConfig(16, 16, chunk=16)),
            "moe-d": ArchConfig(**MOE, moe=MoEConfig(8, 2, 64,
                                                     capacity_factor=8.0))}


def _params(cfg) -> dict:
    from repro_torch.models.model import build_model
    tree = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    # The defs' key order: FSDP gathers a layer's leaves in the tree's.
    return transformer.map_tree(lambda t: t.numpy(), tree)


#: Adafactor's cases: (arch, mesh shape, build_ctx kwargs).
ADAFACTOR = [("dense-d", (2, 4), dict(fsdp=True)),
             ("dense-d", (1, 8), dict(fsdp=True)),
             ("moe-d", (2, 4), dict(fsdp=True, moe_fsdp_mode="partial")),
             ("moe-d", (1, 8), dict(fsdp=True))]


#: The LR of each model's three Adafactor steps (``tests/
#: test_torch_adafactor.py``'s ``LR``: at 1e-2 moe-d's third step flips an
#: expert choice, on the mesh against one device as against JAX).
LR = {"dense-d": 1e-2, "moe-d": 1e-3}


def _ada(cfg):
    return dataclasses.replace(cfg, optimizer="adafactor")


def _run_world():
    cfgs = _configs()
    params = {a: _params(c) for a, c in cfgs.items()}
    batch = sc.random_batch(cfgs["dense-d"], B, S)
    cases = [(a, "collectives", c, params[a], batch, (2, 4), dict(fsdp=True))
             for a, c in cfgs.items()]
    for a, shape, kw in ADAFACTOR:
        cases.append((f"{a}{shape}", "adafactor", _ada(cfgs[a]), params[a],
                      batch, shape, dict(kw, lr=LR[a])))
    one = {a: sc.adafactor_steps(_ada(cfgs[a]), None, params[a], batch,
                                 lr=LR[a])
           for a in ("dense-d", "moe-d")}
    ranks = spawn(sc.dryrun_world, 8, "gloo", "cpu", (cases,))
    return ranks, one


@pytest.fixture(scope="module", autouse=True)
def _world_in_background():
    """The gloo world, spawned when the module starts: the tests before
    the ones that read it run meanwhile."""
    box: dict = {}

    def run():
        try:
            box["out"] = _run_world()
        except BaseException as e:  # noqa: BLE001 — re-raised in ``world``
            box["error"] = e
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield thread, box
    thread.join()


@pytest.fixture(scope="module")
def world(_world_in_background):
    thread, box = _world_in_background
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["out"]


# ---------------------------------------------------------------------------
# Extrapolation and the production cells


def test_extrapolation_is_exact_at_six_layers():
    for arch in ("dense-d", "moe-d"):
        cfg = dataclasses.replace(_configs()[arch], num_layers=6)
        shape = ShapeSpec("t", S, B, "train")
        kw = dict(mesh_shape=(2, 4), fsdp=True)
        full = dryrun.run_cell(cfg, shape, **kw)
        ext = dryrun.run_cell_extrapolated(cfg, shape, **kw)
        assert full["status"] == ext["status"] == "ok"
        assert ext["hlo_flops"] == full["hlo_flops"]
        assert ext["collective_bytes"] == full["collective_bytes"]
        assert ext["memory"]["argument_size_in_bytes"] == \
            full["memory"]["argument_size_in_bytes"]


#: The production meshes' axis sizes: (16, 16), and with ``multi_pod``
#: (2, 16, 16).
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


def _stub(multi_pod: bool = False):
    sizes = MESHES[multi_pod]
    return types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))


def _scaled(jcfg, n: int):
    """The reference's L = n probe of ``jcfg`` (its ``_scale_layers``)."""
    return dataclasses.replace(
        jcfg, num_layers=n,
        num_encoder_layers=n if jcfg.num_encoder_layers else 0)


@pytest.fixture(scope="module")
def matrix():
    """The dry run's matrix (``--all --both-meshes --extrapolate``): every
    arch and shape on both production meshes, each cell from its own L = 2
    and 4 probes; ``{(arch, shape, multi_pod): record}``."""
    return {(a, s, mp): dryrun.run_cell_extrapolated(a, s, multi_pod=mp)
            for mp in (False, True) for a in sorted(JARCHS)
            for s in JSHAPES}


def _local_bytes(abstract, specs, sizes=MESHES[False]) -> int:
    """One device's bytes of a reference tree of shape/dtype structs under
    its ``PartitionSpec``s on a mesh of ``sizes`` (default (16, 16))."""
    from jax.sharding import PartitionSpec as P
    total = 0
    leaves = jax.tree.leaves(abstract)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    for a, sp in zip(leaves, spec_leaves):
        shape = list(a.shape)
        for d, entry in enumerate(tuple(sp)):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            shape[d] //= math.prod(sizes[x] for x in axes)
        total += math.prod(shape) * jnp.dtype(a.dtype).itemsize
    return total


def test_production_train_cells_match_the_reference(matrix):
    """Every arch at (16, 16) ``train_4k`` (the L = 2 and 4 probes): the
    argument bytes a device holds, the model FLOPs and the analytic HBM
    bytes equal the reference's; ``long_500k`` skips for the same archs
    with the same reason.  The probes take their own FSDP decisions, as
    the reference's do; the argument bytes are held at the full depth's
    decision (passed as ``fsdp``) where the probes' differ from it."""
    shape = JSHAPES["train_4k"]
    for name in sorted(JARCHS):
        jcfg = JARCHS[name]
        rec = matrix[name, "train_4k", False]
        assert rec["status"] == "ok", (name, rec.get("error"))
        jctx = jtrain.build_ctx(jcfg, _stub())
        if rec["probe_fsdp"] != [jctx.fsdp] * 2:
            rec = dryrun.run_cell_extrapolated(name, "train_4k",
                                               fsdp=jctx.fsdp)
        jm = JModel(jcfg, jctx)
        pa, oa, ps, os_ = jtrain.abstract_train_state(
            jm, jtrain.optimizer_for(jcfg), jnp.bfloat16)
        want = (_local_bytes(pa, ps) + _local_bytes(oa, os_)
                + _local_bytes(jm.input_specs(shape, jnp.bfloat16),
                               jm.input_shardings(shape, jnp.bfloat16))
                + 4)
        assert rec["memory"]["argument_size_in_bytes"] == want, name
        assert rec["fsdp"] == jctx.fsdp, name
        assert rec["model_flops"] == (6 * jcfg.active_param_count()
                                      * jtokens_per_step(shape)), name
        assert rec["hlo_bytes"] == jroof.analytic_hbm_bytes(
            jcfg, shape, jcfg.optimizer)["total"], name
        ok, reason = jshape_applicable(jcfg, JSHAPES["long_500k"])
        if not ok:
            skip = dryrun.run_cell(name, "long_500k")
            assert (skip["status"], skip["reason"]) == ("skip", reason)


def test_matrix_runs_every_applicable_cell(matrix):
    """64 cells ``ok``, the 16 the reference skips ``skip``, none
    ``error``; every cell's probes decide FSDP as the reference's
    ``build_ctx`` does on the scaled config at the cell's mesh."""
    counts = collections.Counter(r["status"] for r in matrix.values())
    assert counts == {"ok": 64, "skip": 16}, [
        (k, r.get("error")) for k, r in matrix.items()
        if r["status"] == "error"]
    for (name, shape, mp), rec in matrix.items():
        jcfg = JARCHS[name]
        ok, _ = jshape_applicable(jcfg, JSHAPES[shape])
        assert rec["status"] == ("ok" if ok else "skip"), (name, shape, mp)
        if ok:
            want = [jtrain.build_ctx(_scaled(jcfg, n), _stub(mp)).fsdp
                    for n in (2, 4)]
            assert rec["probe_fsdp"] == want, (name, shape, mp)
    # internlm2-20b train_4k: over the threshold at full depth, under it
    # at L = 2 and 4, so its probes extrapolate unsharded parameters.
    rec = matrix["internlm2-20b", "train_4k", False]
    assert rec["probe_fsdp"] == [False, False]
    assert jtrain.build_ctx(JARCHS["internlm2-20b"], _stub()).fsdp


@pytest.mark.parametrize("multi_pod", [False, True])
def test_long_500k_cells_hold_the_reference_argument_bytes(multi_pod):
    """Batch 1 over 16 data ranks: the cache and the token are replicated
    over the data axes, as the reference's spec guard replicates a dim
    that does not divide; the full-depth cell's argument bytes are the
    reference's parameters and inputs on one device."""
    sizes = MESHES[multi_pod]
    shape = JSHAPES["long_500k"]
    for name in ("hymba-1.5b", "mamba2-130m"):
        rec = dryrun.run_cell(name, "long_500k", multi_pod=multi_pod)
        assert rec["status"] == "ok", (name, rec.get("error"))
        jm = JModel(JARCHS[name], jtrain.build_ctx(JARCHS[name],
                                                   _stub(multi_pod)))
        want = (_local_bytes(jm.abstract_params(jnp.bfloat16),
                             jm.param_specs(), sizes)
                + _local_bytes(jm.input_specs(shape, jnp.bfloat16),
                               jm.input_shardings(shape, jnp.bfloat16),
                               sizes))
        assert rec["memory"]["argument_size_in_bytes"] == want, name


# ---------------------------------------------------------------------------
# Against the gloo world


@pytest.mark.parametrize("arch", ["dense-d", "ssm-d", "moe-d"])
def test_fake_group_issues_the_gloo_worlds_collectives(world, arch):
    ranks, _ = world
    cfg = _configs()[arch]
    with hlo_analysis.record_collectives() as record:
        rec = dryrun.run_cell(cfg, ShapeSpec("t", S, B, "train"),
                              mesh_shape=(2, 4), fsdp=True,
                              dtype=torch.float32)
    assert rec["status"] == "ok", rec.get("traceback")
    fake = [(c.kind, c.operand_shape, c.dtype, c.group_size)
            for c in record]
    real = ranks[0][arch]
    assert len(fake) == len(real) > 0
    scatters = 0
    for f, r in zip(fake, real):
        if f[0] == "reduce-scatter":
            scatters += 1
            assert r == ("all-reduce",) + f[1:], (f, r)
        else:
            assert f == r
    assert scatters > 0, "FSDP's backward scattered nothing"
    assert rec["collective_bytes"]["count"] == len(fake)


@pytest.mark.parametrize("arch,shape,kw", ADAFACTOR,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s, _ in ADAFACTOR])
def test_sharded_adafactor_matches_one_device(world, arch, shape, kw):
    """Three Adafactor steps on the mesh, gathered: within 1e-5 of the
    port's on one device, the losses too."""
    ranks, one = world
    got, want = ranks[0][f"{arch}{shape}"], one[arch]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    assert got["params"].keys() == want["params"].keys()
    moved = max(float(np.abs(v).max()) for v in want["params"].values())
    assert moved > 0
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=1e-5,
                                   err_msg=k)
