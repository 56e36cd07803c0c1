"""PyTorch port, the mesh's model axis: tensor-parallel, expert-parallel
and FSDP training over a ``("data", "model")`` mesh.

The reference's contract for the model axis
(``tests/test_distributed.py::test_sharded_matches_single_device``: a
(2, 4) mesh with FSDP within 3e-3 of one device, dense and SSM, and 2e-2
for ``moe-d``, "capacity routing differs per data shard") fails on this
tree's jax, so the port is held against JAX on one device at that test's
bounds, and against itself on one device.  A gloo world of 8 CPU ranks is
spawned once (``tests/torch_model_axis_scenarios.py``), and in it every
case takes one LR-0 step of ``launch/train.py::make_train_step`` on its
shards:

- the reference test's ``dense-d`` and ``ssm-d`` at (2, 4), (1, 8) and
  (8, 1) with FSDP, and at (2, 4) with ``dp_only`` (the model axis folded
  into the data axes), and a reduced hymba-1.5b (4 layers, a sequence
  past its window of 32, under ``tests/test_torch_zoo.py``'s conditioning
  controls: at the reference's init its float32 gradient parts from JAX's
  by 4e-4 of a leaf's scale on one device already) at (2, 4) and (1, 8)
  with FSDP, its q heads split and its KV heads replicated: the loss and
  per-sample losses within 3e-3 of ``jax`` on one device (the measured
  error printed) and within 1e-5 of the port on one device, every leaf's
  reduced gradient, gathered, within 1e-4 x the leaf's max |g| of
  ``jax.grad`` on one device;
- the reference test's ``moe-d`` (8 experts, top 2, capacity factor 8),
  expert-parallel at (2, 4) and (1, 8) in the ``"gather"`` layout and at
  (2, 4) in ``"partial"``: the loss and per-sample losses within the
  reference's 2e-2 of ``jax`` on one device (the measured error printed),
  and within 1e-5 of the port on one device as the layout routes (per
  data shard in ``"gather"``, the whole batch in ``"partial"``), every
  gradient within 1e-4 of the leaf's max |g| of that expectation;
- reduced phi3.5-moe, seamless-m4t and llava at (8, 1), (2, 4) and (4, 2)
  with FSDP against the port on one device (the MoE per data shard: its
  routing, capacity and aux term are each data shard's), loss and
  per-sample metrics 1e-5 and every gradient 1e-4; seamless-m4t and llava
  at (2, 4) and (4, 2) also within 3e-3 of ``jax`` on one device;
- each rank holds the blocks its spec says (``ctx.local_shape``), and
  every rank reports the same loss.

A world of one runs every model at (1, 1) (the MoE in both layouts): bit
for bit the port without a context.  Only ``remat_policy`` ``"dots"``
raises (ROADMAP A.9(d)).  Serving on the mesh is
``tests/test_torch_mesh_serve.py``.
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.registry import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import get_arch
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.launch.mesh import spawn
from repro_torch.launch.train import build_ctx
from repro_torch.models.model import build_model
from repro_torch.models.transformer import unstack_layers

import torch_model_axis_scenarios as sc

B, S = 8, 32
SHAPES = [((2, 4), dict(fsdp=True)), ((1, 8), dict(fsdp=True)),
          ((8, 1), dict(fsdp=True)), ((2, 4), dict(fsdp=True, dp_only=True))]
DENSE = dict(name="dense-d", family="dense", num_layers=2, d_model=64,
             num_heads=8, num_kv_heads=4, d_ff=128, vocab_size=256,
             head_dim=16, qk_norm=True)
SSM = dict(name="ssm-d", family="ssm", num_layers=2, d_model=64,
           num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256)


HYMBA_S = 40
#: The mesh shapes each model runs at.
RUNS = {"dense-d": SHAPES, "ssm-d": SHAPES, "hymba-1.5b": SHAPES[:2]}
#: The reference test's MoE (``tests/test_distributed.py``).
MOE = dict(name="moe-d", family="moe", num_layers=2, d_model=64, num_heads=8,
           num_kv_heads=4, d_ff=0, vocab_size=256, head_dim=16)
PARTIAL = dict(fsdp=True, moe_fsdp_mode="partial")
MOE_RUNS = [((2, 4), dict(fsdp=True)), ((1, 8), dict(fsdp=True)),
            ((2, 4), PARTIAL)]
#: The shapes beside (8, 1) that the MoE, encoder-decoder and VLM run at.
FAMILY_SHAPES = [(2, 4), (4, 2)]


def _configs():
    """(port config, reference config, sequence length) of each model."""
    hymba = dataclasses.replace(get_arch("hymba-1.5b").reduced(), num_layers=4)
    jhymba = dataclasses.replace(jget_arch("hymba-1.5b").reduced(),
                                 num_layers=4)
    return [(ArchConfig(**DENSE), JArchConfig(**DENSE), S),
            (ArchConfig(**SSM, ssm=SSMConfig(16, 16, chunk=16)),
             JArchConfig(**SSM, ssm=JSSMConfig(16, 16, chunk=16)), S),
            (hymba, jhymba, HYMBA_S)]


def _condition(params: dict, cfg) -> dict:
    """``tests/test_torch_zoo.py``'s controls: every attention projection
    (the encoder-decoder's self- and cross-attention too) at its input's
    fan-in, ``a_log`` U[0, 1)."""
    params = jax.tree.map(np.array, params)
    dh = cfg.resolved_head_dim
    for key in ("layers", "enc_layers", "dec_layers"):
        layers = params.get(key)
        if layers is None:
            continue
        for a in (layers.get("attn"), layers.get("xattn")):
            if a is None:
                continue
            for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                              ("wv", cfg.d_model),
                              ("wo", cfg.num_heads * dh)):
                a[name] = a[name] * np.float32(
                    (a[name].shape[-2] / fan) ** 0.5)
        if "ssm" in layers:
            layers["ssm"]["a_log"] = np.random.default_rng(0).uniform(
                0, 1, layers["ssm"]["a_log"].shape).astype(np.float32)
    return params


def _per_layer(tree: dict) -> dict:
    """A stacked numpy tree with its ``layers`` as a per-layer list."""
    out = dict(tree)
    layers = tree["layers"]
    n = jax.tree.leaves(layers)[0].shape[0]
    out["layers"] = [jax.tree.map(lambda a: a[i], layers) for i in range(n)]
    return out


def _jax_reference(jcfg, batch):
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.key(0))
    if jcfg.family == "hybrid":
        params = jax.tree.map(jnp.asarray, _condition(params, jcfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, (lv, _, _)), g = jax.jit(jax.value_and_grad(
        jm.loss_and_metrics, has_aux=True))(params, jb)
    grads = dict(flatten(_per_layer(jax.tree.map(np.asarray, g))))
    return (jax.tree.map(np.asarray, params), float(loss), np.asarray(lv),
            grads)


@pytest.fixture(scope="module")
def worlds():
    refs, cases, ones = {}, [], []
    for cfg, jcfg, s in _configs():
        batch = sc.random_batch(cfg, B, s)
        params, loss, lv, grads = _jax_reference(jcfg, batch)
        refs[cfg.name] = dict(cfg=cfg, loss=loss, lv=lv, grads=grads,
                              port=sc.grads_step(cfg, None, params, batch))
        for shape, kw in RUNS[cfg.name]:
            cases.append((_name(cfg, shape, kw), cfg, params, batch, shape,
                          kw))
        ones.append((cfg.name, cfg, params, batch, dict(fsdp=True)))
    for arch in TP1:
        cfg = get_arch(arch).reduced()
        params = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        if cfg.family in ("vlm", "encdec"):
            # At the reference's init their attention parts the ranks'
            # sums from one device's by ~1e-4 of a gradient's scale (the
            # embedding's for llava at (8, 1), seamless's wk at (2, 4)).
            params = _condition(params, cfg)
        batch = _family_batch(cfg)
        refs[arch] = dict(cfg=cfg, port=_expectation(cfg, params, batch, B))
        cases.append((arch, cfg, params, batch, (8, 1), dict(fsdp=True)))
        ones.append((arch, cfg, params, batch, dict(fsdp=True)))
        for shape in FAMILY_SHAPES:
            name = _name(cfg, shape, {})
            refs[name] = dict(cfg=cfg, port=_expectation(
                cfg, params, batch, shape[0]))
            if cfg.family != "moe":
                refs[name]["jax"] = _jax_loss(cfg, params, batch)
            cases.append((name, cfg, params, batch, shape, dict(fsdp=True)))
    mcfg, jcfg = ArchConfig(**MOE, moe=MoEConfig(8, 2, 64, capacity_factor=8.0)), \
        JArchConfig(**MOE, moe=JMoEConfig(8, 2, 64, capacity_factor=8.0))
    batch = sc.random_batch(mcfg, B, S)
    params, loss, lv, _ = _jax_reference(jcfg, batch)
    refs["moe-d"] = dict(cfg=mcfg, loss=loss, lv=lv)
    for shape, kw in MOE_RUNS:
        name = _name(mcfg, shape, kw)
        refs[name] = dict(cfg=mcfg, port=_expectation(
            mcfg, params, batch, 1 if kw.get("moe_fsdp_mode") else shape[0]))
        cases.append((name, mcfg, params, batch, shape, kw))
    for kw in (dict(fsdp=True), PARTIAL):
        ones.append((_name(mcfg, (1, 1), kw), mcfg, params, batch, kw))
    ranks = spawn(sc.axis_world, 8, "gloo", "cpu", (cases,))
    one = spawn(sc.unit_world, 1, "gloo", "cpu", (ones,))[0]
    return refs, ranks, one


#: The other families, reduced, at (8, 1) and ``FAMILY_SHAPES`` with FSDP,
#: against the port on one device.
TP1 = ("phi3.5-moe-42b-a6.6b", "seamless-m4t-large-v2",
       "llava-next-mistral-7b")


def _expectation(cfg, params: dict, batch: dict, dp: int) -> dict:
    """What ``dp`` data ranks must give, from the port on one device.  An
    MoE in the ``"gather"`` layout routes each data rank's tokens into
    that rank's own capacity, its aux term from that rank's routing: the
    sharded step is the mean of one device's steps on each data shard's
    rows (``B / dp`` of them), scalar and gradients alike, its per-sample
    metrics theirs in row order (``dp`` 1: the ``"partial"`` layout,
    which routes the whole batch).  The other families compute what one
    device does on the whole batch."""
    if cfg.moe is None or dp == 1:
        return sc.grads_step(cfg, None, params, batch)
    n = B // dp
    shards = [sc.grads_step(cfg, None, params,
                            {k: v[r * n:(r + 1) * n] for k, v in batch.items()})
              for r in range(dp)]
    return {"loss": float(np.mean([o["loss"] for o in shards])),
            **{k: np.concatenate([o[k] for o in shards])
               for k in ("lv", "pa", "pc")},
            "grads": {k: np.mean([o["grads"][k] for o in shards], axis=0)
                      for k in shards[0]["grads"]}}


def _jax_loss(cfg, params: dict, batch: dict) -> tuple[float, np.ndarray]:
    """JAX's loss and per-sample losses on one device for the port's
    ``params`` (a stacked tree)."""
    jm = jbuild_model(jget_arch(cfg.name).reduced())
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), params)
    loss, (lv, _, _) = jax.jit(jm.loss_and_metrics)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), np.asarray(lv)


def _family_batch(cfg) -> dict:
    """8 sequences with the family's inputs: frames for the
    encoder-decoder (its decoder a quarter as long), patch embeddings
    for the VLM."""
    rng = np.random.default_rng(1)
    if cfg.family == "encdec":
        batch = sc.random_batch(cfg, B, S // 4)
        batch["frames"] = rng.normal(
            size=(B, S, cfg.encoder_input_dim)).astype(np.float32)
        return batch
    batch = sc.random_batch(cfg, B, S)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patch_tokens, 1024)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", TP1)
def test_other_families_at_tp_size_one(worlds, arch):
    """The MoE, the encoder-decoder and the VLM on 8 data ranks with FSDP
    (a model axis of 1) against the port on one device
    (``_tp1_expectation``: for the MoE, one device on each rank's row):
    the loss and per-sample losses within 1e-5, the PA flags equal, and
    every gradient, the MoE's router and experts included, within 1e-4 of
    the leaf's max |g|."""
    refs, ranks, _ = worlds
    got, one = ranks[0][arch], refs[arch]["port"]
    assert all(r[arch]["loss"] == got["loss"] for r in ranks)
    _close_to(got, one)


def _name(cfg, shape, kw) -> str:
    return (f"{cfg.name}{shape}{'dp_only' if kw.get('dp_only') else ''}"
            f"{'partial' if kw.get('moe_fsdp_mode') == 'partial' else ''}")


def _close_to(got: dict, one: dict) -> None:
    """``got`` (the mesh's step) within 1e-5 of ``one`` (the port on one
    device), the PA flags equal, every gradient within 1e-4 of the leaf's
    max |g|."""
    assert abs(got["loss"] - one["loss"]) <= 1e-5
    np.testing.assert_allclose(got["lv"], one["lv"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["pa"], one["pa"])
    np.testing.assert_allclose(got["pc"], one["pc"], rtol=0, atol=1e-5)
    assert got["grads"].keys() == one["grads"].keys()
    for k, want in one["grads"].items():
        scale = float(np.abs(want).max())
        err = float(np.abs(got["grads"][k] - want).max())
        assert err <= 1e-4 * scale, (k, err, scale)


CASES = [(c, shape, kw) for c, shapes in RUNS.items() for shape, kw in shapes]


def _case_id(arch, shape, kw) -> str:
    return (f"{arch}-{shape[0]}x{shape[1]}"
            f"{'-dp_only' if kw.get('dp_only') else ''}"
            f"{'-partial' if kw.get('moe_fsdp_mode') == 'partial' else ''}")


FAMILY_CASES = [(a, shape, dict(fsdp=True)) for a in TP1
                for shape in FAMILY_SHAPES]


@pytest.mark.parametrize("shape,kw", MOE_RUNS,
                         ids=[_case_id("moe-d", s, k) for s, k in MOE_RUNS])
def test_expert_parallel_moe_matches_one_device(worlds, shape, kw):
    """``moe-d`` expert-parallel (E/tp experts a model rank, one sum over
    "model"): within the reference's 2e-2 of JAX on one device, and
    within 1e-5 (gradients 1e-4 of each leaf's max) of the port on one
    device as the layout routes: per data shard in ``"gather"``, the whole
    batch in ``"partial"``."""
    refs, ranks, _ = worlds
    ref = refs["moe-d"]
    name = _name(ref["cfg"], shape, kw)
    got = ranks[0][name]
    assert all(r[name]["loss"] == got["loss"] for r in ranks)
    err = abs(got["loss"] - ref["loss"])
    lv_err = float(np.abs(got["lv"] - ref["lv"]).max())
    print(f"moe-d {shape} {kw}: vs jax scalar_err={err:.2e} "
          f"lv_err={lv_err:.2e}")
    assert err < 2e-2 and lv_err < 2e-2
    _close_to(got, refs[name]["port"])


@pytest.mark.parametrize("arch,shape,kw", FAMILY_CASES,
                         ids=[_case_id(*c) for c in FAMILY_CASES])
def test_other_families_on_the_model_axis(worlds, arch, shape, kw):
    """Reduced phi3.5-moe (expert-parallel), seamless-m4t (head-parallel
    encoder, decoder and cross-attention) and llava (the patch positions
    in front of the text) with a model axis of 2 and 4: within 1e-5 of the
    port on one device (the MoE per data shard), every gradient 1e-4 of
    the leaf's max; seamless-m4t and llava within 3e-3 of JAX on one
    device."""
    refs, ranks, _ = worlds
    name = _name(refs[arch]["cfg"], shape, kw)
    got = ranks[0][name]
    assert all(r[name]["loss"] == got["loss"] for r in ranks)
    if "jax" in refs[name]:
        loss, lv = refs[name]["jax"]
        err = abs(got["loss"] - loss)
        lv_err = float(np.abs(got["lv"] - lv).max())
        print(f"{arch} {shape}: vs jax scalar_err={err:.2e} "
              f"lv_err={lv_err:.2e}")
        assert err < 3e-3 and lv_err < 3e-3
    _close_to(got, refs[name]["port"])


@pytest.mark.parametrize("arch,shape,kw", CASES,
                         ids=[_case_id(*c) for c in CASES])
def test_model_axis_matches_one_device(worlds, arch, shape, kw):
    refs, ranks, _ = worlds
    ref = refs[arch]
    cfg = ref["cfg"]
    got = ranks[0][_name(cfg, shape, kw)]
    assert all(r[_name(cfg, shape, kw)]["loss"] == got["loss"] for r in ranks)
    err = abs(got["loss"] - ref["loss"])
    lv_err = float(np.abs(got["lv"] - ref["lv"]).max())
    print(f"{arch} {shape} {kw}: vs jax scalar_err={err:.2e} "
          f"lv_err={lv_err:.2e}")
    assert err < 3e-3 and lv_err < 3e-3
    one = ref["port"]
    assert abs(got["loss"] - one["loss"]) <= 1e-5
    np.testing.assert_allclose(got["lv"], one["lv"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["pa"], one["pa"])
    np.testing.assert_allclose(got["pc"], one["pc"], rtol=0, atol=1e-5)
    assert got["grads"].keys() == ref["grads"].keys()
    for k, want in ref["grads"].items():
        scale = float(np.abs(want).max())
        g_err = float(np.abs(got["grads"][k] - want).max())
        assert g_err <= 1e-4 * scale, (k, g_err, scale)


SHARD_CASES = (CASES + [("moe-d", s, k) for s, k in MOE_RUNS]
               + FAMILY_CASES)


@pytest.mark.parametrize("arch,shape,kw", SHARD_CASES,
                         ids=[_case_id(*c) for c in SHARD_CASES])
def test_local_shards_follow_the_specs(worlds, arch, shape, kw):
    """A rank's storage is what ``param_specs`` says: each leaf's block."""
    refs, ranks, _ = worlds
    cfg = refs[arch]["cfg"]
    stub = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 axis_names=("data", "model"))
    ctx = build_ctx(cfg, stub, **kw)
    model = build_model(cfg, ctx, device="cpu")
    whole = unstack_layers(model.abstract_params(), copy=False)
    glob = [tuple(t.shape) for _, t in flatten(whole)]
    want = [ctx.local_shape(sp, g)
            for sp, g in zip(model.leaf_specs(whole), glob)]
    assert ranks[0][_name(cfg, shape, kw)]["local_shapes"] == want
    if kw.get("dp_only") or shape[1] == 1:
        return
    assert any(a != b for a, b in zip(want, glob)), "nothing was sharded"


@pytest.mark.parametrize("arch", ["dense-d", "ssm-d", "hymba-1.5b", *TP1,
                                  "moe-d(1, 1)", "moe-d(1, 1)partial"])
def test_unit_mesh_is_one_device_bit_for_bit(worlds, arch):
    got = worlds[2][arch]
    assert got["loss"] == got["one_loss"]
    assert got["lv"] and got["grads"], got


def test_sequence_parallel_kv_and_dots_raise():
    """Of the two refusals this test held, only ``remat_policy`` "dots"
    is left (ROADMAP A.9(d)): ``seq_parallel_kv`` decodes
    (``tests/test_torch_mesh_serve.py``)."""
    stub = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                 axis_names=("data", "model"))
    cfg = ArchConfig(**DENSE)
    model = build_model(cfg, ParallelCtx(mesh=stub, remat=True,
                                         remat_policy="dots"), device="cpu")
    with pytest.raises(NotImplementedError, match=r"A\.9\(d\)"):
        model.loss_and_metrics({}, {})


def test_local_kv_heads_of_replicated_kv():
    """Which KV heads a rank's q heads read when the KV heads stay
    replicated: a range (GQA within the rank) or one index a q head."""
    from repro_torch.models.transformer import _local_kv_heads
    cfg = dataclasses.replace(ArchConfig(**DENSE), num_heads=12,
                              num_kv_heads=4)
    assert _local_kv_heads(cfg, 4, 0) == [0, 0, 0, 1]       # tp 3
    assert _local_kv_heads(cfg, 4, 1) == (1, 3)
    assert _local_kv_heads(cfg, 4, 2) == [2, 3, 3, 3]
    qwen = get_arch("qwen3-1.7b")                             # 16 q, 8 kv
    assert [_local_kv_heads(qwen, 1, r) for r in (0, 1, 15)] == [
        (0, 1), (0, 1), (7, 8)]                               # tp 16
