"""PyTorch port, the data-parallel trainer (``mesh_shape``) on gloo worlds.

The reference's ``tests/test_mesh_trainer.py`` contracts, held on the port
(the JAX mesh tests themselves fail on this tree's jax: ROADMAP, "State of
the reference").  Worlds of 2, 1 and 4 CPU ranks are spawned once each for
the module (``tests/torch_mesh_scenarios.py``: every rank runs every
scenario of its world), and the tests read their records:

- worlds 1, 2 and 4 bit-identical for ``"sort"``, ``"histogram"`` and
  ``"histogram_pallas"`` (hidden and moved-back sets, the epoch order,
  per-epoch losses, final parameters), one host sync an epoch, something
  hidden by the last epoch, every rank alike;
- ``fused_observe=False`` (the host-observe path) = fused under the mesh;
- error-feedback compression bit-identical across worlds 1 and 2, falling,
  within 10% of the uncompressed losses;
- restart bit-exact at world 2 with compression on (the row-sharded state,
  the generators and the residual through the checkpoint), and a world-2
  checkpoint restored at world 1 ending as the world-2 run;
- the scanned engine = the host loop at world 2;
- ``grad_allreduce="psum"`` reproducible at a fixed world, falling and
  within 10% of the fold, the default = an explicit ``"fold"``;
- ISWR, InfoBatch, FORGET and Selective-Backprop bit-identical across
  worlds 1 and 2 (4 epochs), fused scoring across worlds 1, 2 and 4;
- the baseline, random (its row-sharded state) and Grad-Match
  bit-identical across worlds 1 and 2 (4 epochs), their losses falling;
- the numeric guard on the reduced gradients: a clean guarded run equal
  to the unguarded one, at worlds 1 and 2;
- the configuration checks' messages (``test_mesh_config_validation``);
- the straggler monitor's world is the data-parallel degree (2) unless
  ``straggler_workers`` names one;
- 3 epochs at world 2 against the JAX single-device ``Trainer`` from its
  initial parameters and with its permutations: plans equal, losses within
  1e-4 relative (``tests/test_torch_strategies.py``'s band).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import planops as jplanops
from repro.data import SyntheticClassification as JSynthetic
from repro.models import cnn as jcnn
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.models import cnn

import torch_mesh_scenarios as sc

SELECTIONS = ("sort", "histogram", "histogram_pallas")
STRATEGIES = ("iswr", "infobatch", "forget", "sb")
#: The strategies that train every epoch on a plan of their own making
#: (the reference trains ``baseline`` under its mesh).
OTHERS = ("baseline", "random", "gradmatch")
EPOCHS = 3


def _jax_reference():
    """The JAX single-device trainer's run, its initial parameters and the
    epoch permutations its KAKURENBO sampler draws."""
    jcfg = jcnn.CNNConfig(image_size=8, widths=(8,), hidden=16)

    def loss_fn(params, batch):
        logits = jcnn.forward(params, jcfg, batch["images"])
        loss, pa, pc = jcnn.per_sample_metrics(logits, batch["labels"])
        w = batch.get("weight")
        scalar = (loss * w).mean() if w is not None else loss.mean()
        return scalar, (loss, pa, pc)

    kc = JKakurenboConfig(selection="histogram", max_fraction=0.3,
                          fraction_milestones=(0, 1, 2, 3))
    jtr = JTrainer(JTrainConfig(epochs=EPOCHS, batch_size=sc.BATCH,
                                strategy="kakurenbo", kakurenbo=kc,
                                lr=JLRSchedule(0.05, "cosine", EPOCHS, 1),
                                seed=0),
                   lambda r: jcnn.init(r, jcfg), loss_fn,
                   JSynthetic(num_samples=sc.N, image_size=8, seed=0))
    init = {k: v.numpy() for k, v in cnn.params_from_jax(
        {k: np.array(v) for k, v in jtr.params.items()}, sc.MODEL).items()}
    key, perms = jplanops.strategy_key(0, "kakurenbo"), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(sub, sc.N)))
    plans = []
    plan = jtr.strategy.plan
    jtr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    hist = jtr.run()
    return init, perms, plans, hist


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Rank 0's records of each world (and every rank's, checked alike)."""
    root = tmp_path_factory.mktemp("mesh_ckpt")
    init, perms, jplans, jhist = _jax_reference()
    sel = [(s, "run", dict(selection=s)) for s in SELECTIONS]
    strat = [(s, "run", dict(strategy=s, epochs=4))
             for s in STRATEGIES + OTHERS]
    w2 = (sel + strat + [
        ("legacy", "run", dict(fused=False)),
        ("compressed", "run", dict(compression=True)),
        ("uncompressed", "run", dict(compression=False)),
        ("scan", "run", dict(engine="scan")),
        ("host", "run", dict(engine="host")),
        ("fold", "run", dict(grad_allreduce="fold")),
        ("psum", "run", dict(grad_allreduce="psum")),
        ("psum_again", "run", dict(grad_allreduce="psum")),
        ("fused_scoring", "run", dict(fused_scoring=True)),
        ("guarded", "run", dict(guard_policy="skip_update")),
        ("ref4", "run", dict(epochs=4, compression=True)),
        ("restart", "restart", dict(ckpt=str(root / "a"), compression=True)),
        ("crash", "restart", dict(ckpt=str(root / "b"), compression=True,
                                  phase="crash")),
        ("jax", "run", dict(init=init, perms=perms)),
        ("straggler", "straggler_worlds", {})])
    w1 = sel + strat + [
        ("compressed", "run", dict(compression=True)),
        ("guarded", "run", dict(guard_policy="skip_update")),
        ("fused_scoring", "run", dict(fused_scoring=True)),
        ("resume_w2", "restart", dict(ckpt=str(root / "b"), compression=True,
                                      phase="resume"))]
    w4 = sel + [("fused_scoring", "run", dict(fused_scoring=True)),
                ("validation", "validation_messages", {})]
    out = {}
    for world, tasks in ((2, w2), (1, w1), (4, w4)):
        ranks = sc.spawn_world(sc.trainer_world, world, tasks)
        for r in ranks[1:]:
            for name in r:
                if name != "validation":
                    _same(ranks[0][name], r[name], f"rank agreement {name}")
        out[world] = ranks[0]
    out["jax"] = (jplans, jhist)
    return out


def _same(a, b, tag):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), tag
        for k in a:
            _same(a[k], b[k], f"{tag}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), tag
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{tag}/{i}")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), tag
    else:
        assert a == b, (tag, a, b)


def _bit_identical(a, b, tag):
    """Plans, per-epoch losses (exact float equality) and parameters."""
    ra, rb = a["recs"], b["recs"]
    assert len(ra) == len(rb), tag
    for e, (x, y) in enumerate(zip(ra, rb)):
        for f in ("hidden", "moveback", "order"):
            assert np.array_equal(x[f], y[f]), (tag, e, f)
        assert x["loss"] == y["loss"], (tag, e, x["loss"], y["loss"])
        assert x["bwd"] == y["bwd"], (tag, e)
    for p, q in zip(a["params"], b["params"]):
        assert np.array_equal(p, q), (tag, "params")


@pytest.mark.parametrize("selection", SELECTIONS)
def test_world_sizes_bit_identical(worlds, selection):
    one, two, four = (worlds[w][selection] for w in (1, 2, 4))
    _bit_identical(one, two, f"{selection} 1 vs 2")
    _bit_identical(one, four, f"{selection} 1 vs 4")
    for run in (one, two, four):
        assert all(r["host_syncs"] == 1 for r in run["recs"])
    assert len(one["recs"][-1]["hidden"]) > 0
    losses = [r["loss"] for r in one["recs"]]
    assert losses[-1] < losses[0]


def test_legacy_observe_equals_fused(worlds):
    _bit_identical(worlds[2]["histogram"], worlds[2]["legacy"],
                   "fused vs legacy")
    assert [r["engine"] for r in worlds[2]["legacy"]["recs"]] == ["host"] * 3


def test_compression_bit_identical_across_worlds(worlds):
    on1, on2 = worlds[1]["compressed"], worlds[2]["compressed"]
    _bit_identical(on1, on2, "compression")
    lon = [r["loss"] for r in on2["recs"]]
    loff = [r["loss"] for r in worlds[2]["uncompressed"]["recs"]]
    assert lon[-1] < lon[0], lon
    assert np.allclose(lon, loff, rtol=0.1), (lon, loff)


def test_guard_on_reduced_gradients(worlds):
    """The numeric guard on the mesh (its check on the reduced gradients):
    a clean guarded run is the unguarded one bit for bit, at worlds 1 and
    2."""
    _bit_identical(worlds[2]["guarded"], worlds[2]["histogram"], "guard on")
    _bit_identical(worlds[1]["guarded"], worlds[2]["guarded"], "guard 1 vs 2")


def test_restart_bit_exact_with_compression(worlds):
    ref, got = worlds[2]["ref4"], worlds[2]["restart"]
    assert got["resumed_at"] == 2
    assert got["loss"] == ref["recs"][-1]["loss"]
    for p, q in zip(got["params"], ref["params"]):
        assert np.array_equal(p, q)


def test_world2_checkpoint_restores_at_world1(worlds):
    ref, got = worlds[2]["ref4"], worlds[1]["resume_w2"]
    assert got["resumed_at"] == 2
    assert got["loss"] == ref["recs"][-1]["loss"]
    for p, q in zip(got["params"], ref["params"]):
        assert np.array_equal(p, q)


def test_scan_engine_equals_host_loop(worlds):
    scan, host = worlds[2]["scan"], worlds[2]["host"]
    assert [r["engine"] for r in scan["recs"]] == ["scan"] * 3
    assert [r["engine"] for r in host["recs"]] == ["host"] * 3
    _bit_identical(scan, host, "scan vs host")
    _bit_identical(scan, worlds[1]["histogram"], "scan at 2 vs world 1")


def test_psum_reproducible_and_tracks_fold(worlds):
    w = worlds[2]
    _bit_identical(w["fold"], w["histogram"], "fold is the default")
    _bit_identical(w["psum"], w["psum_again"], "psum repro")
    lp = [r["loss"] for r in w["psum"]["recs"]]
    lf = [r["loss"] for r in w["fold"]["recs"]]
    assert lp[-1] < lp[0], lp
    assert np.allclose(lp, lf, rtol=0.1), (lp, lf)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategies_bit_identical_across_worlds(worlds, strategy):
    one, two = worlds[1][strategy], worlds[2][strategy]
    _bit_identical(one, two, strategy)
    assert all(r["host_syncs"] == 1 for r in two["recs"])
    if strategy == "sb":
        assert sum(r["bwd"] for r in two["recs"]) < 4 * sc.N
    if strategy == "forget":
        assert len(two["recs"][-1]["order"]) == sc.N - int(0.3 * sc.N)


@pytest.mark.parametrize("strategy", OTHERS)
def test_other_strategies_bit_identical_across_worlds(worlds, strategy):
    one, two = worlds[1][strategy], worlds[2][strategy]
    _bit_identical(one, two, strategy)
    assert all(r["host_syncs"] == 1 for r in two["recs"])
    losses = [r["loss"] for r in two["recs"]]
    assert losses[-1] < losses[0], losses
    if strategy == "random":
        assert len(two["recs"][0]["order"]) < sc.N


def test_fused_scoring_across_worlds(worlds):
    one = worlds[1]["fused_scoring"]
    _bit_identical(one, worlds[2]["fused_scoring"], "fused scoring 1 vs 2")
    _bit_identical(one, worlds[4]["fused_scoring"], "fused scoring 1 vs 4")
    assert all(r["host_syncs"] == 1 for r in one["recs"])
    assert len(one["recs"][-1]["hidden"]) > 0


def test_mesh_config_validation(worlds):
    msgs = worlds[4]["validation"]
    assert "grad_chunks" in msgs["chunks"]
    assert "batch_size" in msgs["batch"]
    assert "grad_allreduce" in msgs["allreduce"]
    assert "ranks" in msgs["world"] and "mesh_shape=(4,)" in msgs["world"]
    assert "row-shard" in msgs["rows"]


def test_world2_matches_jax_single_device_trainer(worlds):
    jplans, jhist = worlds["jax"]
    recs = worlds[2]["jax"]["recs"]
    for e, (r, p, h) in enumerate(zip(recs, jplans, jhist)):
        assert np.array_equal(r["order"], p.visible_indices), e
        assert np.array_equal(r["hidden"], np.sort(p.hidden_indices)), e
        assert np.array_equal(r["moveback"], p.moveback_indices), e
        assert r["loss"] == pytest.approx(h.train_loss, rel=1e-4), e
    assert len(recs[-1]["hidden"]) > 0


def test_straggler_world_is_dp_size(worlds):
    assert worlds[2]["straggler"] == (2, 3)
