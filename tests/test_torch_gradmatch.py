"""PyTorch port, Grad-Match (the eighth strategy) and Table 3, against the
JAX package.

- ``_omp_select`` on the reference's features (``p - onehot(y)`` of the JAX
  CNN, as ``benchmarks/common.py::model_fns`` computes them), class by
  class, and a whole reselection: subsets and weights exactly equal to
  ``repro.core.gradmatch``'s;
- the plans over two reselections, with the reference's permutations
  injected: visible lists and batch weights exactly equal to the JAX
  strategy's;
- a 3-epoch trainer run against the JAX ``Trainer`` (from its initial
  params, with its permutations, the port computing its own features):
  plans exactly, losses within ``tests/test_torch_strategies.py``'s 1e-4
  relative;
- a restart after a reselection, bit-exact under both engines (the subset
  rides the checkpoint padded to N);
- the port's Table 3 harness on the CPU at a reduced N.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GradMatchConfig as JGradMatchConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import make_strategy as jmake_strategy
from repro.core import planops as jplanops
from repro.core.gradmatch import GradMatchSampler
from repro.core.gradmatch import _omp_select as j_omp_select
from repro.data import SyntheticClassification as JSynthetic
from repro.models import cnn as jcnn
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import GradMatchConfig, LRSchedule, make_strategy
from repro_torch.core.gradmatch import _omp_select, reselect
from repro_torch.data import SyntheticClassification
from repro_torch.experiments import table2, table3
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig

SMALL = dict(image_size=8, widths=(8, 16), hidden=32)
N, BATCH, EPOCHS = 256, 32, 3


def _jfeats(params, cfg, batch):
    """``benchmarks/common.py::model_fns``' ``feats_fn``."""
    logits = jcnn.forward(params, cfg, batch["images"])
    p = jnp.exp(logits - jnp.max(logits, -1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return p - jnp.eye(cfg.num_classes)[batch["labels"]]


def _reference_features(n=N, seed=0):
    cfg = jcnn.CNNConfig(**SMALL)
    params = jcnn.init(jax.random.key(seed), cfg)
    ds = JSynthetic(num_samples=n, image_size=8, seed=0)
    batch = ds.get(np.arange(n))
    return np.asarray(_jfeats(params, cfg, batch)), batch["labels"], params


def test_omp_select_and_reselect_match_reference():
    feats, labels, _ = _reference_features()
    assert feats.dtype == np.float32
    for c in range(10):
        cls = np.nonzero(labels == c)[0]
        for budget in (1, int(round(0.7 * len(cls))), len(cls) + 3):
            sel, w = _omp_select(feats[cls], budget, 0.5)
            jsel, jw = j_omp_select(feats[cls], budget, 0.5)
            assert sel.dtype == jsel.dtype and w.dtype == jw.dtype
            assert sel.tobytes() == jsel.tobytes(), (c, budget)
            assert w.tobytes() == jw.tobytes(), (c, budget)
    for frac, lam in ((0.3, 0.5), (0.5, 0.1)):
        sampler = GradMatchSampler(N, 10, JGradMatchConfig(fraction=frac,
                                                           lam=lam))
        assert sampler.maybe_reselect(0, feats, labels)
        subset, weights = reselect(feats, labels, 10,
                                   GradMatchConfig(fraction=frac, lam=lam))
        assert subset.tobytes() == sampler.subset.tobytes()
        assert weights.tobytes() == sampler.weights.tobytes()
        assert abs(len(subset) - (1 - frac) * N) <= 10


def _inject_permutations(strategy, seed=0):
    """The reference's epoch shuffles: one split of the gradmatch key an
    epoch, a permutation of the subset's length."""
    key = {"k": jplanops.strategy_key(seed, "gradmatch")}

    def draw():
        key["k"], sub = jax.random.split(key["k"])
        n = len(strategy.subset)
        return torch.from_numpy(np.array(jplanops.device_permutation(sub, n)))

    strategy.draw_permutation = draw


def test_plans_match_reference_strategy():
    feats, labels, _ = _reference_features()
    jcfg, cfg = JGradMatchConfig(interval=2), GradMatchConfig(interval=2)
    js = jmake_strategy("gradmatch", N, cfg=jcfg, seed=0, num_classes=10)
    ts = make_strategy("gradmatch", N, cfg=cfg, seed=0, num_classes=10,
                       device="cpu")
    _inject_permutations(ts)
    r = np.random.default_rng(0)
    for epoch in range(5):
        # new features at each reselection (epochs 0, 2, 4)
        f = feats + np.float32(0.01 * epoch) * r.normal(
            size=feats.shape).astype(np.float32)
        js.prepare(epoch, lambda: (f, labels))
        ts.prepare(epoch, lambda: (f, labels))
        jp, tp = js.plan(epoch), ts.plan(epoch)
        assert np.array_equal(tp.visible_indices, jp.visible_indices), epoch
        assert tp.host_syncs == jp.host_syncs == 1
        assert np.array_equal(ts.batch_weights(np.arange(N)),
                              js.batch_weights(np.arange(N))), epoch
    assert len(tp.visible_indices) < N


def _configs(epochs=EPOCHS):
    return dict(epochs=epochs, batch_size=BATCH, strategy="gradmatch",
                fused_scoring=True, seed=0)


def test_trainer_matches_jax_trainer():
    jcfg = jcnn.CNNConfig(**SMALL)
    jtr = JTrainer(
        JTrainConfig(lr=JLRSchedule(0.1, "cosine", EPOCHS, 1), **_configs()),
        lambda rng: jcnn.init(rng, jcfg), None,
        JSynthetic(num_samples=N, image_size=8, seed=0), num_classes=10,
        feats_fn=lambda p, b: _jfeats(p, jcfg, b),
        logits_fn=lambda p, b: jcnn.forward(p, jcfg, b["images"]))
    init = {k: np.array(v) for k, v in jtr.params.items()}
    jplans, plan = [], jtr.strategy.plan
    jtr.strategy.plan = lambda e: (lambda p: jplans.append(p) or p)(plan(e))
    jhist = jtr.run()

    model = cnn.CNN(cnn.CNNConfig(**SMALL))
    model.load_state_dict(cnn.params_from_jax(init, model.cfg))
    tr = Trainer(TrainConfig(lr=LRSchedule(0.1, "cosine", EPOCHS, 1),
                             **_configs()),
                 model, None,
                 SyntheticClassification(num_samples=N, image_size=8, seed=0),
                 logits_fn=lambda m, b: m(b["images"]), device="cpu",
                 num_classes=10, feats_fn=table2.feats_fn)
    _inject_permutations(tr.strategy)
    tplans, plan = [], tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: tplans.append(p) or p)(plan(e))
    thist = tr.run()
    for e, (h, j, tp, jp) in enumerate(zip(thist, jhist, tplans, jplans)):
        assert np.array_equal(tp.visible_indices, jp.visible_indices), e
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples,
                                                  j.bwd_samples), e
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4), e
    assert len(tplans[0].visible_indices) < N
    assert tr.strategy.omp_seconds > 0


def _trainer(engine, seed=0, ckpt_dir=None, epochs=4):
    ds = SyntheticClassification(num_samples=N, image_size=8, seed=0)
    tc = TrainConfig(lr=LRSchedule(0.1, "cosine", epochs, 1), engine=engine,
                     scan_steps=3, gradmatch=GradMatchConfig(interval=2),
                     checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
                     checkpoint_every=1 if ckpt_dir else 0,
                     **dict(_configs(epochs), seed=seed))
    model = cnn.CNN(cnn.CNNConfig(**SMALL), torch.Generator().manual_seed(seed))
    return Trainer(tc, model, None, ds, logits_fn=lambda m, b: m(b["images"]),
                   device="cpu", num_classes=10, feats_fn=table2.feats_fn)


@pytest.mark.parametrize("engine", ["scan", "host"])
def test_restart_after_reselection_bit_exact(engine, tmp_path):
    ref = _trainer(engine)
    ref.run()
    crashed = _trainer(engine, ckpt_dir=tmp_path)
    with pytest.raises(RuntimeError, match="injected"):
        crashed.run(fail_at_epoch=3)
    assert len(crashed.strategy.subset) < N      # reselected at epoch 2
    tr = _trainer(engine, seed=9, ckpt_dir=tmp_path)
    assert tr.restore_latest() and tr.epoch == 3
    assert np.array_equal(tr.strategy.subset, crashed.strategy.subset)
    tr.run()
    a = {p: ckpt.to_numpy(v) for p, v in ckpt.flatten(ref._ckpt_tree())}
    b = {p: ckpt.to_numpy(v) for p, v in ckpt.flatten(tr._ckpt_tree())}
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert tr.history[-1].train_loss == ref.history[-1].train_loss


def test_table3_harness_on_cpu(capsys):
    small = cnn.CNNConfig(**SMALL)
    # N = 512: the 0.7 N subset then fills fewer batches of 128 than N
    rows = table3.run_table(model_cfg=small, n=512, n_test=64, epochs=3,
                            device="cpu")
    assert [name for name, _ in rows] == [
        "table3/baseline", "table3/gradmatch-0.3", "table3/kakurenbo-0.3"]
    res = dict(rows)
    base, gm = res["table3/baseline"], res["table3/gradmatch-0.3"]
    assert gm["omp_s"] > 0 and base["omp_s"] == 0
    assert gm["bwd"] < base["bwd"]
    subset = len(gm["trainer"].strategy.subset)
    assert gm["fwd"] == 3 * -(-subset // table2.BATCH) * table2.BATCH
    table3.main(["--device", "cpu", "--n", "256", "--n-test", "64",
                 "--epochs", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(",")[0] for ln in lines] == [n for n, _ in rows]
    assert all("omp_s=" in ln and "time_vs_base=" in ln for ln in lines)
