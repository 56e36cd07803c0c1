"""PyTorch port, the paper's baselines against the JAX package.

- the sampling ops (``importance_probs``, ``with_replacement``,
  ``weighted_keep``) and Selective-Backprop's ``select_step``, given the
  reference's random draws: integer and bool results exactly; float results
  within 1e-6 relative, because the reference's sums and cumulative sums
  (XLA on the CPU) add in another order than PyTorch's;
- each new strategy end to end: a 3-epoch run of the JAX ``Trainer`` and of
  the port's, on the small CNN at N = 256, from the JAX trainer's initial
  params (``params_from_jax``) and with the reference's draws (permutations
  and uniforms from ``strategy_key`` splits, as the JAX strategies make
  them) handed to the port's ``draw_*`` methods.  Per-epoch train loss
  within 1e-4 relative; the per-epoch visible and hidden (or pruned) sets,
  ``fwd_samples``, ``bwd_samples`` and FORGET's restart epoch equal.  Two
  ways of scoring: the fused pass on both sides, and Table 2's default
  (``repro_torch.experiments.table2.make_trainer``, PA by argmax) against
  the JAX ``Trainer`` built as ``benchmarks/common.py::run_strategy`` builds
  it.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ForgetConfig as JForgetConfig
from repro.core import ISWRConfig as JISWRConfig
from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import make_strategy as jmake_strategy
from repro.core import planops as jplanops
from repro.core import selective_backprop as jsb
from repro.core import state as jstate
from repro.data import SyntheticClassification as JSynthetic
from repro.models import cnn as jcnn
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.core import (ForgetConfig, ISWRConfig, KakurenboConfig,
                              LRSchedule, make_strategy, planops)
from repro_torch.core import selective_backprop as sb
from repro_torch.core import state
from repro_torch.core.baseline import randomize_importance
from repro_torch.data import SyntheticClassification
from repro_torch.experiments import table2
from repro_torch.models import cnn
from repro_torch.train import TrainConfig, Trainer

REL = 1e-6


def _loss_valid(n, seed):
    r = np.random.default_rng(seed)
    loss = r.exponential(1.0, n).astype(np.float32)
    loss[r.random(n) < 0.02] = np.inf          # non-finite counts as unseen
    return loss, r.random(n) < 0.8


@pytest.mark.parametrize("n,seed", [(256, 0), (1000, 1), (4096, 2)])
def test_importance_probs_and_with_replacement(n, seed):
    loss, valid = _loss_valid(n, seed)
    pj = np.asarray(jplanops.importance_probs(jnp.asarray(loss),
                                              jnp.asarray(valid), 1e-3))
    pt = planops.importance_probs(torch.from_numpy(loss),
                                  torch.from_numpy(valid), 1e-3).numpy()
    np.testing.assert_allclose(pt, pj, rtol=REL, atol=0)
    key = jax.random.key(seed)
    want = np.asarray(jplanops.with_replacement(key, jnp.asarray(pj)))
    u = np.array(jax.random.uniform(key, (n,), jnp.float32))
    got = planops.with_replacement(torch.from_numpy(pj.copy()),
                                   torch.from_numpy(u))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # nothing seen yet: uniform probabilities
    p0 = planops.importance_probs(torch.ones(8), torch.zeros(8, dtype=torch.bool),
                                  1e-3)
    assert torch.equal(p0, torch.full((8,), 0.125))


@pytest.mark.parametrize("n,ratio", [(256, 0.5), (3000, 0.3), (100, 0.9)])
def test_weighted_keep(n, ratio):
    loss, valid = _loss_valid(n, n)
    key = jax.random.key(n)
    prune, w = jplanops.weighted_keep(key, jnp.asarray(loss), jnp.asarray(valid),
                                      ratio)
    u = np.array(jax.random.uniform(key, (n,)))
    prune_t, w_t = planops.weighted_keep(torch.from_numpy(loss),
                                         torch.from_numpy(valid), ratio,
                                         torch.from_numpy(u))
    assert np.array_equal(prune_t.numpy(), np.asarray(prune))
    assert w_t.dtype == torch.float32
    assert np.array_equal(w_t.numpy(), np.asarray(w))
    assert prune_t.any() and not (prune_t.numpy() & ~valid).any()


def test_select_step_matches_reference():
    """Ten steps of the ring buffer (history 64, batches of 16): bootstrap,
    wrap-around, the floor; weights and the buffer exact."""
    cfg = sb.SBConfig(history=64, bootstrap=20, floor=0.1)
    key = jax.random.key(3)
    js = jsb.init_select_state(jsb.SBConfig(history=64, bootstrap=20,
                                            floor=0.1), key)
    ts = sb.init_select_state(cfg, torch.device("cpu"))
    r = np.random.default_rng(4)
    kw = dict(beta=cfg.beta, floor=cfg.floor, bootstrap=cfg.bootstrap)
    kept = []
    for _ in range(10):
        loss = r.exponential(1.0, 16).astype(np.float32)
        _, sub = jax.random.split(js["key"])
        u = np.array(jax.random.uniform(sub, (16,)))
        wj, js = jsb.select_step(js, jnp.asarray(loss), **kw)
        wt, ts = sb.select_step(ts, torch.from_numpy(loss), torch.from_numpy(u),
                                **kw)
        assert np.array_equal(wt.numpy(), np.asarray(wj))
        for k in ("hist", "count", "ptr"):
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k])), k
        kept.append(int((wt > 0).sum()))
    assert kept[0] == 16 and min(kept) < 16


def test_scatter_with_repeats_then_prune_matches_reference():
    """A with-replacement epoch (repeats in every batch) scattered into the
    state, then FORGET's prune on the resulting event counts."""
    from repro.core.forget import _prune_step as jprune
    from repro_torch.core.forget import _prune_step
    n = 300
    js, ts = jstate.init_sample_state(n), state.init_sample_state(n, "cpu")
    r = np.random.default_rng(5)
    for epoch in range(6):
        idx = r.integers(0, n, 512)
        loss = r.exponential(1.0, 512).astype(np.float32)
        pa = r.random(512) < 0.6
        pc = r.random(512).astype(np.float32)
        js = jstate.scatter_observations(js, jnp.asarray(idx), jnp.asarray(loss),
                                         jnp.asarray(pa), jnp.asarray(pc), epoch)
        ts = state.scatter_observations(ts, idx, torch.from_numpy(loss),
                                        torch.from_numpy(pa),
                                        torch.from_numpy(pc), epoch)
    for f in ("loss", "pa", "pc", "seen", "forget_events", "prev_correct"):
        assert np.array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))), f
    for k in (0, 90, n):
        want = np.asarray(jprune(js, jnp.int32(k)))
        assert np.array_equal(_prune_step(ts, k).numpy(), want)


def test_randomize_importance_and_registry_extras():
    st = state.init_sample_state(5, "cpu")
    st.hidden[2] = True
    u = torch.rand(5)
    out = randomize_importance(st, u)
    assert torch.equal(out.loss, u) and out.pa.all() and (out.seen == 0).all()
    assert out.hidden[2] and torch.equal(out.forget_events, st.forget_events)
    ib = make_strategy("infobatch", 10, seed=0, total_epochs=7, device="cpu")
    assert ib.config.total_epochs == 7


# ---------------------------------------------------------------------------
# End to end against the JAX trainer
# ---------------------------------------------------------------------------

N, BATCH, EPOCHS = 256, 32, 3
SMALL = dict(image_size=8, widths=(8, 16), hidden=32)


def _splits(name, count):
    """The per-epoch subkeys a JAX strategy splits off its key."""
    key, subs = jplanops.strategy_key(0, name), []
    for _ in range(count):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _perms(name):
    return [torch.from_numpy(np.array(jax.random.permutation(s, N)))
            for s in _splits(name, EPOCHS)]


def _uniforms(name, size=N, count=EPOCHS):
    return [torch.from_numpy(np.array(jax.random.uniform(s, (size,))))
            for s in _splits(name, count)]


def _inject(strategy, tr, batch=BATCH):
    """Hand the reference's draws to the port's ``draw_*`` methods."""
    s = tr.strategy
    if strategy == "baseline":
        it = iter(_perms("baseline"))
        s.draw_permutation = lambda: next(it)
    if strategy in ("kakurenbo", "random"):
        it = iter(_perms("kakurenbo"))
        s._inner.draw_permutation = lambda: next(it)
    if strategy == "random":
        ur = iter(_uniforms("random"))
        s.draw_uniform = lambda: next(ur)
    if strategy == "forget":
        it = iter(_perms("forget"))
        s.draw_permutation = lambda: next(it)
    if strategy == "iswr":
        ui = iter(_uniforms("iswr"))
        s.draw_uniform = lambda: next(ui)
    if strategy == "infobatch":
        pairs = [jax.random.split(sub) for sub in _splits("infobatch", EPOCHS)]
        ub = iter(torch.from_numpy(np.array(jax.random.uniform(p[0], (N,))))
                  for p in pairs)
        pb = iter(torch.from_numpy(np.array(jax.random.permutation(p[1], N)))
                  for p in pairs)
        s.draw_uniform = lambda: next(ub)
        s.draw_permutation = lambda: next(pb)
    if strategy == "sb":
        it = iter(_perms("sb-plan"))
        s.draw_permutation = lambda: next(it)
        us = iter(_uniforms("sb", batch, EPOCHS * (N // batch)))
        s.draw_uniform = lambda b: next(us)


def _record_plans(tr):
    plans = []
    plan = tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return plans


#: case -> KAKURENBO overrides; the case's strategy is its name up to "-".
CASES = {
    "forget": {},
    "iswr": {},
    "iswr-unbiased": {},        # 1/(N p) loss weights through batch_weights
    "sb": {},
    "random": {},
    "infobatch": {},
    "kakurenbo": dict(selection="sort", drop_top_fraction=0.05, tau=0.2),
}


def _configs(strategy, kcfg, forget_cfg, iswr_cfg):
    return dict(epochs=EPOCHS, batch_size=BATCH, strategy=strategy,
                fused_scoring=True, kakurenbo=kcfg, forget=forget_cfg,
                iswr=iswr_cfg, seed=0)


@pytest.mark.parametrize("case", list(CASES))
def test_strategy_end_to_end_matches_jax_trainer(case):
    strategy, unbiased = case.split("-")[0], case.endswith("-unbiased")
    kk = dict(max_fraction=0.3, **CASES[case])
    jcfg = jcnn.CNNConfig(**SMALL)
    jtr = JTrainer(
        JTrainConfig(lr=JLRSchedule(0.1, "cosine", EPOCHS, 1),
                     **_configs(strategy, JKakurenboConfig(**kk),
                                JForgetConfig(0.3, 2),
                                JISWRConfig(unbiased=unbiased))),
        lambda rng: jcnn.init(rng, jcfg), None,
        JSynthetic(num_samples=N, image_size=8, seed=0),
        logits_fn=lambda p, b: jcnn.forward(p, jcfg, b["images"]))
    init = {k: np.array(v) for k, v in jtr.params.items()}
    jplans = _record_plans(jtr)
    jhist = jtr.run()

    tcfg = cnn.CNNConfig(**SMALL)
    model = cnn.CNN(tcfg)
    model.load_state_dict(cnn.params_from_jax(init, tcfg))
    tr = Trainer(
        TrainConfig(lr=LRSchedule(0.1, "cosine", EPOCHS, 1),
                    **_configs(strategy, KakurenboConfig(**kk),
                               ForgetConfig(0.3, 2),
                               ISWRConfig(unbiased=unbiased))),
        model, None, SyntheticClassification(num_samples=N, image_size=8, seed=0),
        logits_fn=lambda m, b: m(b["images"]), device="cpu")
    _inject(strategy, tr)
    tplans = _record_plans(tr)
    thist = tr.run()

    for e, (h, j, tp, jp) in enumerate(zip(thist, jhist, tplans, jplans)):
        assert np.array_equal(tp.visible_indices, jp.visible_indices), e
        assert np.array_equal(tp.hidden_indices, jp.hidden_indices), e
        assert tp.reinit_model == jp.reinit_model, e
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples), e
        assert h.hidden_fraction == j.hidden_fraction, e
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4), e
    # each case exercises what makes its strategy differ from the baseline
    if strategy == "forget":
        assert [p.reinit_model for p in tplans] == [False, False, True]
        assert len(tplans[2].visible_indices) == N - int(0.3 * N)
    elif strategy == "iswr":
        rows = [tplans[e].visible_indices[i:i + BATCH]
                for e in range(EPOCHS) for i in range(0, N, BATCH)]
        assert any(len(np.unique(r)) < BATCH for r in rows)
        w = tr.strategy.batch_weights(np.arange(N))
        assert np.ptp(w) > 0.1 if unbiased else (w == 1).all()
    elif strategy == "sb":
        assert sum(h.bwd_samples for h in thist) < sum(h.fwd_samples
                                                       for h in thist)
    else:
        assert any(len(p.hidden_indices) for p in tplans[1:])


def _same_history(thist, jhist, tplans, jplans):
    for e, (h, j, tp, jp) in enumerate(zip(thist, jhist, tplans, jplans)):
        assert np.array_equal(tp.visible_indices, jp.visible_indices), e
        assert np.array_equal(tp.hidden_indices, jp.hidden_indices), e
        assert tp.reinit_model == jp.reinit_model, e
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples), e
        assert h.hidden_fraction == j.hidden_fraction, e
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4), e
        assert h.test_acc == j.test_acc, e


@pytest.mark.parametrize("fused", [False, True])
def test_table2_scoring_keyword(fused):
    """PA on a tied maximum: argmax (the default, the reference harness's)
    takes the first class; the fused pass counts any gold >= max."""
    tr = table2.make_trainer("baseline", model_cfg=cnn.CNNConfig(**SMALL), n=8,
                             n_test=8, epochs=1, fused_scoring=fused,
                             device="cpu")
    assert tr.cfg.fused_scoring is fused
    with torch.no_grad():
        for p in tr.model.parameters():
            p.zero_()
    batch = {"images": torch.zeros(2, 8, 8, 3),
             "labels": torch.tensor([0, 3], dtype=torch.int32)}
    _, (loss, pa, _) = tr.loss_fn(tr.model, batch)
    assert torch.allclose(loss, torch.full((2,), float(np.log(10))))
    assert pa.tolist() == ([True, True] if fused else [True, False])


@pytest.mark.parametrize("strategy", table2.STRATEGIES)
def test_table2_default_scoring_matches_reference_harness(strategy):
    """Table 2 scores as ``benchmarks/common.py`` does: PA by argmax from
    ``cnn.per_sample_metrics`` (not the fused pass), the weighted mean CE."""
    n_test, batch = 128, table2.BATCH
    jcfg = jcnn.CNNConfig(**SMALL)

    def jloss_fn(params, b):
        logits = jcnn.forward(params, jcfg, b["images"])
        loss, pa, pc = jcnn.per_sample_metrics(logits, b["labels"])
        w = b.get("weight")
        return (jnp.mean(loss * w) if w is not None else jnp.mean(loss)), (loss, pa, pc)

    tc = JTrainConfig(
        epochs=EPOCHS, batch_size=batch, strategy=strategy,
        lr=JLRSchedule(0.03, "cosine", EPOCHS, 1),
        kakurenbo=JKakurenboConfig(max_fraction=0.3,
                                   fraction_milestones=(0, EPOCHS // 3,
                                                        EPOCHS // 2,
                                                        3 * EPOCHS // 4)),
        forget=JForgetConfig(fraction=0.3, warmup_epochs=max(EPOCHS // 4, 2)),
        seed=0)
    assert not tc.fused_scoring
    ds = JSynthetic(num_samples=N, image_size=8, seed=0)
    jtr = JTrainer(tc, lambda rng: jcnn.init(rng, jcfg), jloss_fn, ds,
                   ds.test_split(n_test),
                   strategy=jmake_strategy(strategy, N, cfg=tc, seed=0,
                                           num_classes=10, total_epochs=EPOCHS))
    init = {k: np.array(v) for k, v in jtr.params.items()}
    jplans = _record_plans(jtr)
    jhist = jtr.run()

    tr = table2.make_trainer(strategy, model_cfg=cnn.CNNConfig(**SMALL), n=N,
                             n_test=n_test, epochs=EPOCHS, device="cpu")
    assert not tr.cfg.fused_scoring
    tr.model.load_state_dict(cnn.params_from_jax(init, tr.model.cfg))
    tr._init_weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
    _inject(strategy, tr, batch)
    tplans = _record_plans(tr)
    _same_history(tr.run(), jhist, tplans, jplans)
