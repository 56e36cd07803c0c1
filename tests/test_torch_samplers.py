"""PyTorch port, the low-level sampler API and the core helpers
(``repro_torch.core``'s ``ISWRSampler``, ``ForgetSampler``,
``InfoBatchSampler``, ``GradMatchSampler``, ``SelectiveBackprop``,
``histogram_threshold``, ``linear_scaling_rule``, ``with_hidden``,
``state_summary``, ``rng_state``/``set_rng_state`` and
``planops.restore_generator``).

- every case of the reference's ``tests/test_core_samplers.py`` and
  ``test_distributed_selection.py::test_infobatch_prunes_and_rescales``
  on the port's samplers;
- each sampler against the reference's on the same observations, the
  reference's random numbers injected through the sampler's ``draw_*``
  (threefry has no PyTorch counterpart): indices, masks, pruned sets,
  subsets and weights exactly; ISWR's probabilities within 1e-6 relative
  (ROADMAP C: a sum in another order) and its draws exactly;
- ``histogram_threshold`` bit for bit against the jnp one,
  ``state_summary``, ``with_hidden``, ``linear_scaling_rule`` and the
  numpy generator helpers against the reference's;
- ``restore_generator`` on a current and a legacy state dict: the legacy
  words are the reference's ``migrate_legacy_rng`` key, a restore is
  deterministic, an unreadable payload falls back to the seed
  convention, and a resumed run equals an unbroken one;
- the samplers with row-sharded state in a gloo world of 2 CPU ranks
  (``tests/torch_mesh_scenarios.py``, spawned once) equal to one process.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ForgetConfig as JForgetConfig
from repro.core import ForgetSampler as JForgetSampler
from repro.core import GradMatchConfig as JGradMatchConfig
from repro.core import GradMatchSampler as JGradMatchSampler
from repro.core import InfoBatchConfig as JInfoBatchConfig
from repro.core import InfoBatchSampler as JInfoBatchSampler
from repro.core import ISWRConfig as JISWRConfig
from repro.core import ISWRSampler as JISWRSampler
from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import KakurenboSampler as JKakurenboSampler
from repro.core import SBConfig as JSBConfig
from repro.core import SBStrategy as JSBStrategy
from repro.core import SelectiveBackprop as JSelectiveBackprop
from repro.core import planops as jplanops
from repro.core import state as jstate
from repro.core import strategy as jstrategy
from repro.core.schedule import linear_scaling_rule as jlinear_scaling_rule
from repro.core.selection import histogram_threshold as jhistogram_threshold
from repro_torch.core import (
    ForgetConfig, ForgetSampler, GradMatchConfig, GradMatchSampler,
    InfoBatchConfig, InfoBatchSampler, ISWRConfig, ISWRSampler,
    KakurenboConfig, KakurenboSampler, SBConfig, SelectiveBackprop,
    histogram_threshold, init_sample_state, linear_scaling_rule,
    make_strategy, planops, rng_state, scatter_observations, set_rng_state,
    state_summary, with_hidden,
)

import torch_mesh_scenarios as sc

CPU = dict(device="cpu")


def _observe_all(sampler, n, losses, pa, pc, epoch):
    sampler.observe(np.arange(n), torch.as_tensor(losses, dtype=torch.float32),
                    torch.as_tensor(pa), torch.as_tensor(pc,
                                                         dtype=torch.float32),
                    epoch)


# ---------------------------------------------------------------------------
# The reference's unit cases on the port's samplers


def test_kakurenbo_epoch_cycle():
    n = 200
    ks = KakurenboSampler(n, KakurenboConfig(
        max_fraction=0.3, fraction_milestones=(0, 5, 8, 10)), **CPU)
    plan0 = ks.begin_epoch(0)
    assert len(plan0.hidden_indices) == 0          # nothing observed yet
    losses = np.linspace(0, 1, n)
    _observe_all(ks, n, losses, np.ones(n, bool), np.full(n, 0.9), 0)
    plan1 = ks.begin_epoch(1)
    assert 0 < len(plan1.hidden_indices) <= int(0.3 * n)
    assert losses[plan1.hidden_indices].max() <= losses[
        plan1.visible_indices].min() + 1e-9
    assert len(plan1.visible_indices) + len(plan1.hidden_indices) == n
    np.testing.assert_allclose(plan1.lr_scale,
                               1.0 / (1.0 - plan1.hidden_fraction), rtol=1e-6)


def test_kakurenbo_moveback_blocks_low_confidence():
    n = 100
    ks = KakurenboSampler(n, KakurenboConfig(max_fraction=0.5, tau=0.7), **CPU)
    losses = np.linspace(0, 1, n)
    pc = np.where(np.arange(n) % 2 == 0, 0.9, 0.1)  # odd samples low-PC
    _observe_all(ks, n, losses, np.ones(n, bool), pc, 0)
    plan = ks.begin_epoch(1)
    assert np.all(plan.hidden_indices % 2 == 0)


def test_kakurenbo_component_toggles():
    n = 100
    cfg = KakurenboConfig(max_fraction=0.4, moveback=False, adjust_lr=False,
                          reduce_fraction=False)
    ks = KakurenboSampler(n, cfg, **CPU)
    losses = np.linspace(0, 1, n)
    _observe_all(ks, n, losses, np.zeros(n, bool), np.zeros(n), 0)
    plan = ks.begin_epoch(1)
    assert len(plan.hidden_indices) == 40
    assert plan.lr_scale == 1.0


def test_droptop_hides_highest_loss():
    n = 100
    ks = KakurenboSampler(n, KakurenboConfig(max_fraction=0.2,
                                             drop_top_fraction=0.05), **CPU)
    losses = np.linspace(0, 1, n)
    _observe_all(ks, n, losses, np.ones(n, bool), np.full(n, 0.99), 0)
    plan = ks.begin_epoch(1)
    assert {95, 96, 97, 98, 99} <= set(plan.hidden_indices.tolist())


def test_iswr_prefers_high_loss():
    n = 1000
    s = ISWRSampler(n, seed=0, **CPU)
    losses = np.zeros(n)
    losses[:100] = 10.0  # 100 high-loss samples
    _observe_all(s, n, losses, np.ones(n, bool), np.ones(n), 0)
    idx = s.begin_epoch(1)
    assert len(idx) == n  # with replacement, same epoch size
    assert np.mean(idx < 100) > 0.5  # 10% of samples get >50% of draws
    batches = list(s.batches(idx, 64))
    assert len(batches) == n // 64 and all(len(b) == 64 for b in batches)


def test_forget_prunes_unforgettable_and_restarts():
    n = 100
    s = ForgetSampler(n, ForgetConfig(fraction=0.3, warmup_epochs=2), **CPU)
    # samples 0..49: always correct (unforgettable); 50..99 flip each epoch
    for e in range(2):
        pa = np.ones(n, bool)
        pa[50:] = e % 2 == 0
        _observe_all(s, n, np.ones(n), pa, np.ones(n), e)
        s.begin_epoch(e)
    idx = s.begin_epoch(2)
    assert s.should_restart
    assert len(idx) == 70
    pruned = set(range(n)) - set(idx.tolist())
    assert all(i < 50 for i in pruned)  # only unforgettable samples pruned
    assert np.array_equal(np.flatnonzero(s.pruned_mask.numpy()),
                          sorted(pruned))
    s.begin_epoch(3)
    assert not s.should_restart


def test_selective_backprop_keeps_high_loss():
    sb = SelectiveBackprop(SBConfig(beta=1.0), seed=0, **CPU)
    r = np.random.default_rng(0)
    for _ in range(10):  # warm the history
        sb.select(r.random(64).astype(np.float32))
    low = sb.select(np.full(64, 0.001, np.float32))
    high = sb.select(np.full(64, 0.999, np.float32))
    assert low.dtype == np.float32 and set(np.unique(low)) <= {0.0, 1.0}
    assert high.mean() > low.mean()


def test_gradmatch_selects_subset_with_weights():
    n, c = 120, 3
    r = np.random.default_rng(0)
    labels = np.arange(n) % c
    feats = r.normal(size=(n, 8)).astype(np.float32)
    gm = GradMatchSampler(n, c, GradMatchConfig(fraction=0.5, interval=1),
                          **CPU)
    assert gm.maybe_reselect(0, feats, labels)
    assert len(gm.subset) <= int(0.5 * n) + c
    assert np.all(gm.weights >= 0)
    idx = gm.begin_epoch()
    assert set(idx.tolist()) == set(gm.subset.tolist())
    assert gm.omp_seconds > 0


def test_infobatch_prunes_and_rescales():
    n = 1000
    s = InfoBatchSampler(n, InfoBatchConfig(prune_ratio=0.5, anneal=0.9,
                                            total_epochs=10), seed=0, **CPU)
    losses = np.linspace(0, 2, n)  # mean = 1.0
    _observe_all(s, n, losses, np.ones(n, bool), np.ones(n), 0)
    idx, pruned = s.begin_epoch(1)
    np.testing.assert_array_equal(pruned, np.setdiff1d(np.arange(n), idx))
    assert len(pruned) > 0
    assert np.all(losses[pruned] < 1.0)          # only below-mean pruned
    kept_below = np.array([i for i in idx if losses[i] < 1.0])
    np.testing.assert_allclose(s.sample_weights(kept_below), 2.0)
    above = np.array([i for i in idx if losses[i] >= 1.0])
    np.testing.assert_allclose(s.sample_weights(above), 1.0)
    # annealing: final epochs train on everything
    idx9, pruned9 = s.begin_epoch(9)
    assert len(idx9) == n and len(pruned9) == 0


# ---------------------------------------------------------------------------
# Against the reference's samplers, the reference's draws injected


def _splits(name: str, count: int, seed: int = 0) -> list:
    """The reference sampler's per-call subkeys: one split of its
    ``strategy_key`` a call."""
    key, subs = jplanops.strategy_key(seed, name), []
    for _ in range(count):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _observations(n: int, epochs: int, b: int, seed: int = 3) -> list:
    """Per epoch a batch of ``b`` distinct ids with (loss, PA, PC)."""
    rng = np.random.default_rng(seed)
    return [(rng.permutation(n)[:b].astype(np.int32),
             rng.exponential(size=b).astype(np.float32),
             rng.random(b) < 0.7, rng.random(b).astype(np.float32))
            for _ in range(epochs)]


def _observe_both(js, ts, obs, epoch):
    idx, loss, pa, pc = obs
    js.observe(idx, jnp.asarray(loss), jnp.asarray(pa), jnp.asarray(pc),
               epoch)
    ts.observe(idx, _t(loss), _t(pa), _t(pc), epoch)


def test_iswr_sampler_matches_reference():
    n, epochs = 1000, 4
    js = JISWRSampler(n, JISWRConfig(unbiased=True), seed=0)
    ts = ISWRSampler(n, ISWRConfig(unbiased=True), seed=0, **CPU)
    us = iter([_t(jax.random.uniform(k, (n,))) for k in _splits("iswr",
                                                                  epochs)])
    ts.draw_uniform = lambda: next(us)
    for e, obs in enumerate(_observations(n, epochs, 600)):
        jidx, tidx = js.begin_epoch(e), ts.begin_epoch(e)
        assert tidx.dtype == np.int32 and np.array_equal(tidx, jidx), e
        np.testing.assert_allclose(ts.probs.numpy(), js._last_p, rtol=1e-6)
        np.testing.assert_allclose(ts.sample_weights(tidx),
                                   js.sample_weights(jidx), rtol=1e-5)
        _observe_both(js, ts, obs, e)


def test_forget_sampler_matches_reference():
    n, epochs = 300, 5
    js = JForgetSampler(n, JForgetConfig(0.3, 2), seed=0)
    ts = ForgetSampler(n, ForgetConfig(0.3, 2), seed=0, **CPU)
    perms = iter([_t(jax.random.permutation(k, n))
                  for k in _splits("forget", epochs)])
    ts.draw_permutation = lambda: next(perms)
    rng = np.random.default_rng(4)
    for e in range(epochs):
        jidx, tidx = js.begin_epoch(e), ts.begin_epoch(e)
        assert np.array_equal(tidx, jidx), e
        assert ts.should_restart == js.should_restart == (e == 2), e
        assert np.array_equal(ts.pruned_mask.numpy(),
                              np.asarray(js.pruned_mask)), e
        obs = (np.arange(n, dtype=np.int32), np.ones(n, np.float32),
               rng.random(n) < 0.6, np.ones(n, np.float32))
        _observe_both(js, ts, obs, e)
    assert int(ts.pruned_mask.sum()) == 90


def test_infobatch_sampler_matches_reference():
    n, epochs = 1000, 4
    cfg = dict(prune_ratio=0.5, anneal=0.75, total_epochs=epochs)
    js = JInfoBatchSampler(n, JInfoBatchConfig(**cfg), seed=0)
    ts = InfoBatchSampler(n, InfoBatchConfig(**cfg), seed=0, **CPU)
    pairs = [jax.random.split(k) for k in _splits("infobatch", epochs)]
    us = iter([_t(jax.random.uniform(p[0], (n,))) for p in pairs])
    perms = iter([_t(jax.random.permutation(p[1], n)) for p in pairs])
    ts.draw_uniform, ts.draw_permutation = (lambda: next(us),
                                            lambda: next(perms))
    for e, obs in enumerate(_observations(n, epochs, 800)):
        (jidx, jpr), (tidx, tpr) = js.begin_epoch(e), ts.begin_epoch(e)
        assert np.array_equal(tidx, jidx) and np.array_equal(tpr, jpr), e
        assert ts.weights.tobytes() == np.asarray(js.weights).tobytes(), e
        assert (len(tpr) > 0) == (0 < e < 3), e   # nothing seen; annealed
        _observe_both(js, ts, obs, e)


def test_gradmatch_sampler_matches_reference():
    n, c, epochs = 120, 3, 4
    r = np.random.default_rng(0)
    labels = np.arange(n) % c
    feats = r.normal(size=(n, 8)).astype(np.float32)
    js = JGradMatchSampler(n, c, JGradMatchConfig(fraction=0.5, interval=2),
                           seed=0)
    ts = GradMatchSampler(n, c, GradMatchConfig(fraction=0.5, interval=2),
                          seed=0, **CPU)
    subs = iter(_splits("gradmatch", epochs))
    ts.draw_permutation = lambda: _t(jplanops.device_permutation(
        next(subs), len(ts.subset)))
    for e in range(epochs):
        f = feats + np.float32(0.1 * e) * r.normal(size=feats.shape).astype(
            np.float32)
        assert ts.maybe_reselect(e, f, labels) == js.maybe_reselect(
            e, f, labels) == (e % 2 == 0)
        assert ts.subset.tobytes() == js.subset.tobytes(), e
        assert ts.weights.tobytes() == js.weights.tobytes(), e
        assert np.array_equal(ts.begin_epoch(), js.begin_epoch()), e
    assert _same(list(ts.batches(np.arange(10), 4)),
                 list(js.batches(np.arange(10), 4)))


def test_selective_backprop_matches_reference():
    cfg = dict(beta=1.0, history=256, floor=0.05, bootstrap=32)
    js = JSelectiveBackprop(JSBConfig(**cfg), seed=0)
    ts = SelectiveBackprop(SBConfig(**cfg), seed=0, **CPU)
    steps, b = 12, 64
    us = iter([_t(jax.random.uniform(k, (b,))) for k in _splits("sb", steps)])
    ts.draw_uniform = lambda b: next(us)
    r = np.random.default_rng(1)
    kept = []
    for _ in range(steps):
        loss = r.exponential(size=b).astype(np.float32)
        got, want = ts.select(loss), js.select(loss)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
        kept.append(got.mean())
    assert kept[0] == 1.0 and min(kept) < 1.0    # bootstrap, then selection
    st, jst = ts._state, js._state
    assert int(st["count"]) == int(jst["count"]) and int(st["ptr"]) == int(
        jst["ptr"])
    assert st["hist"].numpy().tobytes() == np.asarray(jst["hist"]).tobytes()


def test_kakurenbo_sampler_matches_reference():
    n, epochs = 500, 3
    cfg = dict(max_fraction=0.3, drop_top_fraction=0.02, tau=0.5)
    js = JKakurenboSampler(n, JKakurenboConfig(**cfg), seed=0)
    ts = KakurenboSampler(n, KakurenboConfig(**cfg), seed=0, **CPU)
    perms = iter([_t(jax.random.permutation(k, n))
                  for k in _splits("kakurenbo", epochs)])
    ts.draw_permutation = lambda: next(perms)
    for e, obs in enumerate(_observations(n, epochs, 400)):
        jp, tp = js.begin_epoch(e), ts.begin_epoch(e)
        for f in ("visible_indices", "hidden_indices", "moveback_indices"):
            assert np.array_equal(getattr(tp, f), getattr(jp, f)), (e, f)
        assert (tp.hidden_fraction, tp.lr_scale) == (jp.hidden_fraction,
                                                     jp.lr_scale), e
        _observe_both(js, ts, obs, e)


# ---------------------------------------------------------------------------
# The core helpers


@pytest.mark.parametrize("bins", [512, 64])
def test_histogram_threshold_matches_reference(bins):
    rng = np.random.default_rng(2)
    n = 1000
    loss = rng.exponential(size=n).astype(np.float32)
    valid = rng.random(n) < 0.7
    lo, hi = np.float32(loss[valid].min()), np.float32(loss[valid].max())
    cases = [(loss, valid, lo, hi),
             (np.full(n, 0.5, np.float32), valid, np.float32(0.5),
              np.float32(0.5)),                      # span clamped
             (loss, np.zeros(n, bool), lo, hi)]      # nothing valid
    for c, (x, v, a, b) in enumerate(cases):
        for num_hide in (0, 1, 300, int(v.sum()), 2 * n):
            want = jhistogram_threshold(jnp.asarray(x), jnp.asarray(v),
                                        jnp.int32(num_hide), jnp.float32(a),
                                        jnp.float32(b), bins)
            got = histogram_threshold(_t(x), _t(v), num_hide, float(a),
                                      float(b), bins)
            assert got.dtype == torch.float32
            assert np.float32(got).tobytes() == np.asarray(
                want, np.float32).tobytes(), (c, num_hide)


def test_state_summary_and_with_hidden_match_reference():
    n = 300
    rng = np.random.default_rng(5)
    idx = rng.permutation(n)[:200].astype(np.int32)
    loss = rng.exponential(size=200).astype(np.float32)
    pa, pc = rng.random(200) < 0.5, rng.random(200).astype(np.float32)
    hidden = rng.random(n) < 0.2
    jst = jstate.scatter_observations(jstate.init_sample_state(n), jnp.asarray(
        idx), jnp.asarray(loss), jnp.asarray(pa), jnp.asarray(pc), 2)
    jst = jstate.with_hidden(jst, jnp.asarray(hidden))
    st = scatter_observations(init_sample_state(n, "cpu"), idx, _t(loss),
                              _t(pa), _t(pc), 2)
    st2 = with_hidden(st, _t(hidden))
    assert st2 is not st and st2.loss is st.loss and not st.hidden.any()
    got, want = state_summary(st2), jstate.state_summary(jst)
    assert got.keys() == want.keys()
    for k in ("num_samples", "num_hidden", "num_seen"):
        assert got[k] == want[k] and isinstance(got[k], int), k
    assert (got["num_hidden"], got["num_seen"]) == (int(hidden.sum()), 200)
    assert got["mean_loss_seen"] == pytest.approx(want["mean_loss_seen"],
                                                  rel=1e-6)


def test_linear_scaling_rule_and_numpy_rng_helpers_match_reference():
    for lr, workers in ((0.1, 1), (0.1, 8), (0.0125, 256), (3e-4, 3)):
        assert linear_scaling_rule(lr, workers) == jlinear_scaling_rule(
            lr, workers)
    a, b = np.random.default_rng(11), np.random.default_rng(0)
    a.random(5)
    assert rng_state(a) == jstrategy.rng_state(a)
    set_rng_state(b, rng_state(a))
    assert np.array_equal(a.random(4), b.random(4))


# ---------------------------------------------------------------------------
# restore_generator: current and legacy state dicts


def _draws(gen, n: int = 8) -> torch.Tensor:
    return planops.uniform(gen, n)


def test_restore_generator_current_and_legacy():
    gen = planops.make_generator(0, "iswr", torch.device("cpu"))
    _draws(gen)
    current = {"arrays": {"rng_key": planops.generator_state(gen)},
               "host": {}}
    want = _draws(gen)
    for _ in range(2):
        g = planops.make_generator(9, "iswr", torch.device("cpu"))
        planops.restore_generator(g, current, 9, "iswr")
        assert torch.equal(_draws(g), want)
    # Legacy: a numpy generator state under host["rng"].  Its two words
    # are the reference's migrated key; the restore is deterministic.
    legacy_rng = np.random.default_rng(7)
    legacy_rng.random(3)
    legacy = {"arrays": {}, "host": {"rng": rng_state(legacy_rng)}}
    words = planops.legacy_words(legacy["host"]["rng"])
    jkey = jplanops.migrate_legacy_rng(legacy["host"]["rng"], 0, "iswr")
    assert words.tobytes() == np.asarray(jax.random.key_data(jkey),
                                         np.uint32).tobytes()
    got = []
    for seed in (0, 5):
        g = planops.make_generator(seed, "iswr", torch.device("cpu"))
        planops.restore_generator(g, legacy, seed, "iswr")
        got.append(_draws(g))
    assert torch.equal(got[0], got[1])
    g = torch.Generator().manual_seed((int(words[0]) << 32) | int(words[1]))
    assert torch.equal(got[0], _draws(g))
    # An unreadable payload: the seed convention.
    g = planops.make_generator(1, "forget", torch.device("cpu"))
    _draws(g)
    planops.restore_generator(g, {"host": {"rng": {"bogus": 1}}}, 3, "forget")
    fresh = planops.make_generator(3, "forget", torch.device("cpu"))
    assert torch.equal(_draws(g), _draws(fresh))
    with pytest.raises(ValueError, match="cannot restore"):
        planops.restore_generator(g, {"arrays": {}, "host": {}}, 3, "forget")


RESUME = ["iswr", "forget", "infobatch", "gradmatch", "kakurenbo", "random",
          "baseline", "sb"]


def _strategy(name: str, n: int, seed: int):
    cfg = {"forget": ForgetConfig(0.3, 1),
           "iswr": ISWRConfig(unbiased=True)}.get(name)
    return make_strategy(name, n, cfg, seed=seed, device="cpu",
                         num_classes=4, total_epochs=6)


def _epoch(s, e: int, n: int, rng) -> np.ndarray:
    """One epoch of ``s``: prepare (Grad-Match's features), plan, an
    observe or SB's selects; the plan's visible indices."""
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    labels = np.arange(n) % 4
    s.prepare(e, lambda: (feats, labels))
    plan = s.plan(e)
    idx = plan.visible_indices[:64]
    loss = torch.from_numpy(rng.exponential(size=len(idx)).astype(np.float32))
    if s.name == "sb":
        s.fused_select(s.get_device_state(), loss)
    else:
        s.observe(idx, loss, torch.from_numpy(rng.random(len(idx)) < 0.5),
                  torch.from_numpy(rng.random(len(idx)).astype(np.float32)),
                  e)
    return plan.visible_indices


@pytest.mark.parametrize("name", RESUME)
def test_resumed_run_equals_unbroken(name):
    """Two epochs, ``state_dict``, a strategy of another seed restored from
    it (through ``restore_generator``), two more epochs: the plans of the
    unbroken run.  A legacy dict of the same state (``host["rng"]`` in
    place of the generator's state) restores deterministically."""
    n = 256
    unbroken = _strategy(name, n, 0)
    rng = np.random.default_rng(0)
    want = [_epoch(unbroken, e, n, rng) for e in range(4)]
    first = _strategy(name, n, 0)
    rng = np.random.default_rng(0)
    got = [_epoch(first, e, n, rng) for e in range(2)]
    sd = first.state_dict()
    resumed = _strategy(name, n, 7)
    resumed.load_state_dict(sd)
    got += [_epoch(resumed, e, n, rng) for e in range(2, 4)]
    for e, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (name, e)
    legacy = {"arrays": {k: v for k, v in sd["arrays"].items()
                         if k != "rng_key"},
              "host": dict(sd["host"], rng=rng_state(
                  np.random.default_rng(2)))}
    plans = []
    for seed in (1, 2):
        s = _strategy(name, n, seed)
        if name == "random":
            legacy["arrays"]["inner_key"] = sd["arrays"]["inner_key"]
        s.load_state_dict(legacy)
        plans.append(s.plan(2).visible_indices)
    assert np.array_equal(plans[0], plans[1]), name


def test_selective_backprop_legacy_state_matches_reference():
    """SB's legacy format (a growing host history, numpy generator states):
    the ring buffer, count and write position as the reference migrates
    them, the draws' key the reference's migrated selection key."""
    hist = np.random.default_rng(3).exponential(size=40).astype(np.float32)
    host = {"rng": rng_state(np.random.default_rng(4)),
            "inner_rng": rng_state(np.random.default_rng(5))}
    legacy = {"arrays": {"hist": hist}, "host": host}
    cfg = dict(history=32)
    js = JSBStrategy(64, JSBConfig(**cfg), seed=0)
    js.load_state_dict(legacy)
    ts = make_strategy("sb", 64, SBConfig(**cfg), seed=0, device="cpu")
    ts.load_state_dict(legacy)
    sel, jsel = ts.get_device_state(), js.get_device_state()
    assert sel["hist"].numpy().tobytes() == np.asarray(
        jsel["hist"]).tobytes()
    assert (int(sel["count"]), int(sel["ptr"]), int(sel["draws"])) == (
        int(jsel["count"]), int(jsel["ptr"]), 0)
    assert np.array_equal(sel["key"].numpy().astype(np.uint32), np.asarray(
        jax.random.key_data(jsel["key"]), np.uint32))


# ---------------------------------------------------------------------------
# Row-sharded samplers: a gloo world of 2 against one process


@pytest.fixture(scope="module")
def sampler_worlds():
    rng = np.random.default_rng(6)
    n = sc.SAMPLER_N
    obs = [(rng.integers(0, n, 300).astype(np.int32),
            rng.exponential(size=300).astype(np.float32),
            rng.random(300) < 0.7, rng.random(300).astype(np.float32))
           for _ in range(3)]
    return sc.spawn_world(sc.sampler_world, 2, obs), sc.drive_samplers(
        None, obs)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return a == b


@pytest.mark.parametrize("name", ["iswr", "forget", "infobatch",
                                  "kakurenbo"])
def test_row_sharded_samplers_equal_one_process(sampler_worlds, name):
    """ISWR, FORGET, InfoBatch and KAKURENBO with their state row-sharded
    over 2 ranks: each epoch's plan (indices, weights, the whole prune
    mask) and the final summary equal one process's, on both ranks; a
    count the world does not divide is refused."""
    ranks, one = sampler_worlds
    for r in ranks:
        assert _same(r[name]["plans"], one[name]["plans"]), name
        assert r[name]["summary"] == one[name]["summary"], name
        assert "multiple of the data-parallel degree 2" in r["rows"]
    if name == "forget":
        assert one[name]["plans"][1][2] and one[name]["plans"][1][1].sum() \
            == int(0.3 * sc.SAMPLER_N)
