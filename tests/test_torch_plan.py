"""PyTorch port, epoch plan: state, schedules, selection and ``_plan_step``.

The same ``SampleState`` (made from a seed with numpy) and the reference's
permutation go through the JAX plan and the port's; every output must be
exactly equal — masks, order, counts, F* and the Eq. 8 factor — for the
three selection methods, with never-seen samples, tied losses, DropTop and
N not a multiple of the kernels' 2048 block.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planops as jplanops
from repro.core import schedule as jschedule
from repro.core import state as jstate
from repro.core.kakurenbo import _plan_step as jplan_step
from repro_torch.core import planops, schedule, state
from repro_torch.core.kakurenbo import KakurenboConfig, KakurenboSampler, _plan_step
from repro_torch.core.selection import select_hidden

FIELDS = ("loss", "pa", "pc", "hidden", "seen", "forget_events", "prev_correct")


def _np_state(n, seed=0, ties=False, unseen=0.1):
    r = np.random.default_rng(seed)
    seen = r.random(n) >= unseen
    loss = r.exponential(1.0, n)
    if ties:
        loss = np.round(loss, 1)
    return {"loss": np.where(seen, loss, 1e9).astype(np.float32),
            "pa": r.random(n) < 0.7,
            "pc": r.random(n).astype(np.float32),
            "hidden": r.random(n) < 0.2,
            "seen": np.where(seen, r.integers(0, 5, n), -1).astype(np.int32),
            "forget_events": r.integers(0, 3, n).astype(np.int32),
            "prev_correct": r.random(n) < 0.5}


def _perm_of(key, n):
    return np.array(jax.random.permutation(key, n))


def _jax_state(d):
    return jstate.SampleState(**{k: jnp.asarray(d[k]) for k in FIELDS})


def _torch_state(d):
    return state.SampleState(**{k: torch.from_numpy(d[k].copy()) for k in FIELDS})


def _assert_state_equal(ts, js):
    for k in FIELDS:
        assert np.array_equal(getattr(ts, k).numpy(),
                              np.asarray(getattr(js, k))), k


def test_init_sample_state_matches():
    _assert_state_equal(state.init_sample_state(100, "cpu"),
                        jstate.init_sample_state(100))


def test_scatter_observations_exact():
    d = _np_state(64, seed=1)
    ts, js = _torch_state(d), _jax_state(d)
    r = np.random.default_rng(2)
    for epoch in (3, 4):
        idx = r.permutation(64)[:16]
        loss = r.exponential(1.0, 16).astype(np.float32)
        pa = r.random(16) < 0.5
        pc = r.random(16).astype(np.float32)
        js = jstate.scatter_observations(js, jnp.asarray(idx), jnp.asarray(loss),
                                         jnp.asarray(pa), jnp.asarray(pc), epoch)
        ts = state.scatter_observations(ts, idx, torch.from_numpy(loss),
                                        torch.from_numpy(pa),
                                        torch.from_numpy(pc), epoch)
        _assert_state_equal(ts, js)
    # a tensor of indices takes the same path
    ts = state.scatter_observations(ts, torch.tensor([1, 2]), torch.ones(2),
                                    torch.ones(2, dtype=torch.bool),
                                    torch.ones(2), 9)
    assert ts.seen[1] == ts.seen[2] == 9


def test_scatter_observations_rejects_duplicates():
    """Repeated indices (ISWR's with-replacement batches) are accepted with
    the reference's meaning: the last occurrence wins, every occurrence
    counts its forgetting event.  Exact against the JAX function."""
    d = _np_state(40, seed=3)
    ts, js = _torch_state(d), _jax_state(d)
    r = np.random.default_rng(4)
    for epoch, idx in ((1, np.array([3, 3, 7, 3, 7, 9])),
                       (2, r.integers(0, 40, 64))):
        b = len(idx)
        loss = r.exponential(1.0, b).astype(np.float32)
        pa = r.random(b) < 0.5
        pc = r.random(b).astype(np.float32)
        js = jstate.scatter_observations(js, jnp.asarray(idx), jnp.asarray(loss),
                                         jnp.asarray(pa), jnp.asarray(pc), epoch)
        ts = state.scatter_observations(ts, torch.from_numpy(idx),
                                        torch.from_numpy(loss),
                                        torch.from_numpy(pa),
                                        torch.from_numpy(pc), epoch)
        _assert_state_equal(ts, js)
    assert np.array_equal(state.last_occurrence(torch.tensor([5, 2, 5, 5, 2, 8])),
                          [3, 4, 3, 3, 4, 5])


def test_schedules_match_reference():
    fs = jschedule.FractionSchedule(0.3, (1.0, 0.8, 0.6, 0.4), (0, 3, 6, 9))
    fs_t = schedule.FractionSchedule(0.3, (1.0, 0.8, 0.6, 0.4), (0, 3, 6, 9))
    for e in range(12):
        assert float(fs_t(e)) == float(fs(e)), e
    for kind in ("step", "constant"):
        lr = jschedule.LRSchedule(0.05, kind, 10, 2, 0.1, (3, 6))
        lr_t = schedule.LRSchedule(0.05, kind, 10, 2, 0.1, (3, 6))
        for e in range(12):
            assert float(lr_t(e)) == float(lr(e)), (kind, e)
    # torch.cos and XLA's cos differ by a few ulp: the LR agrees to 2e-7 of
    # the base LR (relative to the LR itself the gap grows where 1 + cos ~ 0).
    for total, warmup in ((10, 2), (90, 5)):
        lr = jschedule.LRSchedule(0.05, "cosine", total, warmup)
        lr_t = schedule.LRSchedule(0.05, "cosine", total, warmup)
        for e in range(total + 2):
            assert abs(float(lr_t(e)) - float(lr(e))) <= 2e-7 * 0.05, e
    for f in (0.0, 0.1, 0.2999, 0.5, 0.96, 1.0):
        assert float(schedule.kakurenbo_lr(torch.tensor(1.0), torch.tensor(f))) \
            == float(jschedule.kakurenbo_lr(jnp.float32(1.0), jnp.float32(f)))


@pytest.mark.parametrize("method,drop_top", [
    ("sort", 0.0), ("histogram", 0.0), ("histogram_pallas", 0.0),
    ("sort", 0.05), ("histogram", 0.05), ("histogram_pallas", 0.05)])
@pytest.mark.parametrize("n,ties", [(3000, False), (2048, True), (777, True)])
def test_plan_step_exact(method, drop_top, n, ties):
    d = _np_state(n, seed=n, ties=ties)
    key = jax.random.key(n + 1)
    perm = _perm_of(key, n)
    kw = dict(method=method, tau=0.5, drop_top=drop_top, moveback=True,
              adjust_lr=True)
    want = jplan_step(_jax_state(d), key, jnp.float32(0.3), **kw)
    got = _plan_step(_torch_state(d), torch.from_numpy(perm), 0.3, **kw)
    names = ("hidden", "moved_back", "order", "num_hidden", "f_star", "lr_scale")
    for name, g, w in zip(names, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert int(got[3]) > 0


@pytest.mark.parametrize("moveback,adjust_lr", [(False, True), (True, False)])
def test_plan_step_components(moveback, adjust_lr):
    d = _np_state(1500, seed=7, unseen=0.0)
    key = jax.random.key(8)
    kw = dict(method="histogram", tau=0.7, drop_top=0.0, moveback=moveback,
              adjust_lr=adjust_lr)
    want = jplan_step(_jax_state(d), key, jnp.float32(0.24), **kw)
    got = _plan_step(_torch_state(d), torch.from_numpy(_perm_of(key, 1500)),
                     0.24, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_plan_step_all_unseen_hides_nothing():
    d = _np_state(500, seed=3, unseen=1.0)
    for method in ("sort", "histogram", "histogram_pallas"):
        hidden = select_hidden(_torch_state(d), 0.3, method=method)
        assert not hidden.any()


@pytest.mark.parametrize("method", ["sort", "histogram", "histogram_pallas"])
def test_threshold_mask_and_masked_order(method):
    d = _np_state(1000, seed=4, ties=True)
    want = jplanops.threshold_mask(jnp.asarray(d["loss"]),
                                   jnp.asarray(d["seen"] >= 0), 0.25,
                                   method=method)
    got = planops.threshold_mask(torch.from_numpy(d["loss"]),
                                 torch.from_numpy(d["seen"] >= 0), 0.25,
                                 method=method)
    assert np.array_equal(got.numpy(), np.asarray(want))
    key = jax.random.key(5)
    order, nm = jplanops.masked_order(key, want)
    order_t, nm_t = planops.masked_order(torch.from_numpy(_perm_of(key, 1000)),
                                         got)
    assert np.array_equal(order_t.numpy(), np.asarray(order))
    assert int(nm_t) == int(nm)


def test_sort_drop_top_waits_for_radix_slice():
    """DropTop under ``"sort"`` runs through the radix rank-select and equals
    the reference (and the argsort oracle), never-seen samples exempt;
    an unknown method still raises."""
    from repro.core.selection import select_hidden as jselect_hidden
    for n, drop in ((100, 0.1), (3001, 0.02), (777, 0.3)):
        d = _np_state(n, seed=n, ties=True)
        want = jselect_hidden(_jax_state(d), 0.3, method="sort",
                              drop_top_fraction=drop)
        got = select_hidden(_torch_state(d), 0.3, method="sort",
                            drop_top_fraction=drop)
        assert np.array_equal(got.numpy(), np.asarray(want))
        low = select_hidden(_torch_state(d), 0.3, method="sort")
        top = planops.sort_high_mask_argsort(torch.from_numpy(d["loss"]),
                                             torch.from_numpy(d["seen"] >= 0),
                                             drop)
        assert torch.equal(got, low | top)
        assert not (got & ~low).numpy()[d["seen"] < 0].any()
    with pytest.raises(ValueError, match="unknown selection"):
        select_hidden(_torch_state(_np_state(100)), 0.3, method="bogus")


def test_sampler_plan_on_cpu_and_batches():
    """The sampler's own path: a generator-drawn shuffle, the plan crossing
    to the host once, full visible batches only."""
    sampler = KakurenboSampler(300, KakurenboConfig(selection="histogram"),
                               device="cpu")
    d = _np_state(300, seed=9, unseen=0.0)
    sampler.state = _torch_state(d)
    plan = sampler.begin_epoch(0)
    assert plan.host_syncs == 1 and plan.hidden_fraction > 0
    assert len(plan.visible_indices) + len(plan.hidden_indices) == 300
    assert np.array_equal(np.sort(np.concatenate(
        [plan.visible_indices, plan.hidden_indices])), np.arange(300))
    assert np.array_equal(plan.hidden_indices,
                          np.flatnonzero(sampler.state.hidden.numpy()))
    batches = list(sampler.batches(plan, 64))
    assert len(batches) == len(plan.visible_indices) // 64
    assert all(len(b) == 64 for b in batches)
