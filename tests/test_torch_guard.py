"""PyTorch port, the numeric guard against the JAX package.

- ``all_finite``, ``select``, ``HeldState``, ``observation_valid`` and
  ``update_counters`` against ``repro.train.guard`` on the same seeded
  inputs (NaN, +-inf and -0.0 among them): flags and counters exactly,
  held values bit for bit;
- ``scatter_observations(valid=)`` exactly equal to the reference's, with
  repeated indices (an invalid last occurrence restores the pre-batch
  values) and with every observation invalid;
- a guarded clean run bit-identical to the unguarded one under both
  engines (losses, plans, the whole train state), one host sync an epoch;
- a poisoned KAKURENBO run (NaN features for a few sample ids) held
  against the JAX ``Trainer`` given the same poisoned data, its initial
  params and its permutations: per-epoch ``nonfinite_steps`` and
  quarantined counts, the plans and the poisoned samples' state exactly
  equal; parameters finite; the next plan finite and never hiding them;
- Selective-Backprop poisoned: the selection state held (the ``ok0``
  fallback), both engines alike; and held against the JAX ``Trainer``
  with the reference's permutations and its per-step uniforms indexed by
  the port's draw counter, which a held step holds as the reference holds
  its key: per-epoch backward counts, held steps and the selection state
  exactly equal;
- ``guard_abort_after`` raising ``NonFiniteError`` (restartable), and the
  guard-off control whose parameters go non-finite.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import planops as jplanops
from repro.core import state as jstate
from repro.data import SyntheticClassification as JSynthetic
from repro.models import cnn as jcnn
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train import chaos as jchaos
from repro.train import guard as jguard
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import KakurenboConfig, LRSchedule, state
from repro_torch.data import SyntheticClassification
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig, chaos, fault, guard

SMALL = dict(image_size=8, widths=(8,), hidden=16)
N, BATCH, EPOCHS = 192, 64, 3
POISON = (7, 50, 131)


def _values(r, shape, specials=True):
    x = r.normal(size=shape).astype(np.float32)
    if specials:
        flat = x.reshape(-1)
        flat[r.integers(0, flat.size, 3)] = [np.nan, np.inf, -0.0]
    return x


@pytest.mark.parametrize("case", ["finite", "nan_grad", "inf_loss"])
def test_all_finite_and_select_match_reference(case):
    r = np.random.default_rng(len(case))
    grads = [r.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), ())]
    scalar = np.float32(0.5)
    if case == "nan_grad":
        grads[1][2] = np.nan
    if case == "inf_loss":
        scalar = np.float32(np.inf)
    want = bool(jguard.all_finite(jnp.asarray(scalar),
                                  [jnp.asarray(g) for g in grads]))
    tg = [torch.from_numpy(g.copy()) for g in grads]
    found, one = torch.zeros(1), torch.ones(1)
    ok = guard.all_finite(torch.tensor(scalar), tg, found, one)
    assert ok.shape == () and bool(ok) == want == (case == "finite")
    for a, b in zip(tg, grads):              # the check leaves them exact
        assert np.array_equal(a.numpy(), b, equal_nan=True)
    new, old = _values(r, (4, 3)), _values(r, (4, 3))
    for flag in (True, False):
        got = guard.select(torch.tensor(flag), torch.from_numpy(new.copy()),
                           torch.from_numpy(old))
        ref = np.asarray(jguard.select(jnp.asarray(flag), jnp.asarray(new),
                                       jnp.asarray(old)))
        assert got.numpy().tobytes() == ref.tobytes()


def test_held_state_restores_bit_for_bit():
    r = np.random.default_rng(1)
    tensors = [torch.from_numpy(_values(r, s)) for s in ((4, 3), (7,))]
    tensors += [torch.tensor(3, dtype=torch.int32), torch.zeros(2)]
    held = guard.HeldState(tensors)
    before = [t.clone() for t in tensors]
    for flag, kept in ((True, False), (False, True)):
        held.save()
        for t in tensors:
            t.add_(1).mul_(float("nan") if t.is_floating_point() else 2)
        after = [t.clone() for t in tensors]
        held.restore(torch.tensor(flag))
        for t, b, a in zip(tensors, before, after):
            want = b if kept else a
            assert t.numpy().tobytes() == want.numpy().tobytes()
        for t, b in zip(tensors, before):
            t.copy_(b)


def test_observation_valid_and_counters_match_reference():
    r = np.random.default_rng(2)
    loss, pc = _values(r, (32,)), _values(r, (32,))
    want = np.asarray(jguard.observation_valid(jnp.asarray(loss),
                                               jnp.asarray(pc)))
    got = guard.observation_valid(torch.from_numpy(loss), torch.from_numpy(pc))
    assert np.array_equal(got.numpy(), want)
    js, ts = jguard.init_guard_state(), guard.init_guard_state("cpu")
    for ok, q in ((True, 0), (False, 3), (False, 1), (True, 2), (False, 0)):
        js = jguard.update_counters(js, jnp.asarray(ok), jnp.int32(q))
        guard.update_counters(ts, torch.tensor(ok), torch.tensor(q))
        assert [int(t) for t in ts.tensors()] == [
            int(js.nonfinite_steps), int(js.consecutive), int(js.quarantined)]
        assert all(t.dtype == torch.int32 for t in ts.tensors())


def _random_state(n, r):
    js = jstate.init_sample_state(n)
    ts = state.init_sample_state(n, "cpu")
    for epoch in range(2):
        idx = r.permutation(n)[: n // 2]
        loss = r.exponential(1.0, len(idx)).astype(np.float32)
        pa = r.random(len(idx)) < 0.6
        pc = r.random(len(idx)).astype(np.float32)
        js = jstate.scatter_observations(js, jnp.asarray(idx), jnp.asarray(loss),
                                         jnp.asarray(pa), jnp.asarray(pc), epoch)
        state.scatter_observations(ts, idx, torch.from_numpy(loss),
                                   torch.from_numpy(pa), torch.from_numpy(pc),
                                   epoch)
    return js, ts


@pytest.mark.parametrize("case", ["unique", "repeats", "all_invalid"])
def test_scatter_valid_matches_reference(case):
    n, b = 64, 48
    r = np.random.default_rng(3)
    js, ts = _random_state(n, r)
    idx = (r.integers(0, n, b) if case == "repeats"
           else r.permutation(n)[:b])
    if case == "repeats":
        idx[-1] = idx[0]                 # an index whose last occurrence ...
    loss = _values(r, (b,), specials=False)
    loss[r.random(b) < 0.3] = np.nan
    pc = r.random(b).astype(np.float32)
    pc[r.random(b) < 0.1] = np.inf
    if case == "repeats":
        loss[-1] = np.nan                # ... is invalid: pre-batch values
    pa = r.random(b) < 0.5
    valid = np.isfinite(loss) & np.isfinite(pc)
    if case == "all_invalid":
        valid[:] = False
    js = jstate.scatter_observations(js, jnp.asarray(idx), jnp.asarray(loss),
                                     jnp.asarray(pa), jnp.asarray(pc),
                                     jnp.int32(5), valid=jnp.asarray(valid))
    before = {f: getattr(ts, f).clone() for f in state.OBSERVED_FIELDS}
    state.scatter_observations(ts, idx, torch.from_numpy(loss),
                               torch.from_numpy(pa), torch.from_numpy(pc),
                               torch.tensor(5, dtype=torch.int32),
                               valid=torch.from_numpy(valid))
    for f in state.OBSERVED_FIELDS:
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.tobytes() == want.tobytes(), f
        if case == "all_invalid":
            assert torch.equal(getattr(ts, f), before[f]), f


# ---------------------------------------------------------------------------
# Trainer runs
# ---------------------------------------------------------------------------


def make(engine: str, strategy: str = "kakurenbo", ds=None,
         **tc_kw) -> Trainer:
    """The chaos suite's small trainer: fused scoring, 3 batches an epoch,
    blocks of 2 steps, KAKURENBO hiding from epoch 1 (tau 0.2, so that the
    small model's confidence lets it hide in 3 epochs)."""
    ds = ds or SyntheticClassification(num_samples=N, image_size=8, seed=0)
    tc = TrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy=strategy, engine=engine,
        fused_scoring=True, scan_steps=2,
        lr=LRSchedule(0.05, "cosine", EPOCHS, 1),
        kakurenbo=KakurenboConfig(max_fraction=0.3, tau=0.2,
                                  fraction_milestones=(0, 1, 2, 3)),
        **tc_kw)
    model = cnn.CNN(cnn.CNNConfig(**SMALL), torch.Generator().manual_seed(0))
    return Trainer(tc, model, None, ds, logits_fn=lambda m, b: m(b["images"]),
                   device="cpu")


def train_state(tr: Trainer) -> dict:
    return {p: ckpt.to_numpy(v).copy() for p, v in ckpt.flatten(tr._ckpt_tree())}


def recorded(tr: Trainer, epochs: int | None = None):
    plans, plan = [], tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return tr.run(epochs), plans


def poisoned(ids=POISON):
    return chaos.poison_samples(
        SyntheticClassification(num_samples=N, image_size=8, seed=0), ids)


@pytest.mark.parametrize("engine", ["scan", "host"])
def test_guard_clean_run_bit_identical(engine):
    off, on = make(engine), make(engine, guard_policy="skip_update")
    (h_off, p_off), (h_on, p_on) = recorded(off), recorded(on)
    assert [h.train_loss for h in h_off] == [h.train_loss for h in h_on]
    for a, b in zip(p_off, p_on):
        assert np.array_equal(a.visible_indices, b.visible_indices)
        assert np.array_equal(a.hidden_indices, b.hidden_indices)
    assert any(len(p.hidden_indices) for p in p_on)
    a, b = train_state(off), train_state(on)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert all(h.nonfinite_steps == h.quarantined_observations == 0
               for h in h_on)
    assert all(h.host_syncs == 1 and h.engine == engine for h in h_on)


def _reference_perms(epochs=EPOCHS):
    key, out = jplanops.strategy_key(0, "kakurenbo"), []
    for _ in range(epochs + 1):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.permutation(sub, N))))
    return out


def _poison_batches(plans):
    """Batches of each epoch that hold a poisoned id."""
    from repro_torch.data.pipeline import epoch_index_plan
    return [int(sum(np.isin(row, POISON).any()
                    for row in epoch_index_plan(p.visible_indices, BATCH)))
            for p in plans]


@pytest.mark.parametrize("engine", ["scan", "host"])
def test_poisoned_run_matches_jax_trainer(engine):
    jcfg = jcnn.CNNConfig(**SMALL)
    jtr = JTrainer(
        JTrainConfig(epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo",
                     fused_scoring=True, guard_policy="skip_update",
                     scan_steps=2, lr=JLRSchedule(0.05, "cosine", EPOCHS, 1),
                     kakurenbo=JKakurenboConfig(max_fraction=0.3, tau=0.2,
                                                fraction_milestones=(0, 1, 2, 3))),
        lambda rng: jcnn.init(rng, jcfg), None,
        jchaos.poison_samples(JSynthetic(num_samples=N, image_size=8, seed=0),
                              POISON),
        logits_fn=lambda p, b: jcnn.forward(p, jcfg, b["images"]))
    init = {k: np.array(v) for k, v in jtr.params.items()}
    jhist, jplans = recorded(jtr)

    tr = make(engine, ds=poisoned(), guard_policy="skip_update")
    tr.model.load_state_dict(cnn.params_from_jax(init, tr.model.cfg))
    perms = iter(_reference_perms())
    tr.strategy._inner.draw_permutation = lambda: next(perms)
    hist, plans = recorded(tr)

    for e, (h, j, p, jp) in enumerate(zip(hist, jhist, plans, jplans)):
        assert np.array_equal(p.visible_indices, jp.visible_indices), e
        assert np.array_equal(p.hidden_indices, jp.hidden_indices), e
        assert h.nonfinite_steps == j.nonfinite_steps, e
        assert h.quarantined_observations == j.quarantined_observations, e
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4,
                                             nan_ok=True), e
    assert [h.nonfinite_steps for h in hist] == _poison_batches(plans)
    assert all(h.quarantined_observations >= 1 for h in hist)
    for p in tr.model.parameters():
        assert torch.isfinite(p).all()
    st, jst = tr.strategy.state, jtr.strategy.get_device_state()
    for f in ("loss", "pa", "pc", "seen", "hidden"):
        assert np.array_equal(getattr(st, f).numpy()[list(POISON)],
                              np.asarray(getattr(jst, f))[list(POISON)]), f
    assert (st.seen[list(POISON)] == -1).all()
    assert (st.loss[list(POISON)] == 1e9).all()
    assert not st.hidden[list(POISON)].any()
    nxt = tr.strategy.plan(EPOCHS)
    assert np.isfinite(nxt.hidden_fraction)
    assert not np.isin(nxt.hidden_indices, POISON).any()
    assert np.isin(POISON, nxt.visible_indices).all()


def test_poisoned_sb_holds_its_selection_state():
    runs = {}
    for engine in ("scan", "host"):
        tr = make(engine, "sb", ds=poisoned(), guard_policy="skip_update")
        hist = tr.run()
        runs[engine] = (hist, train_state(tr))
        assert all(h.nonfinite_steps >= 1 for h in hist)
        assert all(torch.isfinite(p).all() for p in tr.model.parameters())
        hist_buf = tr.strategy.get_device_state()["hist"]
        assert not torch.isnan(hist_buf).any()
    (hs, ss), (hh, sh) = runs["scan"], runs["host"]
    assert np.array_equal([h.train_loss for h in hs],
                          [h.train_loss for h in hh], equal_nan=True)
    assert [h.nonfinite_steps for h in hs] == [h.nonfinite_steps for h in hh]
    for k in ss:
        assert ss[k].tobytes() == sh[k].tobytes(), k


def _reference_splits(name, count):
    key, out = jplanops.strategy_key(0, name), []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(sub)
    return out


@pytest.mark.parametrize("engine", ["scan", "host"])
def test_poisoned_sb_matches_jax_trainer(engine):
    """One poisoned id, so one held selection step an epoch among two that
    select: after each held step the draws continue where the reference's
    held key leaves them."""
    ids = POISON[:1]
    jcfg = jcnn.CNNConfig(**SMALL)
    jtr = JTrainer(
        JTrainConfig(epochs=EPOCHS, batch_size=BATCH, strategy="sb",
                     fused_scoring=True, guard_policy="skip_update",
                     scan_steps=2, lr=JLRSchedule(0.05, "cosine", EPOCHS, 1)),
        lambda rng: jcnn.init(rng, jcfg), None,
        jchaos.poison_samples(JSynthetic(num_samples=N, image_size=8, seed=0),
                              ids),
        logits_fn=lambda p, b: jcnn.forward(p, jcfg, b["images"]))
    init = {k: np.array(v) for k, v in jtr.params.items()}
    jhist = jtr.run()

    tr = make(engine, "sb", ds=poisoned(ids), guard_policy="skip_update")
    tr.model.load_state_dict(cnn.params_from_jax(init, tr.model.cfg))
    s = tr.strategy
    perms = iter([torch.from_numpy(np.array(jax.random.permutation(k, N)))
                  for k in _reference_splits("sb-plan", EPOCHS)])
    s.draw_permutation = lambda: next(perms)
    steps = EPOCHS * (N // BATCH)
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (BATCH,))))
         for k in _reference_splits("sb", steps)]
    s.draw_uniform = lambda b: u[int(s.get_device_state()["draws"])]
    hist = tr.run()

    for e, (h, j) in enumerate(zip(hist, jhist)):
        assert h.nonfinite_steps == j.nonfinite_steps == 1, e
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples,
                                                  j.bwd_samples), e
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4,
                                             nan_ok=True), e
    assert sum(h.bwd_samples for h in hist) < sum(h.fwd_samples for h in hist)
    sel, jsel = s.get_device_state(), jtr.strategy.get_device_state()
    for k in ("count", "ptr"):
        assert int(sel[k]) == int(jsel[k]), k
    np.testing.assert_allclose(sel["hist"].numpy(), np.asarray(jsel["hist"]),
                               rtol=1e-4)
    assert int(sel["draws"]) == steps - EPOCHS
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())


@pytest.mark.parametrize("engine", ["scan", "host"])
def test_guard_abort_after_and_off_control(engine):
    tr = make(engine, "baseline", ds=poisoned(range(N)),
              guard_policy="skip_update", guard_abort_after=2)
    init = [p.detach().clone() for p in tr.model.parameters()]
    with pytest.raises(guard.NonFiniteError) as exc:
        tr.run()
    assert fault.classify_failure(exc.value) == "restartable"
    assert tr.epoch == 0          # raised at the first epoch boundary
    for p, p0 in zip(tr.model.parameters(), init):
        assert torch.equal(p, p0)            # every update was held
    assert int(tr.guard_state.consecutive) == N // BATCH
    control = make(engine, "kakurenbo", ds=poisoned())
    control.run()
    assert not all(torch.isfinite(p).all() for p in control.model.parameters())
    with pytest.raises(ValueError, match="guard_policy"):
        make(engine, guard_policy="skip")
    with pytest.raises(ValueError, match="guard_abort_after"):
        make(engine, guard_abort_after=1)
