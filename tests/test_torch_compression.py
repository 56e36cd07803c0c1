"""PyTorch port, error-feedback gradient compression against the JAX package.

- ``dist/compression.py::compress_grads`` against the reference's on all-zero
  leaves (the 1e-12 floor), exact .5 ties, mixed signs, wide magnitudes
  and a residual carried over steps: the compressed gradients bit for bit
  (the bytes: signed zeros too) against the reference under ``jax.jit`` and
  op by op, the residual bit for bit against the reference op by op.  The
  one case named: under jit, XLA's vectorised loop fuses the residual
  ``v - round(v / s) * s`` into a multiply-add and rounds it once, the
  port twice as written, so the jitted residual lies one ulp away in some
  elements of a long leaf (ROADMAP C);
- the accumulated-error bound of ``tests/test_train_fault.py:218``;
- ``guard.zero_if`` against the reference's;
- ``grad_compression=True``: 3 epochs of baseline and of KAKURENBO (small
  CNN, fused scoring) against the JAX ``Trainer`` from its initial
  parameters and with its permutations (plans exactly, losses within 1e-4
  relative); the scanned engine bit-identical to the host loop, the
  residual included (``tests/test_scan_engine.py:254``); a crash between
  two blocks restored into a trainer from other weights, bit-identical
  under both engines, with ``"ef"`` in the checkpoint (and no ``"ef"``
  without compression); under the guard a poisoned step zeroes the
  gradients before the compressor and leaves the residual bit for bit;
  FORGET's restart keeps the residual.
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
from repro.data import SyntheticClassification as JSynthetic
from repro.dist.compression import compress_grads as jcompress
from repro.models import cnn as jcnn
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train import guard as jguard
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import ForgetConfig, KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticClassification
from repro_torch.dist import compression
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig, guard

SMALL = dict(image_size=8, widths=(8, 16), hidden=32)
N, BATCH, EPOCHS = 256, 32, 3


def _leaves(case: str, r: np.random.Generator) -> list[np.ndarray]:
    if case == "zeros":
        return [np.zeros(7, np.float32), np.zeros((3, 4), np.float32)]
    if case == "ties":
        # v / scale lands on .5 exactly: scale = 127 / 127 = 1.
        return [np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0,
                          -127.0, 63.5, -0.0, 0.0], np.float32)]
    if case == "mixed":
        return [r.normal(size=(33, 5)).astype(np.float32),
                (r.normal(size=100) * 1e-20).astype(np.float32),
                np.array([-3.0], np.float32)]
    return [(r.normal(size=4096) * 10.0 ** r.integers(-30, 30, 4096))
            .astype(np.float32)]


def _same_bytes(a, b) -> bool:
    return np.asarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def _jit_residual_ok(jitted, port, q) -> bool:
    """The jitted reference's residual equals the port's, or, where XLA
    fused ``v - q`` into a multiply-add, lies within the rounding of the
    product ``q`` (one ulp of q) from it."""
    a, b, q = np.asarray(jitted), np.asarray(port), np.asarray(q)
    d = a != b
    return bool((np.abs(a[d] - b[d]) <= np.spacing(np.abs(q[d]))).all())


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("case", ["zeros", "ties", "mixed", "wide"])
def test_compress_grads_matches_reference(case, carried):
    """Three steps from a zero or a random residual, both packages fed the
    same gradients and residual each step: the compressed gradients equal
    the reference's under ``jax.jit`` and op by op byte for byte, the
    residual the op-by-op reference's byte for byte and the jitted one's
    within its fused multiply-add's last bit."""
    r = np.random.default_rng(len(case))
    jfn = jax.jit(jcompress)
    g0 = _leaves(case, r)
    te = [torch.from_numpy((r.normal(size=x.shape) * 0.01 if carried
                            else np.zeros(x.shape)).astype(np.float32))
          for x in g0]
    for step in range(3):
        g = g0 if step == 0 else [(x * r.normal()).astype(np.float32)
                                  for x in g0]
        e = [t.numpy().copy() for t in te]
        jq, je = jfn([jnp.asarray(x) for x in g], [jnp.asarray(x) for x in e])
        eq, ee = jcompress([jnp.asarray(x) for x in g],
                           [jnp.asarray(x) for x in e])
        tg = [torch.from_numpy(x.copy()) for x in g]
        out_g, out_e = compression.compress_grads(tg, te)
        assert out_g is tg and out_e is te           # in place
        for a, b, t in zip(jq, eq, tg):
            assert _same_bytes(a, t.numpy()) and _same_bytes(b, t.numpy())
        for a, b, t, q in zip(je, ee, te, tg):
            assert _same_bytes(b, t.numpy()), (case, step)
            assert _jit_residual_ok(a, t.numpy(), q.numpy()), (case, step)
    if case == "zeros" and not carried:
        assert all(not t.any() for t in te)


def test_jitted_residual_is_a_fused_multiply_add():
    """Names the one difference: on a long leaf XLA's vectorised loop
    rounds ``v - round(v / s) * s`` once (its exact value), the port (and
    the reference op by op) twice.  The quantized gradients agree."""
    r = np.random.default_rng(1)
    g = (r.normal(size=20000) * 10.0 ** r.integers(-3, 3, 20000)).astype(
        np.float32)
    e = (r.normal(size=20000) * 0.01).astype(np.float32)
    jq, je = jax.jit(jcompress)([jnp.asarray(g)], [jnp.asarray(e)])
    tg, te = [torch.from_numpy(g.copy())], [torch.from_numpy(e.copy())]
    compression.compress_grads(tg, te)
    assert _same_bytes(jq[0], tg[0].numpy())
    v = g + e
    scale = np.float32(max(np.abs(v).max(), np.float32(1e-12))) / np.float32(127)
    levels = np.round(v / scale)
    fused = (v.astype(np.float64) - levels.astype(np.float64)
             * np.float64(scale)).astype(np.float32)
    assert _same_bytes(je[0], fused)
    port = te[0].numpy()
    differs = np.asarray(je[0]) != port
    assert 0.02 < differs.mean() < 0.5
    assert _jit_residual_ok(je[0], port, tg[0].numpy())


def test_accumulated_error_stays_bounded():
    """The reference's bound (``tests/test_train_fault.py:218``): after 50
    steps the accumulated compressed gradients lie within 0.2 of the true
    sum, the residual one step's quantization error."""
    r = np.random.default_rng(0)
    g = [torch.from_numpy(r.normal(size=(64,)).astype(np.float32))]
    ef = compression.init_error_feedback(g)
    assert len(ef) == 1 and not ef[0].any() and not ef[0].requires_grad
    acc_true, acc_comp = np.zeros(64), np.zeros(64)
    for _ in range(50):
        gi = r.normal(size=(64,)).astype(np.float32)
        cg, ef = compression.compress_grads([torch.from_numpy(gi.copy())], ef)
        acc_true += gi
        acc_comp += cg[0].numpy()
    assert np.max(np.abs(acc_true - acc_comp)) < 0.2
    np.testing.assert_allclose(acc_true - acc_comp, ef[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("bad", [False, True])
def test_zero_if_matches_reference(bad):
    g = [np.array([1.0, np.nan, -np.inf, -0.0], np.float32),
         np.arange(6, dtype=np.float32).reshape(2, 3)]
    want = jguard.zero_if(jnp.asarray(bad), [jnp.asarray(x) for x in g])
    got = [torch.from_numpy(x.copy()) for x in g]
    out = guard.zero_if(torch.tensor(bad), got)
    assert out is got
    for a, b in zip(want, got):
        assert _same_bytes(a, b.numpy())


# ---------------------------------------------------------------------------
# The trainer with compression on
# ---------------------------------------------------------------------------


def _logits(model, batch):
    return model(batch["images"])


def make(engine: str = "auto", strategy: str = "kakurenbo", *, seed: int = 0,
         compress: bool = True, ds=None, **tc_kw) -> Trainer:
    """A small fused-scoring CNN trainer (``tests/test_torch_scan_engine``'s
    settings), compression on unless ``compress`` is False."""
    ds = ds or SyntheticClassification(num_samples=N, image_size=8, seed=0)
    tc = TrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy=strategy, engine=engine,
        fused_scoring=True, lr=LRSchedule(0.1, "cosine", EPOCHS, 1),
        kakurenbo=KakurenboConfig(selection="histogram_pallas", tau=0.2,
                                  max_fraction=0.3),
        forget=ForgetConfig(fraction=0.3, warmup_epochs=2), seed=seed,
        grad_compression=compress, **tc_kw)
    model = cnn.CNN(cnn.CNNConfig(**SMALL), torch.Generator().manual_seed(seed))
    return Trainer(tc, model, None, ds, logits_fn=_logits, device="cpu")


def recorded(tr: Trainer, epochs: int | None = None):
    plans, plan = [], tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return tr.run(epochs), plans


def state(tr: Trainer) -> dict:
    """The whole checkpoint tree (the residual among it) as numpy."""
    return {p: ckpt.to_numpy(v).copy() for p, v in ckpt.flatten(tr._ckpt_tree())}


def assert_same(a: Trainer, b: Trainer, pa=(), pb=()):
    sa, sb = state(a), state(b)
    assert sa.keys() == sb.keys()
    assert any(k.startswith("/ef/") for k in sa)
    for k in sa:
        assert sa[k].tobytes() == sb[k].tobytes(), k
    la = np.array([h.train_loss for h in a.history])
    lb = np.array([h.train_loss for h in b.history])[-len(la):]
    assert la.tobytes() == lb.tobytes()              # NaN losses alike
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x.visible_indices, y.visible_indices)
        np.testing.assert_array_equal(x.hidden_indices, y.hidden_indices)


def _run_jax(strategy: str):
    jcfg = jcnn.CNNConfig(**SMALL)
    tc = JTrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy=strategy,
        fused_scoring=True, lr=JLRSchedule(0.1, "cosine", EPOCHS, 1),
        kakurenbo=JKakurenboConfig(selection="histogram_pallas", tau=0.2,
                                   max_fraction=0.3), seed=0,
        grad_compression=True)
    tr = JTrainer(tc, lambda rng: jcnn.init(rng, jcfg), None,
                  JSynthetic(num_samples=N, image_size=8, seed=0), None,
                  logits_fn=lambda p, b: jcnn.forward(p, jcfg, b["images"]))
    assert tr.ef_state is not None
    init = {k: np.array(v) for k, v in tr.params.items()}
    hist, plans = recorded(tr)
    return init, hist, plans, tr


@pytest.mark.parametrize("strategy", ["baseline", "kakurenbo"])
def test_compressed_training_matches_jax_trainer(strategy):
    init, jhist, jplans, jtr = _run_jax(strategy)
    tr = make(strategy=strategy, scan_steps=3)
    tr.model.load_state_dict(cnn.params_from_jax(init, cnn.CNNConfig(**SMALL)))
    key, perms = jplanops.strategy_key(0, strategy), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, N))))
    it = iter(perms)
    drawer = tr.strategy._inner if strategy == "kakurenbo" else tr.strategy
    drawer.draw_permutation = lambda: next(it)
    hist, plans = recorded(tr)
    assert tr.engine.name == "scan"
    if strategy == "kakurenbo":
        assert any(len(p.hidden_indices) for p in plans)
    for h, j, tp, jp in zip(hist, jhist, plans, jplans):
        assert h.hidden_fraction == j.hidden_fraction
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples)
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4)
        np.testing.assert_array_equal(tp.visible_indices, jp.visible_indices)
        np.testing.assert_array_equal(tp.hidden_indices, jp.hidden_indices)
    assert hist[-1].train_loss < hist[0].train_loss
    # The residual is live and of the reference's size (a quantum or less).
    ef = {k: e.numpy() for k, e in tr._ef_tree().items()}
    assert len(ef) == len(jtr.ef_state) and any(e.any() for e in ef.values())
    for name, p in tr.model.named_parameters():
        g = p.detach().abs().max().item()
        assert np.abs(ef[name]).max() <= g + 1.0, name


@pytest.mark.parametrize("strategy", ["baseline", "kakurenbo"])
def test_scan_bit_identical_to_host_loop(strategy):
    tr_s = make("scan", strategy, scan_steps=3)
    tr_h = make("host", strategy)
    hs, ps = recorded(tr_s)
    hh, ph = recorded(tr_h)
    assert (tr_s.engine.name, tr_h.engine.name) == ("scan", "host")
    assert any(e.any() for e in tr_s.ef_state)
    assert_same(tr_s, tr_h, ps, ph)


def test_scan_raises_when_the_residual_is_rebound():
    tr = make("scan")
    tr.run(1)
    tr.ef_state[0] = tr.ef_state[0].clone()
    with pytest.raises(RuntimeError, match="compression"):
        tr.run_epoch(1)


@pytest.mark.parametrize("engine", ["host", "scan"])
def test_restart_between_blocks_is_bit_exact(engine, tmp_path):
    ref = make(engine, scan_steps=3)
    ref.run()
    tr = make(engine, scan_steps=3, checkpoint_dir=str(tmp_path),
              checkpoint_every=1)
    tr.run(2)
    assert "ef" in tr._ckpt_tree()
    if engine == "scan":
        dispatch, calls = tr.engine._dispatch, [0]

        def crash(size, weighted):
            if calls[0] == 1:
                raise RuntimeError("injected failure between blocks")
            calls[0] += 1
            dispatch(size, weighted)

        tr.engine._dispatch = crash
    else:
        step, calls = tr.train_step, [0]

        def crash(*args):
            if calls[0] == 2:
                raise RuntimeError("injected failure between blocks")
            calls[0] += 1
            return step(*args)

        tr.train_step = crash
    with pytest.raises(RuntimeError, match="between blocks"):
        tr.run_epoch(2)
    again = make(engine, seed=7, scan_steps=3, checkpoint_dir=str(tmp_path),
                 checkpoint_every=1)
    assert any(e.any() for e in ref.ef_state)
    assert not any(e.any() for e in again.ef_state)
    assert again.restore_latest() and again.epoch == 2
    again.run()
    assert_same(again, ref)


def test_checkpoint_has_no_residual_without_compression(tmp_path):
    tr = make(compress=False, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert tr.ef_state is None and "ef" not in tr._ckpt_tree()
    tr.run(1)
    on = make(checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        on.restore_latest()


class _Poisoned(SyntheticClassification):
    """NaN images for the samples in ``bad``."""

    bad = frozenset({40, 77})

    def get(self, indices):
        batch = super().get(indices)
        hit = np.isin(np.asarray(indices), list(self.bad))
        batch["images"][hit] = np.nan
        return batch

    def arrays(self, chunk: int = 4096):
        out = super().arrays(chunk)
        out["images"][list(self.bad)] = np.nan
        return out


def test_guard_zeroes_before_the_compressor(monkeypatch):
    """A poisoned step (NaN loss and gradients) under the guard: the
    compressor sees all-zero gradients, and the parameters, AdamW's state
    and the residual are bit for bit as before the step; a clean step
    moves the residual."""
    ds = _Poisoned(num_samples=N, image_size=8, seed=0)
    tr = make("host", "baseline", ds=ds, guard_policy="skip_update",
              optimizer="adamw", optimizer_hp={})
    seen = []
    real = compression.compress_grads

    def spy(grads, ef):
        seen.append([g.clone() for g in grads])
        return real(grads, ef)

    monkeypatch.setattr("repro_torch.train.trainer.compress_grads", spy)
    tr.lr_dev.fill_(0.1)

    def step(ids):
        idx = np.asarray(ids)
        batch = tr.to_device(ds.get(idx))
        before = state(tr)
        tr.train_step(tr.strategy.get_device_state(), batch, idx,
                      tr.epoch_dev, tr.lr_dev)
        return before, state(tr)

    b0, a0 = step(range(32))                      # clean: the residual moves
    assert any(b0[k].tobytes() != a0[k].tobytes() for k in b0
               if k.startswith("/ef/"))
    b1, a1 = step(range(32, 64))                  # sample 40: poisoned
    assert all(not g.any() for g in seen[-1])
    for k in b1:
        assert b1[k].tobytes() == a1[k].tobytes(), k
    assert all(np.isfinite(v).all() for k, v in a1.items()
               if k.startswith("/ef/"))
    assert int(tr.guard_state.nonfinite_steps) == 1


def test_guarded_poisoned_run_scan_equals_host():
    """A guarded run over poisoned samples: the residual finite, the held
    steps counted, the scanned engine bit-identical to the host loop."""
    runs = {}
    for engine in ("host", "scan"):
        tr = make(engine, scan_steps=3, guard_policy="skip_update",
                  ds=_Poisoned(num_samples=N, image_size=8, seed=0))
        hist, plans = recorded(tr)
        runs[engine] = (tr, plans)
        assert sum(h.nonfinite_steps for h in hist) >= EPOCHS
        assert all(torch.isfinite(e).all() for e in tr.ef_state)
    (h, ph), (s, ps) = runs["host"], runs["scan"]
    assert_same(s, h, ps, ph)


def test_forget_restart_keeps_the_residual():
    tr = make("scan", "forget", scan_steps=3)
    tr.run(2)
    kept = [e.clone() for e in tr.ef_state]
    assert any(e.any() for e in kept)
    seen = {}
    run_epoch = tr.engine.run_epoch

    def spy(epoch, indices, plan, lr):
        seen["reinit"] = plan.reinit_model
        seen["ef"] = [e.clone() for e in tr.ef_state]
        seen["params"] = {k: v.clone() for k, v in tr.model.state_dict().items()}
        return run_epoch(epoch, indices, plan, lr)

    tr.engine.run_epoch = spy
    tr.run_epoch(2)
    assert seen["reinit"]
    for k, v in seen["params"].items():
        assert torch.equal(v, tr._init_weights[k]), k
    for a, b in zip(seen["ef"], kept):
        assert torch.equal(a, b)
