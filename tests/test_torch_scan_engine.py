"""PyTorch port, the scanned epoch engine against the host loop and JAX.

- ``scan_block_sizes`` equals the reference's for every epoch length 0-70
  at ``scan_steps`` 1, 3, 8 and 64;
- for each of the seven strategies, the scanned engine equals the port's
  host loop bit for bit over 3 epochs (small CNN, N = 256, batch 32, fused
  scoring): per-epoch losses, plans (visible, hidden, moved back), the
  strategy's device state, parameters, momentum and the work accounting;
  on the CPU the block runs eagerly, on the card it is a CUDA graph
  (held to the same contract by ``chip_smoke.py``);
- block-size invariance for ``scan_steps`` 1, 3 and 64;
- ``warmup()`` leaves the train state bit-identical;
- engine validation raises as the reference's does;
- ``engine="scan", scan_steps=3`` against the JAX ``Trainer`` (scanned by
  default) from its initial params and with its permutations: plans
  exactly, per-epoch losses within 1e-4 relative, the final SampleState's
  loss/PC within 1e-4 and PA/seen exactly (``test_end_to_end_matches_jax_
  trainer``'s tolerances);
- ``SyntheticClassification.arrays`` rows equal ``get`` byte for byte.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import planops as jplanops
from repro.data import SyntheticClassification as JSynthetic
from repro.models import cnn as jcnn
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train.engines import scan_block_sizes as jscan_block_sizes
from repro_torch.core import (ForgetConfig, KakurenboConfig, LRSchedule,
                              available_strategies)
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core.strategy import EpochPlan, SampleStrategy
from repro_torch.data import SyntheticClassification
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig
from repro_torch.train.engines import (HostLoopEngine, ScanEpochEngine,
                                       scan_block_sizes)

SMALL = dict(image_size=8, widths=(8, 16), hidden=32)
N, BATCH, EPOCHS = 256, 32, 3
STRATEGIES = ("baseline", "forget", "gradmatch", "infobatch", "iswr",
              "kakurenbo", "random", "sb")


def _logits(model, batch):
    return model(batch["images"])


def make(engine: str, strategy: str = "kakurenbo", *, seed: int = 0,
         epochs: int = EPOCHS, n: int = N, **tc_kw) -> Trainer:
    """A small fused-scoring trainer; KAKURENBO's tau and LR chosen so that
    epochs 1 and 2 hide samples, FORGET pruning and restarting at epoch 2."""
    ds = SyntheticClassification(num_samples=n, image_size=8, seed=0)
    tc = TrainConfig(
        epochs=epochs, batch_size=BATCH, strategy=strategy, engine=engine,
        fused_scoring=True, lr=LRSchedule(0.1, "cosine", epochs, 1),
        kakurenbo=KakurenboConfig(selection="histogram_pallas", tau=0.2,
                                  max_fraction=0.3),
        forget=ForgetConfig(fraction=0.3, warmup_epochs=2), seed=seed,
        **tc_kw)
    model = cnn.CNN(cnn.CNNConfig(**SMALL), torch.Generator().manual_seed(seed))
    return Trainer(tc, model, None, ds, logits_fn=_logits, device="cpu")


def run_recording(tr: Trainer, epochs: int | None = None):
    plans = []
    plan = tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return tr.run(epochs), plans


def train_state(tr: Trainer) -> dict:
    """Every tensor of the train state, by name, as numpy arrays."""
    out = {f"param/{k}": v for k, v in tr.model.state_dict().items()}
    out.update({f"momentum/{i}": b for i, b in enumerate(tr.opt.bufs)})
    out.update({f"strategy{k}": v for k, v in
                flatten(tr.strategy.get_device_state())})
    return {k: v.detach().cpu().numpy().copy() for k, v in out.items()}


def assert_same_state(a: dict, b: dict, tag=""):
    assert a.keys() == b.keys(), tag
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag} {k}")


def assert_same_run(ha, hb, pa, pb, tag=""):
    assert [h.train_loss for h in ha] == [h.train_loss for h in hb], tag
    assert ([(h.fwd_samples, h.bwd_samples) for h in ha]
            == [(h.fwd_samples, h.bwd_samples) for h in hb]), tag
    for e, (x, y) in enumerate(zip(pa, pb)):
        for f in ("visible_indices", "hidden_indices", "moveback_indices"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f),
                                          err_msg=f"{tag} epoch {e} {f}")
        assert x.reinit_model == y.reinit_model, (tag, e)


@pytest.mark.parametrize("scan_steps", [1, 3, 8, 64])
def test_scan_block_sizes_match_reference(scan_steps):
    for num_steps in range(71):
        got = scan_block_sizes(num_steps, scan_steps)
        assert got == jscan_block_sizes(num_steps, scan_steps), num_steps
        assert sum(got) == num_steps


def test_every_strategy_scans():
    assert tuple(available_strategies()) == STRATEGIES
    for s in STRATEGIES:
        tr = make("auto", s)
        assert tr.strategy.supports_scan, s
        assert isinstance(tr.engine, ScanEpochEngine), s


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scan_bit_identical_to_host_loop(strategy):
    tr_s, tr_h = make("scan", strategy, scan_steps=3), make("host", strategy)
    assert isinstance(tr_h.engine, HostLoopEngine)
    hs, ps = run_recording(tr_s)
    hh, ph = run_recording(tr_h)
    assert_same_run(hs, hh, ps, ph, strategy)
    assert_same_state(train_state(tr_s), train_state(tr_h), strategy)
    assert all(h.engine == "scan" and h.host_syncs <= 1 for h in hs)
    # each strategy does in 3 epochs what tells it from the baseline
    if strategy in ("kakurenbo", "random", "infobatch"):
        assert any(len(p.hidden_indices) for p in ps[1:]), strategy
    if strategy == "forget":
        assert [p.reinit_model for p in ps] == [False, False, True]
    if strategy == "sb":
        assert sum(h.bwd_samples for h in hs) < sum(h.fwd_samples for h in hs)
        assert int(tr_s.strategy.get_device_state()["count"]) > 0


@pytest.mark.parametrize("scan_steps", [1, 3, 64])
def test_scan_block_size_invariance(scan_steps):
    ref = make("scan", "sb", scan_steps=8)
    href, pref = run_recording(ref)
    tr = make("scan", "sb", scan_steps=scan_steps)
    h, p = run_recording(tr)
    assert_same_run(h, href, p, pref, scan_steps)
    assert_same_state(train_state(tr), train_state(ref), scan_steps)


@pytest.mark.parametrize("strategy", ["kakurenbo", "sb", "infobatch"])
def test_warmup_leaves_train_state_bit_identical(strategy):
    """warmup() runs every block length ({8} and the remainders 4, 2, 1)
    and restores the parameters, momentum and strategy state (SB's draw
    counter among it); the run after it is the host loop's, bit for bit."""
    tr = make("scan", strategy, scan_steps=8)
    tr.run(1)                         # momentum and strategy state non-zero
    before = train_state(tr)
    assert tr.engine.warmup() == 4
    assert_same_state(train_state(tr), before, "after warmup")
    ref = make("host", strategy)
    hr, pr = run_recording(ref)
    hs, ps = run_recording(tr)
    assert_same_run(hs[1:], hr[1:], ps, pr[1:], strategy)
    assert_same_state(train_state(tr), train_state(ref), strategy)


class HostObserver(SampleStrategy):
    """An external strategy that observes on the host and has no fused
    observe: it cannot scan."""

    def plan(self, epoch):
        return EpochPlan(epoch=epoch, visible_indices=np.arange(self.num_samples))

    def observe(self, indices, loss, pa, pc, epoch):
        self.seen = np.asarray(indices)


def test_engine_config_validation():
    with pytest.raises(ValueError, match="device_data"):
        make("scan", device_data=False)
    with pytest.raises(ValueError, match="engine"):
        make("scanned")
    tr = make("auto", device_data=False)
    assert isinstance(tr.engine, HostLoopEngine)
    tr.run(1)
    assert tr._device_data is None          # never materialised
    # lazy placement: building a scan trainer places nothing
    tr = make("scan")
    assert tr._device_data is None and tr.engine._bufs is None
    assert isinstance(make("auto", scan_steps=0).engine, HostLoopEngine)
    ds = SyntheticClassification(num_samples=64, image_size=8, seed=0)
    model = cnn.CNN(cnn.CNNConfig(**SMALL))
    tc = TrainConfig(epochs=1, batch_size=32, fused_scoring=True)
    tr = Trainer(tc, model, None, ds, strategy=HostObserver(64),
                 logits_fn=_logits, device="cpu")
    assert isinstance(tr.engine, HostLoopEngine)
    tr.run()
    with pytest.raises(ValueError, match="scan"):
        Trainer(dataclasses.replace(tc, engine="scan"), model, None, ds,
                strategy=HostObserver(64), logits_fn=_logits, device="cpu")


@pytest.mark.parametrize("what", ["parameter", "strategy", "lr"])
def test_scan_raises_when_a_held_tensor_is_rebound(what):
    """The check the card runs before every replay (and the CPU before
    every block): a tensor the step holds that was rebound instead of
    updated in place is refused."""
    tr = make("scan")
    tr.run(1)
    if what == "parameter":
        tr.model.fc2.bias = torch.nn.Parameter(tr.model.fc2.bias.clone())
    elif what == "strategy":
        tr.strategy.state.loss = tr.strategy.state.loss.clone()
    else:
        tr.lr_dev = tr.lr_dev.clone()
    with pytest.raises(RuntimeError, match="in place"):
        tr.run_epoch(1)


# ---------------------------------------------------------------------------
# Against the JAX trainer
# ---------------------------------------------------------------------------


def _run_jax():
    jcfg = jcnn.CNNConfig(**SMALL)
    tc = JTrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo",
        fused_scoring=True, scan_steps=3, lr=JLRSchedule(0.1, "cosine", EPOCHS, 1),
        kakurenbo=JKakurenboConfig(selection="histogram_pallas", tau=0.2,
                                   max_fraction=0.3), seed=0)
    ds = JSynthetic(num_samples=N, image_size=8, seed=0)
    tr = JTrainer(tc, lambda rng: jcnn.init(rng, jcfg), None, ds, None,
                  logits_fn=lambda p, b: jcnn.forward(p, jcfg, b["images"]))
    assert tr.engine.name == "scan"
    init = {k: np.array(v) for k, v in tr.params.items()}
    hist, plans = run_recording(tr)
    st = tr.strategy.state
    return init, hist, plans, {k: np.asarray(getattr(st, k))
                               for k in ("loss", "pa", "pc", "seen")}


def _reference_perms():
    key, perms = jplanops.strategy_key(0, "kakurenbo"), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, N))))
    return perms


def test_scan_matches_jax_trainer():
    init, jhist, jplans, jstate = _run_jax()
    tcfg = cnn.CNNConfig(**SMALL)
    tr = make("scan", scan_steps=3)
    tr.model.load_state_dict(cnn.params_from_jax(init, tcfg))
    perms = iter(_reference_perms())
    tr.strategy._inner.draw_permutation = lambda: next(perms)
    thist, tplans = run_recording(tr)
    assert isinstance(tr.engine, ScanEpochEngine)
    assert any(len(p.hidden_indices) for p in tplans)
    for h, j, tp, jp in zip(thist, jhist, jplans, tplans):
        assert h.hidden_fraction == j.hidden_fraction
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples)
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4)
        np.testing.assert_array_equal(tp.visible_indices, jp.visible_indices)
        np.testing.assert_array_equal(tp.hidden_indices, jp.hidden_indices)
    st = tr.strategy.state
    np.testing.assert_allclose(st.loss.numpy(), jstate["loss"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.pc.numpy(), jstate["pc"], rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(st.pa.numpy(), jstate["pa"])
    assert np.array_equal(st.seen.numpy(), jstate["seen"])


@pytest.mark.parametrize("chunk", [4096, 100])
def test_arrays_rows_equal_get(chunk):
    ds = SyntheticClassification(num_samples=N, image_size=8, seed=3)
    arrays = ds.arrays(chunk)
    idx = np.array([0, 99, 100, 101, 255, 17, 17])
    got = ds.get(idx)
    assert arrays["images"][idx].tobytes() == got["images"].tobytes()
    assert arrays["labels"][idx].tobytes() == got["labels"].tobytes()
    ref = JSynthetic(num_samples=N, image_size=8, seed=3).arrays(chunk)
    assert arrays["images"].tobytes() == ref["images"].tobytes()
    assert np.array_equal(arrays["labels"], ref["labels"])
