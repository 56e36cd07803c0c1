"""PyTorch port, the supervisor, the straggler code and the host-observe
path, against the JAX package's ``repro.train.fault``.

- ``classify_failure``'s policy, with torch's CUDA out-of-memory error
  (a ``RuntimeError``) restartable;
- ``run_with_restarts``: a fatal failure is not retried, the backoff
  escalates while no epoch is gained and resets on progress, the restart
  budget slides with its window (``tests/test_train_fault.py``'s cases);
- ``worker_slice``, ``rescale_plan`` and ``StragglerMonitor`` (flags,
  latencies and ``rebalance``) exactly equal to the reference's on the
  same inputs;
- the legacy host-observe path (``fused_observe=False``) bit-identical to
  the fused path over 3 KAKURENBO epochs, with the same work accounting,
  one host sync an epoch fused and 1 + batches on the host path
  (``EpochStats.host_syncs`` = plan + engine), under the guard as well;
- the trainer runs its epochs with cuDNN deterministic and not
  benchmarking, and gives the caller's flags back after ``run``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data import worker_slice as jworker_slice
from repro.train import fault as jfault
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticClassification, worker_slice
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig, chaos, fault, guard
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.engines import HostLoopEngine, ScanEpochEngine


def test_classify_failure_policy():
    for exc in (OSError("disk"), RuntimeError("cuda"), ValueError("decode"),
                EOFError(), ConnectionError(), guard.NonFiniteError("nan"),
                chaos.ChaosError("injected"), IOError("crc"),
                torch.cuda.OutOfMemoryError("oom")):
        assert fault.classify_failure(exc) == "restartable", exc
        assert jfault.classify_failure(exc) == "restartable", exc

    class Unknown(Exception):
        pass

    for exc in (TypeError(), AttributeError(), KeyError(), IndexError(),
                AssertionError(), NotImplementedError(), Unknown()):
        assert fault.classify_failure(exc) == "fatal", exc


class _ScriptedTrainer:
    """Attempt k advances to ``script[k][0]`` and raises ``script[k][1]``;
    ``state`` stands in for the checkpoint dir across rebuilds."""

    def __init__(self, state, script):
        self.state = state
        self.script = script
        self.epoch = 0

    def restore_latest(self):
        self.epoch = self.state["epoch"]
        return self.epoch > 0

    def run(self, total_epochs):
        k = self.state["attempt"]
        self.state["attempt"] += 1
        to_epoch, exc = self.script[min(k, len(self.script) - 1)]
        self.epoch = max(self.epoch, to_epoch)
        self.state["epoch"] = self.epoch
        if exc is not None:
            raise exc


def _scripted(script):
    state = {"epoch": 0, "attempt": 0}
    return state, (lambda: _ScriptedTrainer(state, script))


def test_run_with_restarts_fatal_not_retried():
    state, make = _scripted([(0, KeyError("bug"))])
    with pytest.raises(KeyError):
        fault.run_with_restarts(make, 4, sleep_fn=lambda s: None)
    assert state["attempt"] == 1


@pytest.mark.parametrize("script,sleeps", [
    # stagnant: base * factor ** k
    ([(0, OSError()), (0, OSError()), (0, OSError()), (4, None)],
     [0.5, 1.0, 2.0]),
    # a crash after progress sleeps 0 (skipped); only the stagnant retry
    ([(1, OSError()), (1, OSError()), (2, OSError()), (4, None)], [0.5]),
])
def test_run_with_restarts_backoff(script, sleeps):
    got = {}
    for name, mod in (("port", fault), ("reference", jfault)):
        _, make = _scripted(script)
        slept = []
        _, restarts = mod.run_with_restarts(make, 4, max_restarts=5,
                                            sleep_fn=slept.append)
        got[name] = (restarts, slept)
    assert got["port"] == got["reference"] == (3, sleeps)


def test_run_with_restarts_budget_is_sliding_window():
    script = [(1, OSError()), (2, OSError()), (3, OSError()),
              (4, OSError()), (5, None)]
    _, make = _scripted(script)
    with pytest.raises(OSError):
        fault.run_with_restarts(make, 5, max_restarts=2,
                                sleep_fn=lambda s: None)
    _, make = _scripted(script)
    t = {"now": 0.0}

    def clock():
        t["now"] += 6.0
        return t["now"]

    _, restarts = fault.run_with_restarts(make, 5, max_restarts=2,
                                          restart_window=10.0, clock=clock,
                                          sleep_fn=lambda s: None)
    assert restarts == 4


@pytest.mark.parametrize("n,world,batch", [(1000, 4, 8), (512, 8, 8),
                                           (77, 3, 5)])
def test_worker_slice_and_rescale_match_reference(n, world, batch):
    idx = np.random.default_rng(n).permutation(n)
    for rank in range(world):
        assert np.array_equal(worker_slice(idx, world, rank, batch),
                              jworker_slice(idx, world, rank, batch))
    p, jp = fault.rescale_plan(idx, world, batch), jfault.rescale_plan(
        idx, world, batch)
    assert p.world_size == jp.world_size == world
    for a, b in zip(p.per_worker, jp.per_worker, strict=True):
        assert np.array_equal(a, b)
    allv = np.concatenate(p.per_worker)
    assert len(np.unique(allv)) == len(allv) == (n // (world * batch)) * world * batch


def test_straggler_monitor_matches_reference():
    r = np.random.default_rng(4)
    mon, jmon = fault.StragglerMonitor(4), jfault.StragglerMonitor(4)
    per_worker = [np.arange(i * 100, (i + 1) * 100) for i in range(4)]
    for epoch in range(6):
        lat = list(r.uniform(0.9, 1.1, 4))
        if epoch >= 2:
            lat[3] *= 3.0
        mon.record_epoch(lat)
        jmon.record_epoch(lat)
        assert np.array_equal(mon.lat, jmon.lat)
        assert np.array_equal(mon.stragglers(), jmon.stragglers())
        for a, b in zip(mon.rebalance(per_worker, 0.25),
                        jmon.rebalance(per_worker, 0.25), strict=True):
            assert np.array_equal(a, b)
    assert list(mon.stragglers()) == [False, False, False, True]
    lens = [len(w) for w in mon.rebalance(per_worker)]
    assert lens[3] == 75 and sorted(lens) == [75, 100, 100, 125]
    with pytest.raises(ValueError, match="latencies"):
        mon.record_epoch([1.0, 2.0])


# ---------------------------------------------------------------------------
# The host-observe path, host_syncs, cuDNN flags
# ---------------------------------------------------------------------------

N, BATCH = 256, 64


def make(fused: bool = True, engine: str = "auto", ds=None,
         **tc_kw) -> Trainer:
    ds = ds or SyntheticClassification(num_samples=N, image_size=8, seed=0)
    tc = TrainConfig(
        epochs=3, batch_size=BATCH, strategy="kakurenbo", engine=engine,
        fused_scoring=True, fused_observe=fused, scan_steps=2,
        lr=LRSchedule(0.05, "cosine", 3, 1),
        kakurenbo=KakurenboConfig(max_fraction=0.3, tau=0.2,
                                  fraction_milestones=(0, 1, 2, 3)), **tc_kw)
    model = cnn.CNN(cnn.CNNConfig(image_size=8, widths=(8,), hidden=16),
                    torch.Generator().manual_seed(0))
    return Trainer(tc, model, None, ds, ds.test_split(64),
                   logits_fn=lambda m, b: m(b["images"]), device="cpu")


def _state(tr: Trainer) -> dict:
    return {p: ckpt.to_numpy(v).copy() for p, v in ckpt.flatten(tr._ckpt_tree())}


def _poisoned():
    return chaos.poison_samples(
        SyntheticClassification(num_samples=N, image_size=8, seed=0), [3, 200])


@pytest.mark.parametrize("engine,guarded", [("auto", False), ("host", False),
                                            ("auto", True)])
def test_host_observe_path_bit_identical_to_fused(engine, guarded):
    """The fused scatter under the default engine (scanned) or the host
    loop, against the per-batch host ``observe``; guarded, both on poisoned
    data (the host path filters the non-finite observations on the
    host)."""
    kw = dict(guard_policy="skip_update", ds=_poisoned()) if guarded else {}
    fused = make(True, engine, **kw)
    host = make(False, **kw)
    assert isinstance(host.engine, HostLoopEngine) and host._fuse is None
    assert isinstance(fused.engine, ScanEpochEngine if engine == "auto"
                      else HostLoopEngine)
    hf, hh = fused.run(), host.run()
    a, b = _state(fused), _state(host)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert torch.equal(fused.strategy.state.hidden, host.strategy.state.hidden)
    assert any(h.hidden_fraction > 0 for h in hf)
    batches = N // BATCH
    assert all(h.host_syncs == 1 for h in hf)
    assert all(h.host_syncs == 1 + batches for h in hh)
    assert ([(h.fwd_samples, h.bwd_samples, h.nonfinite_steps,
              h.quarantined_observations) for h in hf]
            == [(h.fwd_samples, h.bwd_samples, h.nonfinite_steps,
                 h.quarantined_observations) for h in hh])
    assert np.array_equal([h.train_loss for h in hf],
                          [h.train_loss for h in hh], equal_nan=True)
    if guarded:
        assert all(h.nonfinite_steps >= 1 for h in hh)
        assert all(h.quarantined_observations >= 1 for h in hh)
    with pytest.raises(ValueError, match="cannot run scanned"):
        make(False, "scan")


def test_epoch_runs_cudnn_deterministic_and_restores_flags(monkeypatch):
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        for flag in (True, False):
            monkeypatch.setattr(trainer_mod, "CUDNN_DETERMINISTIC", flag)
            tr = make()
            seen, run_epoch = [], tr.engine.run_epoch
            tr.engine.run_epoch = lambda *a: (seen.append(
                (cudnn.deterministic, cudnn.benchmark)) or run_epoch(*a))
            cudnn.deterministic, cudnn.benchmark = False, True
            tr.run(2)
            assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
            assert seen == [(True, False) if flag else (False, True)] * 2
            # also when an epoch raises
            tr.engine.run_epoch = lambda *a: 1 / 0
            with pytest.raises(ZeroDivisionError):
                tr.run(3)
            assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
