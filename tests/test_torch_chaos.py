"""PyTorch port, the chaos suite: ``tests/test_chaos.py``'s contracts.

- a crash in the middle of epoch 1 (``CrashAtStep``), recovered by the
  supervisor (``fault.run_with_restarts``) from the epoch-1 checkpoint,
  ends bit-identical to a run that never crashed (parameters, optimizer
  state, the strategy's arrays and generators): the eight strategies under
  both engines;
- the injector's accounting: the host loop crashes before step 4, the
  scanned engine (``scan_steps=2``) before the block covering it, after 3;
- a corrupt newest checkpoint falls back to the prior step, quarantined and
  logged, and the run resumes; the injector's bit-rot is CRC-detectable;
- a transient save failure is retried, a dead disk raises, an async save
  failure fails the run, a healthy async run round-trips;
- a slow simulated worker is flagged and sheds rows without dropping work;
  uniform latencies leave the run bit-identical.
"""
from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import ForgetConfig, KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticClassification
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig, chaos, fault

SMALL = dict(image_size=8, widths=(8,), hidden=16)
ALL_STRATEGIES = ("baseline", "forget", "gradmatch", "infobatch", "iswr",
                  "kakurenbo", "random", "sb")
ENGINES = ("host", "scan")


def _mk(engine, strategy="kakurenbo", epochs=3, num_samples=192, seed=0,
        checkpoint_dir=None, ds=None, **tc_kw) -> Trainer:
    """The reference suite's trainer: 3 batches of 64 an epoch, blocks of
    2 steps, KAKURENBO hiding from epoch 1, FORGET pruning at epoch 2."""
    ds = ds or SyntheticClassification(num_samples=num_samples, image_size=8,
                                       seed=0)
    tc = TrainConfig(
        epochs=epochs, batch_size=64, strategy=strategy, engine=engine,
        fused_scoring=True, lr=LRSchedule(0.05, "cosine", epochs, 1),
        kakurenbo=KakurenboConfig(max_fraction=0.3, tau=0.2,
                                  fraction_milestones=(0, 1, 2, 3)),
        forget=ForgetConfig(fraction=0.3, warmup_epochs=2),
        seed=seed, checkpoint_dir=checkpoint_dir,
        checkpoint_every=1 if checkpoint_dir else 0, scan_steps=2, **tc_kw)
    model = cnn.CNN(cnn.CNNConfig(**SMALL), torch.Generator().manual_seed(seed))
    return Trainer(tc, model, None, ds, logits_fn=lambda m, b: m(b["images"]),
                   device="cpu")


def _state(tr: Trainer) -> dict:
    return {p: ckpt.to_numpy(v).copy() for p, v in ckpt.flatten(tr._ckpt_tree())}


def _assert_state_equal(tr_a: Trainer, tr_b: Trainer, tag: str) -> None:
    a, b = _state(tr_a), _state(tr_b)
    assert a.keys() == b.keys(), tag
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), f"{tag} {k}"


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_crash_recovery_bit_exact(strategy, engine, tmp_path):
    tag = f"{strategy}/{engine}"
    ref = _mk(engine, strategy)
    ref.run(3)
    builds = []

    def make():
        tr = _mk(engine, strategy, checkpoint_dir=str(tmp_path / "ckpt"))
        builds.append(tr)
        if len(builds) == 1:
            # 3 steps an epoch: step 4 lies inside epoch 1.
            chaos.CrashAtStep(4).install(tr)
        return tr

    tr, restarts = fault.run_with_restarts(make, 3, sleep_fn=lambda s: None)
    assert restarts == 1 and len(builds) == 2 and builds[0] is not tr, tag
    assert builds[0].epoch == 1 and tr.epoch == 3, tag
    assert tr.engine.name == engine, tag
    _assert_state_equal(ref, tr, tag)
    assert tr.history[-1].train_loss == ref.history[-1].train_loss, tag


def test_crash_injector_fires_where_told(tmp_path):
    tr = _mk("host", "baseline", checkpoint_dir=str(tmp_path / "h"))
    bomb = chaos.CrashAtStep(4).install(tr)
    with pytest.raises(chaos.ChaosError):
        tr.run(3)
    assert bomb.fired and bomb.steps_done == 4
    assert tr.epoch == 1                  # epoch 0 completed and saved
    tr = _mk("scan", "baseline", checkpoint_dir=str(tmp_path / "s"))
    bomb = chaos.CrashAtStep(4).install(tr)
    with pytest.raises(chaos.ChaosError):
        tr.run(3)
    # epoch 1's first block covers steps 3-4: the crash comes before it
    assert bomb.fired and bomb.steps_done == 3
    assert tr.epoch == 1
    assert fault.classify_failure(chaos.ChaosError("x")) == "restartable"


def test_corrupt_newest_checkpoint_falls_back(tmp_path, caplog):
    cdir = str(tmp_path / "ckpt")
    _mk("scan", "kakurenbo", checkpoint_dir=cdir).run(3)   # steps 1, 2, 3
    chaos.corrupt_checkpoint_leaf(cdir)                     # newest: 3
    tr = _mk("scan", "kakurenbo", checkpoint_dir=cdir)
    with caplog.at_level(logging.WARNING, logger="repro_torch.checkpoint"):
        assert tr.restore_latest()
    assert tr.epoch == 2
    assert any("quarantined" in m for m in caplog.messages)
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert "corrupt_step_0000000003" in names
    assert ckpt.latest_step(cdir) == 2
    tr.run(3)
    assert tr.epoch == 3


def test_corruption_injector_is_crc_detectable(tmp_path):
    tree = {"a": torch.arange(64.0)}
    ckpt.save(str(tmp_path), 5, tree)
    chaos.corrupt_checkpoint_leaf(str(tmp_path), seed=1)
    assert ckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 5, tree)


def test_save_retry_and_dead_disk(tmp_path):
    tr = _mk("scan", "baseline", checkpoint_dir=str(tmp_path / "ckpt"),
             epochs=1)
    tr.run(1)
    with chaos.failing_leaf_writes(fail=1) as calls:
        path = tr.save_checkpoint()
    assert path is not None and calls["n"] > 1
    restored = _mk("scan", "baseline", checkpoint_dir=str(tmp_path / "ckpt"),
                   epochs=1)
    assert restored.restore_latest()
    with chaos.failing_leaf_writes(fail=-1):
        with pytest.raises(OSError):
            tr.save_checkpoint()


def test_async_save_failure_surfaces_in_run(tmp_path):
    tr = _mk("scan", "baseline", checkpoint_dir=str(tmp_path / "ckpt"),
             epochs=2, async_checkpoint=True)
    with chaos.failing_leaf_writes(fail=-1):
        with pytest.raises(OSError):
            tr.run(2)


def test_async_checkpoint_trainer_roundtrip(tmp_path):
    cdir = str(tmp_path / "ckpt")
    tr = _mk("scan", "kakurenbo", checkpoint_dir=cdir, async_checkpoint=True)
    tr.run(3)
    assert tr._pending_save is None
    assert ckpt.latest_step(cdir) == 3
    tr2 = _mk("scan", "kakurenbo", checkpoint_dir=cdir)
    assert tr2.restore_latest() and tr2.epoch == 3
    _assert_state_equal(tr, tr2, "async")


def test_slow_shard_triggers_rebalance(caplog):
    tr = _mk("scan", "baseline", num_samples=512, straggler_mitigation=True,
             straggler_workers=4)
    tr.shard_latency_fn = chaos.SlowShard(world_size=4, rank=1, factor=5.0)
    plans, plan = [], tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    orders, run_epoch = [], tr.engine.run_epoch
    tr.engine.run_epoch = lambda e, idx, p, lr: (orders.append(idx)
                                                 or run_epoch(e, idx, p, lr))
    with caplog.at_level(logging.WARNING, logger="repro_torch.train"):
        hist = tr.run(3)
    assert list(tr._straggler.stragglers()) == [False, True, False, False]
    assert any("straggler mitigation" in m for m in caplog.messages)
    # epoch 0 trains the plan as drawn; later epochs re-slice it, moving
    # rows without dropping or repeating any
    assert np.array_equal(orders[0], plans[0].visible_indices)
    for o, p in zip(orders[1:], plans[1:]):
        assert not np.array_equal(o, p.visible_indices)
        assert np.array_equal(np.sort(o), np.sort(p.visible_indices))
    ref = _mk("scan", "baseline", num_samples=512)
    assert [h.fwd_samples for h in hist] == [h.fwd_samples for h in ref.run(3)]


def test_straggler_mitigation_uniform_latency_is_bit_exact():
    mon = _mk("scan", "kakurenbo", straggler_mitigation=True,
              straggler_workers=4)
    ref = _mk("scan", "kakurenbo")
    mon.run(3)
    ref.run(3)
    _assert_state_equal(ref, mon, "uniform-latency")
    assert not mon._straggler.stragglers().any()
    # the port has no mesh: no straggler_workers means a world of one
    assert _mk("scan", straggler_mitigation=True)._straggler.world_size == 1
