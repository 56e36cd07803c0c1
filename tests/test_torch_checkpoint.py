"""PyTorch port, checkpoint and restart.

- restart is bit-exact for the seven strategies under both engines: a run
  crashes before epoch 2, a trainer built from another seed (other weights,
  other generator seeds) restores the epoch-boundary checkpoint and
  finishes; its parameters, momentum, strategy arrays (generator states
  included) and last loss equal the uninterrupted run's
  (``tests/test_chaos.py::test_chaos_restart_bit_exact`` and
  ``tests/test_scan_engine.py::test_scan_checkpoint_restart_bit_exact`` of
  the reference);
- a crash between two blocks of the scanned engine leaves a live state
  (``state_dict`` works) and the restart from the last checkpoint replays
  the uninterrupted run (``test_scan_mid_epoch_crash_checkpoint_restart``);
- a resumed run draws the uninterrupted run's epoch permutation and hidden
  set (``test_resume_preserves_epoch_permutation``);
- a restore copies into the trainer's tensors in place;
- the checkpoint protocol, as ``tests/test_train_fault.py`` holds the
  reference's: CRC corruption, uncommitted steps ignored, async save and
  its failure, fallback with quarantine, all corrupt re-raises, structure
  mismatch without quarantine, save retries and their exhaustion.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import ForgetConfig, KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticClassification
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig

SMALL = dict(image_size=8, widths=(8,), hidden=16)
N, BATCH, EPOCHS = 256, 32, 4
STRATEGIES = ("baseline", "forget", "infobatch", "iswr", "kakurenbo",
              "random", "sb")


def make(engine: str, strategy: str = "kakurenbo", *, seed: int = 0,
         ckpt_dir=None, **tc_kw) -> Trainer:
    """A small fused-scoring trainer checkpointing every epoch; FORGET
    prunes and restarts at epoch 2, KAKURENBO hides from epoch 1."""
    ds = SyntheticClassification(num_samples=N, image_size=8, seed=0)
    tc = TrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy=strategy, engine=engine,
        scan_steps=3, fused_scoring=True,
        lr=LRSchedule(0.1, "cosine", EPOCHS, 1),
        kakurenbo=KakurenboConfig(selection="histogram_pallas", tau=0.2,
                                  max_fraction=0.3,
                                  fraction_milestones=(0, 2, 3, 4)),
        forget=ForgetConfig(fraction=0.3, warmup_epochs=2), seed=seed,
        checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
        checkpoint_every=1 if ckpt_dir else 0, **tc_kw)
    model = cnn.CNN(cnn.CNNConfig(**SMALL), torch.Generator().manual_seed(seed))
    return Trainer(tc, model, None, ds, ds.test_split(64),
                   logits_fn=lambda m, b: m(b["images"]), device="cpu")


def final_state(tr: Trainer) -> dict:
    tree = tr._ckpt_tree()
    return {p: ckpt.to_numpy(v).copy() for p, v in ckpt.flatten(tree)}


def assert_same(tr_a: Trainer, tr_b: Trainer, tag=""):
    a, b = final_state(tr_a), final_state(tr_b)
    assert a.keys() == b.keys(), tag
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag} {k}")
    assert tr_a.history[-1].train_loss == tr_b.history[-1].train_loss, tag


@pytest.mark.parametrize("engine", ["scan", "host"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_restart_bit_exact(strategy, engine, tmp_path):
    ref = make(engine, strategy)
    ref.run()
    crashed = make(engine, strategy, ckpt_dir=tmp_path)
    with pytest.raises(RuntimeError, match="injected"):
        crashed.run(fail_at_epoch=2)
    assert ckpt.latest_step(str(tmp_path)) == 2
    tr = make(engine, strategy, seed=99, ckpt_dir=tmp_path)
    assert tr.restore_latest() and tr.epoch == 2
    tr.run()
    assert_same(tr, ref, f"{strategy}/{engine}")
    assert [h.epoch for h in tr.history] == [2, 3]
    assert tr.history[-1].test_acc == ref.history[-1].test_acc


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scan_crash_between_blocks_then_restart(strategy, tmp_path):
    ref = make("scan", strategy)
    ref.run()
    tr = make("scan", strategy, ckpt_dir=tmp_path)
    tr.run(2)
    dispatch, calls = tr.engine._dispatch, {"n": 0}

    def bomb(size, weighted):
        if calls["n"] >= 1:
            raise RuntimeError("injected mid-epoch failure")
        calls["n"] += 1
        dispatch(size, weighted)

    tr.engine._dispatch = bomb
    with pytest.raises(RuntimeError, match="mid-epoch"):
        tr.run_epoch(2)
    assert calls["n"] == 1                # one block trained before the crash
    # checkpoint on fault: the state after that block saves and reads back
    tree = tr._ckpt_tree(tr.strategy.state_dict())
    ckpt.save(str(tmp_path / "fault"), 2, tree)
    back, _ = ckpt.restore(str(tmp_path / "fault"), 2, tree)
    for (p, a), (_, b) in zip(ckpt.flatten(tree), ckpt.flatten(back)):
        np.testing.assert_array_equal(ckpt.to_numpy(a), b, err_msg=p)
    tr2 = make("scan", strategy, seed=99, ckpt_dir=tmp_path)
    assert tr2.restore_latest() and tr2.epoch == 2
    tr2.run()
    assert_same(tr2, ref, strategy)


def test_resume_preserves_epoch_permutation(tmp_path):
    ref = make("scan", ckpt_dir=tmp_path)
    ref.run(2)
    tr = make("scan", seed=99, ckpt_dir=tmp_path)      # restore must win
    assert tr.restore_latest() and tr.epoch == 2
    p_ref, p_res = ref.strategy.plan(2), tr.strategy.plan(2)
    np.testing.assert_array_equal(p_ref.visible_indices, p_res.visible_indices)
    np.testing.assert_array_equal(p_ref.hidden_indices, p_res.hidden_indices)
    assert len(p_ref.hidden_indices) > 0
    assert p_ref.lr_scale == p_res.lr_scale
    assert torch.equal(ref.strategy.state.hidden, tr.strategy.state.hidden)


def test_restore_copies_in_place_and_async_saves(tmp_path):
    """The restored trainer keeps every tensor it had (a captured step
    holds their addresses); ``async_checkpoint`` saves on a thread and
    keeps three checkpoints."""
    ref = make("scan", "sb", ckpt_dir=tmp_path / "a", async_checkpoint=True)
    ref.run()
    assert sorted(os.listdir(tmp_path / "a")) == [
        f"step_{s:010d}" for s in (2, 3, 4)]
    tr = make("scan", "sb", seed=5, ckpt_dir=tmp_path / "a")
    tr.run(1)
    held = [t.data_ptr() for t in (*tr.model.parameters(), *tr.opt.bufs,
                                   *tr.strategy.step_tensors())]
    assert tr.restore_latest() and tr.epoch == EPOCHS
    assert held == [t.data_ptr() for t in (*tr.model.parameters(),
                                           *tr.opt.bufs,
                                           *tr.strategy.step_tensors())]
    for k, v in final_state(ref).items():
        np.testing.assert_array_equal(final_state(tr)[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def failing_leaf_writes(fail: int):
    """Make the first ``fail`` leaf writes raise ``OSError`` (-1: all)."""
    calls = {"n": 0}
    write = ckpt._write_leaf

    def flaky(path, arr):
        calls["n"] += 1
        if fail < 0 or calls["n"] <= fail:
            raise OSError(f"injected write failure #{calls['n']}")
        write(path, arr)

    ckpt._write_leaf = flaky
    try:
        yield calls
    finally:
        ckpt._write_leaf = write


def _corrupt_leaf(directory, step):
    f = f"{directory}/step_{step:010d}/leaf_00000.npy"
    np.save(f, np.load(f) + 1)     # payload change under an intact manifest


def test_checkpoint_integrity_detects_corruption(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": np.ones((3, 3))}}
    path = ckpt.save(str(tmp_path), 1, tree)
    restored, _ = ckpt.restore(str(tmp_path), 1, tree)
    np.testing.assert_array_equal(restored["b"]["c"], np.ones((3, 3)))
    f = path + "/leaf_00000.npy"
    arr = np.load(f)
    arr[0] = 999.0
    np.save(f, arr)
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 1, tree)


def test_checkpoint_uncommitted_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.arange(4.0)})
    os.makedirs(str(tmp_path / "step_0000000002"))
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_async_checkpoint(tmp_path):
    tree = {"a": torch.arange(16.0), "b": [torch.ones(2), torch.zeros(3)]}
    h = ckpt.save_async(str(tmp_path), 3, tree)
    tree["a"].add_(1.0)            # the snapshot was taken before this
    h.join()
    assert h.result().endswith("step_0000000003")
    restored, _ = ckpt.restore(str(tmp_path), 3, tree)
    np.testing.assert_array_equal(restored["a"], np.arange(16.0))
    like = {"a": torch.zeros(16), "b": [torch.empty(2), torch.empty(3)]}
    ckpt.copy_into(like, restored)
    assert torch.equal(like["b"][0], torch.ones(2))


def test_save_async_failure_propagates(tmp_path):
    with failing_leaf_writes(fail=-1):
        h = ckpt.save_async(str(tmp_path), 1, {"a": torch.arange(4.0)})
        assert isinstance(h.exception(), OSError)
        with pytest.raises(OSError):
            h.join()


def test_restore_latest_falls_back_and_quarantines(tmp_path):
    tree = {"a": torch.arange(8.0)}
    ckpt.save(str(tmp_path), 1, {"a": torch.arange(8.0) * 1})
    ckpt.save(str(tmp_path), 2, {"a": torch.arange(8.0) * 2})
    _corrupt_leaf(str(tmp_path), 2)
    restored, _, step = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 1
    np.testing.assert_array_equal(restored["a"], np.arange(8.0))
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert (tmp_path / "corrupt_step_0000000002").is_dir()


def test_restore_latest_reraises_when_all_corrupt(tmp_path):
    tree = {"a": torch.arange(8.0)}
    ckpt.save(str(tmp_path), 1, tree)
    _corrupt_leaf(str(tmp_path), 1)
    with pytest.raises(IOError):
        ckpt.restore_latest(str(tmp_path), tree)


def test_restore_latest_structure_mismatch_no_quarantine(tmp_path):
    like = {"a": torch.arange(8.0)}
    ckpt.save(str(tmp_path), 1, like)
    ckpt.save(str(tmp_path), 2, {"a": torch.arange(8.0), "b": torch.zeros(2)})
    ckpt.save(str(tmp_path), 3, {"a": torch.arange(9.0)})    # other shape
    _, _, step = ckpt.restore_latest(str(tmp_path), like)
    assert step == 1
    assert ckpt.latest_step(str(tmp_path)) == 3      # nothing quarantined


def test_save_retries_transient_oserror(tmp_path):
    tree = {"a": torch.arange(8.0), "b": torch.ones(3)}
    sleeps = []
    with failing_leaf_writes(fail=1) as calls:
        path = ckpt.save(str(tmp_path), 1, tree, _sleep=sleeps.append)
    # attempt 1 died on leaf 0; attempt 2 wrote both leaves from scratch
    assert calls["n"] == 3 and sleeps == [0.05]
    restored, _ = ckpt.restore(str(tmp_path), 1, tree)
    np.testing.assert_array_equal(restored["a"], np.arange(8.0))
    assert path.endswith("step_0000000001")


def test_save_raises_after_retries_exhausted(tmp_path):
    with failing_leaf_writes(fail=-1):
        with pytest.raises(OSError):
            ckpt.save(str(tmp_path), 1, {"a": torch.arange(4.0)},
                      _sleep=lambda s: None)
    assert ckpt.latest_step(str(tmp_path)) is None


def test_trainer_restore_without_checkpoint(tmp_path):
    assert not make("scan").restore_latest()                 # no directory
    assert not make("scan", ckpt_dir=tmp_path).restore_latest()
