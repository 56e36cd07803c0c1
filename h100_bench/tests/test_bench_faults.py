"""A whole run with the timed path broken underneath comes out not
correct, once for each fault a cell can have (the look for a chip
skipped, at a tiny size on the CPU): a step that leaves the state
unchanged, half of the batch left out of the mean, an answer of the
refresh altered where it is written, the plan altered."""
import functools

import numpy as np
import pytest

from h100_bench import run
from h100_bench.tests.tiny import tiny, workloads


def frozen_step(monkeypatch):
    from repro_torch.optim.optimizers import AdamW
    monkeypatch.setattr(AdamW, "_update", lambda self, *a: None)


def half_batch(monkeypatch):
    from repro_torch.models.model import LM
    orig = LM.loss_and_metrics

    def half(self, batch):
        scalar, (loss, pa, pc) = orig(self, batch)
        return loss[: loss.shape[0] // 2].mean(), (loss, pa, pc)
    monkeypatch.setattr(LM, "loss_and_metrics", half)


def refresh_altered(monkeypatch):
    from repro_torch.core.kakurenbo import KakurenboSampler
    orig = KakurenboSampler.observe

    def observe(self, indices, loss, pa, pc, epoch):
        return orig(self, indices, loss * 1.01, pa, pc, epoch)
    monkeypatch.setattr(KakurenboSampler, "observe", observe)


def obs_altered(monkeypatch):
    from repro_torch.core.kakurenbo import KakurenboStrategy
    orig = KakurenboStrategy.__init__

    @functools.wraps(orig)
    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        fused = self.fused_observe

        def altered(state, indices, loss, *rest, **kw):
            return fused(state, indices, loss * 1.01, *rest, **kw)
        self.fused_observe = altered
    monkeypatch.setattr(KakurenboStrategy, "__init__", init)


def lr_unscaled(monkeypatch):
    from repro_torch.train.engines import ScanEpochEngine
    orig = ScanEpochEngine.run_epoch

    def run_epoch(self, epoch, indices, plan, lr):
        self.tr.lr_dev.fill_(lr / plan.lr_scale)
        return orig(self, epoch, indices, plan, lr)
    monkeypatch.setattr(ScanEpochEngine, "run_epoch", run_epoch)


def plan_altered(monkeypatch):
    from repro_torch.core.kakurenbo import KakurenboSampler
    orig = KakurenboSampler.begin_epoch

    def begin(self, epoch):
        plan = orig(self, epoch)
        v = np.array(plan.visible_indices)
        v[[0, 1]] = v[[1, 0]]
        plan.visible_indices = v
        return plan
    monkeypatch.setattr(KakurenboSampler, "begin_epoch", begin)


#: Each fault, and the check that a cell needs for it to apply.
FAULTS = {"frozen_step": (frozen_step, "train"),
          "half_batch": (half_batch, "train"),
          "obs_altered": (obs_altered, "obs"),
          "refresh_altered": (refresh_altered, "obs"),
          "lr_unscaled": (lr_unscaled, "plan"),
          "plan_altered": (plan_altered, "plan")}


def cases():
    return [(w, name) for w in workloads() for name, (_, needs) in
            FAULTS.items() if needs in tiny(w).traffic["checks"]]


@pytest.mark.parametrize("workload, fault", cases())
def test_fault_is_not_correct(monkeypatch, workload, fault):
    FAULTS[fault][0](monkeypatch)
    line = run.run(tiny(workload), 2**40 + 21, 0.3, False, "cpu")
    assert not line["correct"], line["checks"]
