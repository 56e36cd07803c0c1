"""The plain reference against the port on reduced configurations, on the
CPU: logits, per-sample metrics and every leaf's gradient; and a whole
run of each cell at a tiny size comes out correct."""
import numpy as np
import pytest
import torch

from h100_bench import run, weights
from h100_bench.reference import lm as ref
from h100_bench.session import Session
from h100_bench.tests.tiny import tiny, workloads


@pytest.mark.parametrize("workload", ["mamba2-130m.kakurenbo",
                                      "qwen3-1.7b-l7.kakurenbo"])
def test_reference_matches_port(workload):
    cell = tiny(workload)
    sess = Session(cell, 12345, "cpu")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in sess.corpus.get(np.arange(4)).items()}
    model = sess.trainer.model
    scalar, (loss, pa, pc) = model.loss_and_metrics(batch)
    grads = torch.autograd.grad(scalar, list(model.parameters()))
    w = {n: p.detach().clone().requires_grad_(True)
         for n, p in model.named_parameters()}
    r_loss, r_pa, r_pc = ref.per_sample(cell.arch, w, batch)
    r_grads = torch.autograd.grad(r_loss.mean(), list(w.values()))
    torch.testing.assert_close(loss.detach(), r_loss.detach(), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(pc, r_pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(pa, r_pa)
    for name, g, rg in zip(w, grads, r_grads):
        scale = float(rg.abs().max()) + 1e-12
        assert float((g - rg).abs().max()) <= 1e-4 * scale, name


def test_weights_draw_again_alike():
    arch = tiny("qwen3-1.7b-l7.kakurenbo").arch
    a = weights.make(arch, 2**40 + 3, "cpu")
    b = weights.make(arch, 2**40 + 3, "cpu")
    c = weights.make(arch, 2**40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


def test_plan_reference():
    loss = np.array([3.0, 1.0, 2.0, 1.0, 5.0], np.float32)
    seen = np.array([0, 0, 0, -1, 0], np.int32)
    hidden, vis, hid, factor = ref.plan(loss, seen, np.array([4, 3, 2, 1, 0]),
                                        0.5, False)
    # floor(0.5 * 5) = 2 lowest by stable rank: samples 1 and 3; 3 unseen.
    assert hidden.tolist() == [False, True, False, False, False]
    assert vis.tolist() == [4, 3, 2, 0] and hid.tolist() == [1]
    assert factor == float(np.float32(1) / (np.float32(1) - np.float32(0.2)))


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_is_correct(workload, traced):
    line = run.run(tiny(workload), 2**40 + 11, 0.3, traced, "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    if traced:
        assert "step_mfu" in line["metrics"] and "bwd_share" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"samples_per_s", "peak_mem_gib",
                                        "setup_s"}
    assert list(line)[-1] == "checks"
