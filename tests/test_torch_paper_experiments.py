"""PyTorch port, the paper's remaining experiments against the reference.

- the sections' logic (Table 5, Table 6, Fig. 2, Fig. 4): the reference's
  module (``benchmarks/*.py``) and the port's
  (``repro_torch.experiments.*``) given one fake ``run_strategy`` that
  returns the same canned runs (a NaN accuracy, a KAKURENBO run that never
  reaches 0.9 x the baseline's best, an epoch of 0 s): the same stdout line
  for line, and the same runs requested in the same order (strategy,
  KAKURENBO config, epochs);
- the sections' training: every Table 5 tau, every Table 6 variant and its
  baseline, 5 epochs of the port's Table 2 harness (small CNN, N = 256)
  against the reference's ``benchmarks/common.py::run_strategy`` at the
  same sizes, from the reference's initial parameters and with its
  permutations: every epoch's plan, sample counts, hidden fraction and
  test accuracy exactly, train loss within 1e-4 relative, LR within 1e-6
  relative (the cosine's ulps, ROADMAP C);
- the driver, ``examples/torch_paper_reproduction.py``: its registry
  listing equals the reference's, ``--quick`` writes its CSV, and the full
  run's sections are the reference's in order, without ``selection``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
# The reference harness lives in benchmarks/ at the root, as
# examples/paper_reproduction.py finds it.
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common  # noqa: E402
from benchmarks import fig2_speedup, fig4_fraction, table5_tau, table6_ablation  # noqa: E402
from repro.core import KakurenboConfig as JKakurenboConfig  # noqa: E402
from repro.core import planops as jplanops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.experiments import fig2, fig4, table2, table5, table6  # noqa: E402
from repro_torch.kernels.threshold_select import fraction_count  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

#: section -> (reference module, port module)
SECTIONS = {"table5": (table5_tau, table5), "table6": (table6_ablation, table6),
            "fig2": (fig2_speedup, fig2), "fig4": (fig4_fraction, fig4)}


# ---------------------------------------------------------------------------
# The sections' logic, on canned runs
# ---------------------------------------------------------------------------

def _config_dict(cfg):
    if cfg is None:
        return None
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _canned(call: int, epochs: int) -> dict:
    """Run ``call``'s results, from a generator seeded by the call's
    position: the first run has a NaN accuracy and reaches 0.8; the second
    stays below 0.3 (under 0.9 x the first's best) and has an epoch of 0 s."""
    r = np.random.default_rng(1000 + call)
    acc = r.uniform(0.3, 0.7, epochs)
    wall = r.uniform(0.05, 0.5, epochs)
    if call == 0:
        acc[1], acc[-1] = np.nan, 0.8
    if call == 1:
        acc = r.uniform(0.1, 0.3, epochs)
        wall[2] = 0.0
    fwd = r.integers(900, 1025, epochs)
    bwd = np.minimum(fwd, r.integers(600, 1025, epochs))
    hist = [types.SimpleNamespace(
        epoch=e, train_loss=float(r.exponential()), test_acc=float(acc[e]),
        hidden_fraction=float(r.uniform(0, 0.4)), fwd_samples=int(fwd[e]),
        bwd_samples=int(bwd[e]), lr=0.03, wall_time=float(wall[e]))
        for e in range(epochs)]
    return {"history": hist, "wall_s": float(wall.sum() + r.uniform(0, 0.1)),
            "final_acc": hist[-1].test_acc,
            "best_acc": max(h.test_acc for h in hist if h.test_acc == h.test_acc),
            "fwd": int(fwd.sum()), "bwd": int(bwd.sum())}


class FakeRuns:
    """A ``run_strategy`` that records its calls and returns canned runs."""

    def __init__(self):
        self.calls = []

    def __call__(self, strategy, *, epochs=common.EPOCHS, kakurenbo=None,
                 **kw):
        self.calls.append((strategy, _config_dict(kakurenbo), epochs))
        return _canned(len(self.calls) - 1, epochs)


@pytest.mark.parametrize("section", list(SECTIONS))
def test_section_prints_the_reference_rows(section, monkeypatch):
    ref_mod, port_mod = SECTIONS[section]
    ref, port = FakeRuns(), FakeRuns()
    monkeypatch.setattr(ref_mod, "run_strategy", ref)
    monkeypatch.setattr(port_mod, "run_strategy", port)
    want, got = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        ref_mod.main()
    with contextlib.redirect_stdout(got):
        port_mod.main([])
    want, got = want.getvalue().splitlines(), got.getvalue().splitlines()
    assert got == want
    assert port.calls == ref.calls
    assert len(got) == {"table5": 3, "table6": 9, "fig2": 2,
                        "fig4": common.EPOCHS}[section]
    text = "\n".join(got)
    if section == "fig2":
        assert "acc=nans" in text                      # never reached
    if section == "fig4":
        assert "epoch_speedup=nan" in text             # an epoch of 0 s


# ---------------------------------------------------------------------------
# The sections' training, against the reference harness
# ---------------------------------------------------------------------------

N, EPOCHS = 256, 5
SMALL = dict(image_size=16, widths=(8, 16), hidden=32)

#: case -> (strategy, the port's KAKURENBO config or None)
TRAIN_CASES = {"table6-baseline": ("baseline", None)}
TRAIN_CASES.update({f"table5-tau={tau}": ("kakurenbo", table5.config(tau))
                    for tau in table5.TAUS})
TRAIN_CASES.update({f"table6-{tag}": ("kakurenbo", table6.config(mb, rf, lr))
                    for tag, mb, rf, lr in table6.VARIANTS})


def _perms(name):
    key, out = jplanops.strategy_key(0, name), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.permutation(sub, N))))
    return out


def _record_plans(tr):
    plans, plan = [], tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return plans


def _reference_run(monkeypatch, strategy, kcfg):
    """``benchmarks/common.py::run_strategy`` at N = 256 on the small CNN
    (its module globals, read at call time), its ``Trainer`` captured for
    the initial parameters and the plans."""
    monkeypatch.setattr(common, "MODEL_CFG", jcnn.CNNConfig(**SMALL))
    monkeypatch.setattr(common, "NUM_SAMPLES", N)
    seen = {}

    class Captured(common.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["init"] = {n: np.array(v) for n, v in self.params.items()}
            seen["plans"] = _record_plans(self)

    monkeypatch.setattr(common, "Trainer", Captured)
    jk = None if kcfg is None else JKakurenboConfig(**dataclasses.asdict(kcfg))
    res = common.run_strategy(strategy, epochs=EPOCHS, kakurenbo=jk)
    return res, seen["init"], seen["plans"]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_section_run_matches_reference_harness(case, monkeypatch):
    strategy, kcfg = TRAIN_CASES[case]
    jres, init, jplans = _reference_run(monkeypatch, strategy, kcfg)
    # The reference's test split is 512 (benchmarks/common.py::datasets).
    tr = table2.make_trainer(strategy, model_cfg=cnn.CNNConfig(**SMALL), n=N,
                             n_test=512, epochs=EPOCHS, kakurenbo=kcfg,
                             device="cpu")
    tr.model.load_state_dict(cnn.params_from_jax(init, tr.model.cfg))
    tr._init_weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
    perms = iter(_perms(strategy))
    target = tr.strategy if strategy == "baseline" else tr.strategy._inner
    target.draw_permutation = lambda: next(perms)
    tplans = _record_plans(tr)
    thist = tr.run()
    jhist = jres["history"]
    assert len(thist) == len(jhist) == len(tplans) == len(jplans) == EPOCHS
    for e, (h, j, tp, jp) in enumerate(zip(thist, jhist, tplans, jplans)):
        assert np.array_equal(tp.visible_indices, jp.visible_indices), e
        assert np.array_equal(tp.hidden_indices, jp.hidden_indices), e
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples), e
        assert h.hidden_fraction == j.hidden_fraction, e
        assert h.test_acc == j.test_acc, e
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4), e
        assert h.lr == pytest.approx(j.lr, rel=1e-6), e
    if kcfg is not None and not kcfg.moveback:
        # Move-back off: from epoch 1 on (all seen), the schedule's count.
        sched = tr.strategy._inner._fraction_schedule
        assert [len(p.hidden_indices) for p in tplans[1:]] == [
            int(fraction_count(sched(e), N, "cpu")) for e in range(1, EPOCHS)]


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace("/", "_"), ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_driver_lists_the_reference_registry():
    want, got = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        _load("paper_reproduction").list_strategies()
    with contextlib.redirect_stdout(got):
        _load("torch_paper_reproduction").main(["--list-strategies",
                                                "--device", "cpu"])
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) == 8


def test_driver_quick_writes_the_csv(tmp_path):
    out = tmp_path / "sub" / "quick.csv"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load("torch_paper_reproduction").main(
            ["--quick", "--device", "cpu", "--n", "256", "--n-test", "128",
             "--epochs", "2", "--out", str(out)])
    lines = buf.getvalue().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [ln for ln in lines[1:] if ln]
    assert rows[-1] == f"wrote {out}"
    rows = rows[:-1]
    assert [r.split(",")[0] for r in rows] == (
        [f"table2/{s}" for s in table2.STRATEGIES] + ["fig4/epoch0", "fig4/epoch1"])
    assert out.read_text().splitlines() == [lines[0]] + rows


def test_driver_runs_the_reference_sections_in_order(monkeypatch, tmp_path):
    """The full run's sections, in the reference's order, without
    ``selection`` (the port's timing harness is still to come)."""
    ref = _load("paper_reproduction")
    port = _load("torch_paper_reproduction")
    order = {"ref": [], "port": []}
    for mod in ref.__dict__.values():
        if isinstance(mod, types.ModuleType) and mod.__name__.startswith("benchmarks."):
            monkeypatch.setattr(mod, "main", lambda m=mod: order["ref"].append(
                m.__name__.split(".")[-1]))
    for mod in port.SECTIONS:
        monkeypatch.setattr(mod, "main", lambda argv, m=mod: order["port"].append(
            m.__name__.split(".")[-1]))
    monkeypatch.setattr(sys, "argv", ["paper_reproduction.py", "--out",
                                      str(tmp_path / "ref.csv")])
    with contextlib.redirect_stdout(io.StringIO()):
        ref.main()
        port.main(["--out", str(tmp_path / "port.csv")])
    names = {"table2_accuracy": "table2", "table3_gradmatch": "table3",
             "table5_tau": "table5", "table6_ablation": "table6",
             "fig2_speedup": "fig2", "fig4_fraction": "fig4"}
    assert order["ref"][-1] == "selection_overhead"
    assert order["port"] == [names[m] for m in order["ref"][:-1]]
