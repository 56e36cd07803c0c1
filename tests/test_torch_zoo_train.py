"""PyTorch port, KAKURENBO LM training on the model zoo's MoE and hybrid.

Reduced phi3.5-moe-42b-a6.6b and hymba-1.5b (at 4 layers, so that one is
windowed), as ``tests/test_torch_lm_train.py`` holds smollm-135m and
mamba2-130m:

- 3 KAKURENBO epochs through the default (scanned) engine against the JAX
  ``Trainer`` running ``Model.loss_and_metrics`` (the MoE's loss with its
  router aux term), from the reference's initial parameters (under the
  conditioning controls of ``tests/test_torch_lm.py``) and the shuffles
  ``KakurenboSampler.begin_epoch`` draws: every epoch's plan equal, the
  per-epoch train loss within 1e-4 relative, and some epoch hides
  sequences (hymba at LR 1e-3, see ``LR``);
- on the MoE at a capacity factor of 0.5, where every step drops routed
  choices: the scanned engine bit-identical to the host loop (losses,
  plans, every parameter and AdamW state tensor), and a crash between two
  blocks restored into a trainer built from other weights ending
  bit-identical to the uninterrupted run;
- ``examples/torch_lm_train.py --arch phi3.5-moe-42b-a6.6b --device cpu``
  with a depth cut, and hymba-1.5b through it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import planops as jplanops
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_arch
from repro_torch.core import KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticLM
from repro_torch.models import LM, moe, transformer
from repro_torch.train import Trainer, TrainConfig

MOE, HYMBA = "phi3.5-moe-42b-a6.6b", "hymba-1.5b"
SEQ, BATCH, EPOCHS, TAU = 16, 16, 3, 0.2
#: Samples and base LR per arch.  Hymba at the reference's LR of 1e-2 is
#: chaotic in float32 at this size: a run from weights changed by 1e-7
#: relative parts from the reference by 2e-3 in an epoch's loss, so no
#: 1e-4 comparison could hold there; at 1e-3 (as chip_smoke's card-vs-CPU
#: LM runs take for mamba2-130m) that control moves it by 3e-5, and 128
#: sequences give it the steps to hide some by epoch 3.
N = {MOE: 64, HYMBA: 128}
LR = {MOE: 1e-2, HYMBA: 1e-3}
KAKURENBO = dict(max_fraction=0.3, tau=TAU,
                 fraction_milestones=(0, EPOCHS // 3, EPOCHS // 2,
                                      3 * EPOCHS // 4))


def _cfg(get, arch: str, capacity_factor: float | None = None):
    cfg = get(arch).reduced()
    if arch == HYMBA:
        cfg = dataclasses.replace(cfg, num_layers=4)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _condition(params: dict, cfg) -> dict:
    """The conditioning controls on a numpy tree: attention projections at
    their input's fan-in, ``a_log`` U[0, 1)."""
    params = jax.tree.map(np.array, params)
    layers = params["layers"]
    a, dh = layers["attn"], cfg.resolved_head_dim
    for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                      ("wv", cfg.d_model), ("wo", cfg.num_heads * dh)):
        a[name] = a[name] * np.float32((a[name].shape[-2] / fan) ** 0.5)
    if "ssm" in layers:
        layers["ssm"]["a_log"] = np.random.default_rng(0).uniform(
            0, 1, layers["ssm"]["a_log"].shape).astype(np.float32)
    return params


def _dataset(cls, n: int):
    return cls(num_samples=n, seq_len=SEQ, vocab_size=64, order=1,
               easy_fraction=0.7, seed=0)


def _recording(trainer):
    plans, plan = [], trainer.strategy.plan
    trainer.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return plans


def _run_jax(arch: str):
    cfg = _cfg(get_arch, arch)
    jm = jbuild_model(_cfg(jget_arch, arch))
    tc = JTrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo",
        optimizer="adamw", optimizer_hp={},
        lr=JLRSchedule(LR[arch], "cosine", EPOCHS, 1),
        kakurenbo=JKakurenboConfig(**KAKURENBO), seed=0)

    def loss_fn(params, batch):
        return jm.loss_and_metrics(
            params, {k: jnp.asarray(v) for k, v in batch.items()})

    tr = JTrainer(tc, lambda rng: jax.tree.map(
        jnp.asarray, _condition(jm.init(rng), cfg)), loss_fn,
        _dataset(JSyntheticLM, N[arch]), None)
    init = jax.tree.map(np.asarray, tr.params)
    plans = _recording(tr)
    return init, tr.run(), plans


def _reference_perms(n: int):
    key, perms = jplanops.strategy_key(0, "kakurenbo"), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, n))))
    return perms


def make(arch: str = MOE, *, engine: str = "auto", seed: int = 0,
         params: dict | None = None, capacity_factor: float | None = None,
         **tc_kw) -> Trainer:
    cfg = _cfg(get_arch, arch, capacity_factor)
    tc = TrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo",
        optimizer="adamw", optimizer_hp={}, engine=engine,
        lr=LRSchedule(LR[arch], "cosine", EPOCHS, 1),
        kakurenbo=KakurenboConfig(**KAKURENBO), seed=seed, **tc_kw)
    model = (LM(cfg, transformer.params_from_jax(params, "cpu")) if params
             else LM.init(cfg, torch.Generator().manual_seed(seed), "cpu"))
    return Trainer(tc, model, lambda m, b: m.loss_and_metrics(b),
                   _dataset(SyntheticLM, N[arch]), None, device="cpu")


@pytest.mark.parametrize("arch", [MOE, HYMBA])
def test_kakurenbo_matches_jax_trainer(arch):
    init, jhist, jplans = _run_jax(arch)
    tr = make(arch, params=init)
    assert tr.engine.name == "scan"
    perms = iter(_reference_perms(N[arch]))
    tr.strategy._inner.draw_permutation = lambda: next(perms)
    plans = _recording(tr)
    hist = tr.run()
    assert any(len(p.hidden_indices) for p in plans), "no epoch hid anything"
    for h, j, tp, jp in zip(hist, jhist, plans, jplans):
        assert h.hidden_fraction == j.hidden_fraction
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples)
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4)
        np.testing.assert_array_equal(tp.visible_indices, jp.visible_indices)
        np.testing.assert_array_equal(tp.hidden_indices, jp.hidden_indices)
    assert hist[-1].train_loss < hist[0].train_loss


def _state(tr: Trainer) -> dict:
    return {p: ckpt.to_numpy(v).copy()
            for p, v in ckpt.flatten(tr._ckpt_tree())}


def _assert_same(a: Trainer, b: Trainer, pa=None, pb=None):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert ([h.train_loss for h in a.history]
            == [h.train_loss for h in b.history][-len(a.history):])
    for x, y in zip(pa or (), pb or ()):
        np.testing.assert_array_equal(x.visible_indices, y.visible_indices)
        np.testing.assert_array_equal(x.hidden_indices, y.hidden_indices)


@pytest.fixture
def drops(monkeypatch):
    """The number of routed choices each MoE call drops."""
    seen, route = [], moe.route

    def counted(*args):
        r = route(*args)
        seen.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(moe, "route", counted)
    return seen


def test_moe_scan_bit_identical_to_host_loop_under_overflow(drops):
    runs = {}
    for engine in ("host", "scan"):
        tr = make(engine=engine, scan_steps=3, capacity_factor=0.5)
        runs[engine] = (tr, _recording(tr))
        tr.run()
    (host, ph), (scan, ps) = runs["host"], runs["scan"]
    assert (host.engine.name, scan.engine.name) == ("host", "scan")
    assert drops and min(drops) > 0, "a step routed every choice"
    _assert_same(host, scan, ph, ps)


def test_moe_restart_between_blocks_is_bit_exact(tmp_path, drops):
    ref = make(scan_steps=3, capacity_factor=0.5)
    ref.run()
    tr = make(scan_steps=3, capacity_factor=0.5, checkpoint_dir=str(tmp_path),
              checkpoint_every=1)
    tr.run(2)
    dispatch, calls = tr.engine._dispatch, [0]

    def crash(size, weighted):
        if calls[0] == 1:
            raise RuntimeError("injected failure between blocks")
        calls[0] += 1
        dispatch(size, weighted)

    tr.engine._dispatch = crash
    with pytest.raises(RuntimeError, match="between blocks"):
        tr.run_epoch(2)
    again = make(seed=7, scan_steps=3, capacity_factor=0.5,
                 checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert again.restore_latest() and again.epoch == 2
    again.run()
    assert min(drops) > 0
    _assert_same(again, ref)


EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "torch_lm_train.py"


def _example():
    spec = importlib.util.spec_from_file_location("torch_lm_train", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,layers", [(MOE, 1), (HYMBA, 4)])
def test_example_runs_on_cpu(arch, layers, capsys):
    hist = _example().main(["--arch", arch, "--device", "cpu", "--steps", "8",
                            "--num-samples", "32", "--batch", "8",
                            "--seq-len", "8", "--layers", str(layers),
                            "--ckpt-dir", ""])
    assert len(hist) == 2 and all(np.isfinite(h.train_loss) for h in hist)
    assert f"arch={arch} (reduced) layers={layers}" in capsys.readouterr().out
