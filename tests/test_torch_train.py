"""PyTorch port, model and trainer against the JAX package.

- the CNN forward from ``params_from_jax`` against ``repro.models.cnn``;
- three ``SGD`` steps against ``repro.optim.sgd``;
- the slice end to end: the JAX trainer and the port's, both KAKURENBO with
  ``fused_scoring=True`` and ``"histogram_pallas"``, from the JAX trainer's
  initial params and with the shuffles ``KakurenboSampler.begin_epoch``
  draws from ``planops.strategy_key(0, "kakurenbo")``.  Per-epoch train loss
  within 1e-4 relative, the final SampleState's loss/PC within 1e-4 and
  PA/seen exact, and the per-epoch hidden sets equal — with tau and the LR
  chosen so that some epoch hides samples.
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
from repro.models import cnn as jcnn
from repro.optim import sgd as jsgd
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.core import KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticClassification
from repro_torch.models import cnn
from repro_torch.optim import SGD
from repro_torch.train import TrainConfig, Trainer

SMALL = dict(image_size=8, widths=(8, 16), hidden=32)


def _jax_params(cfg, seed=0):
    params = jcnn.init(jax.random.key(seed), cfg)
    return {k: np.array(v) for k, v in params.items()}


def _torch_model(np_params, cfg):
    model = cnn.CNN(cfg)
    model.load_state_dict(cnn.params_from_jax(np_params, cfg))
    return model


@pytest.mark.parametrize("kw", [SMALL, dict(image_size=16, widths=(32, 64),
                                            hidden=128)])
def test_cnn_forward_matches_jax(kw):
    jcfg, tcfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
    np_params = _jax_params(jcfg)
    x = np.random.default_rng(0).normal(
        size=(4, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
    want = np.asarray(jcnn.forward(np_params, jcfg, jnp.asarray(x)))
    got = _torch_model(np_params, tcfg)(torch.from_numpy(x))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_per_sample_metrics_matches_jax():
    r = np.random.default_rng(1)
    lg = (r.normal(size=(32, 10)) * 3).astype(np.float32)
    lab = r.integers(0, 10, 32).astype(np.int32)
    want = jcnn.per_sample_metrics(jnp.asarray(lg), jnp.asarray(lab))
    got = cnn.per_sample_metrics(torch.from_numpy(lg), torch.from_numpy(lab))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)


@pytest.mark.parametrize("hp", [dict(momentum=0.9),
                                dict(momentum=0.9, nesterov=True),
                                dict(momentum=0.9, weight_decay=5e-4),
                                dict()])
def test_sgd_three_steps_match_jax(hp):
    r = np.random.default_rng(2)
    params = {"a": r.normal(size=(5, 3)).astype(np.float32),
              "b": r.normal(size=(3,)).astype(np.float32)}
    grads = [{k: r.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    lrs = [0.1, 0.05, 0.0125]
    opt = jsgd(**hp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = SGD(tp.values(), **hp)
    for g, lr in zip(grads, lrs):
        jp, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step(lr)
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

N, BATCH, EPOCHS = 256, 32, 3


def _logits_jax(cfg):
    return lambda params, batch: jcnn.forward(params, cfg, batch["images"])


def _run_jax():
    jcfg = jcnn.CNNConfig(**SMALL)
    tc = JTrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo", fused_scoring=True,
        lr=JLRSchedule(0.1, "cosine", EPOCHS, 1),
        kakurenbo=JKakurenboConfig(selection="histogram_pallas", tau=0.2,
                                   max_fraction=0.3), seed=0)
    ds = JSynthetic(num_samples=N, image_size=8, seed=0)
    tr = JTrainer(tc, lambda rng: jcnn.init(rng, jcfg), None, ds, None,
                  logits_fn=_logits_jax(jcfg))
    init = {k: np.array(v) for k, v in tr.params.items()}
    hidden = []
    plan = tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: hidden.append(p.hidden_indices) or p)(plan(e))
    hist = tr.run()
    st = tr.strategy.state
    return init, hist, hidden, {k: np.asarray(getattr(st, k))
                                for k in ("loss", "pa", "pc", "seen")}


def _reference_perms():
    """The shuffles ``KakurenboSampler.begin_epoch`` draws, in order."""
    key, perms = jplanops.strategy_key(0, "kakurenbo"), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, N))))
    return perms


def test_end_to_end_matches_jax_trainer():
    init, jhist, jhidden, jstate = _run_jax()
    tcfg = cnn.CNNConfig(**SMALL)
    tc = TrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo", fused_scoring=True,
        lr=LRSchedule(0.1, "cosine", EPOCHS, 1),
        kakurenbo=KakurenboConfig(selection="histogram_pallas", tau=0.2,
                                  max_fraction=0.3), seed=0)
    ds = SyntheticClassification(num_samples=N, image_size=8, seed=0)
    tr = Trainer(tc, _torch_model(init, tcfg), None, ds,
                 logits_fn=lambda model, batch: model(batch["images"]),
                 device="cpu")
    perms = iter(_reference_perms())
    sampler = tr.strategy._inner
    sampler.draw_permutation = lambda: next(perms)
    hidden = []
    plan = tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: hidden.append(p.hidden_indices) or p)(plan(e))
    thist = tr.run()

    assert any(h.hidden_fraction > 0 for h in thist), "no epoch hid anything"
    for h, j in zip(thist, jhist):
        assert h.hidden_fraction == j.hidden_fraction
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples)
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4)
    for a, b in zip(hidden, jhidden):
        assert np.array_equal(a, b)
    st = sampler.state
    np.testing.assert_allclose(st.loss.numpy(), jstate["loss"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.pc.numpy(), jstate["pc"], rtol=1e-4, atol=1e-4)
    assert np.array_equal(st.pa.numpy(), jstate["pa"])
    assert np.array_equal(st.seen.numpy(), jstate["seen"])


def test_data_copy_is_byte_identical():
    a = SyntheticClassification(num_samples=64, image_size=8, seed=3)
    b = JSynthetic(num_samples=64, image_size=8, seed=3)
    idx = np.array([0, 5, 63, 17])
    for x, y in ((a.get(idx), b.get(idx)),
                 (a.test_split(16).get(idx[:2]), b.test_split(16).get(idx[:2]))):
        assert x["images"].tobytes() == y["images"].tobytes()
        assert np.array_equal(x["labels"], y["labels"])


def test_trainer_requires_logits_fn_or_loss_fn():
    ds = SyntheticClassification(num_samples=64, image_size=8, seed=0)
    model = cnn.CNN(cnn.CNNConfig(**SMALL))
    with pytest.raises(ValueError, match="logits_fn"):
        Trainer(TrainConfig(fused_scoring=True), model, None, ds, device="cpu")
    with pytest.raises(ValueError, match="loss_fn"):
        Trainer(TrainConfig(), model, None, ds, device="cpu")


def test_trainer_with_model_metrics_and_baseline():
    """The unfused path (the caller's loss_fn) and the baseline strategy."""
    ds = SyntheticClassification(num_samples=128, image_size=8, seed=0)

    def loss_fn(model, batch):
        loss, pa, pc = cnn.per_sample_metrics(model(batch["images"]),
                                              batch["labels"])
        return loss.mean(), (loss, pa, pc)

    for strategy in ("baseline", "kakurenbo"):
        tr = Trainer(TrainConfig(epochs=2, batch_size=32, strategy=strategy),
                     cnn.CNN(cnn.CNNConfig(**SMALL),
                             torch.Generator().manual_seed(0)),
                     loss_fn, ds, ds.test_split(64), device="cpu")
        hist = tr.run()
        assert all(np.isfinite(h.train_loss) and 0 <= h.test_acc <= 1
                   for h in hist)
        assert [h.bwd_samples for h in hist] == [128, 128]
