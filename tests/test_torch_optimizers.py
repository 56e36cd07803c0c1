"""PyTorch port, the optimizers against ``repro.optim.make_optimizer``.

- one and five updates of SGD (Nesterov), AdamW, RMSProp and Adafactor
  (the reference's defaults, and weight decay) on the same seeded params
  and grads: parameters and state within 1e-6 of each tensor's largest
  entry (one ulp of a cancelling ``p - lr * step`` is large against a small
  result, so the bound scales with the tensor, not the entry).  A 4-D
  tensor is a conv weight, HWIO in the reference and OIHW in the port, as
  ``cnn.params_from_jax`` lays it out; Adafactor's factored state has the
  reference's shapes;
- AdamW, RMSProp and Adafactor training the small CNN for two epochs from
  the JAX ``Trainer``'s initial params and permutations: per-epoch train
  loss within 1e-4 relative and the final parameters within 1e-5 of each
  tensor's largest entry;
- the reference's quadratic contract (``test_optimizers_reduce_quadratic``);
- ``state_dict`` hands out the live tensors and ``load_state_dict`` copies
  into them in place; ``reset`` zeroes them;
- each optimizer trains a scanned epoch bit-identical to the host loop on
  the CPU (where ``_dispatch``'s address check runs too), and restarts
  bit-exactly from a checkpoint under both engines;
- AdamW's update in groups of parameters (``GROUP_BYTES``) gives the bits
  of one group.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.core import LRSchedule as JLRSchedule
from repro.core import planops as jplanops
from repro.data import SyntheticClassification as JSynthetic
from repro.models import cnn as jcnn
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import LRSchedule
from repro_torch.data import SyntheticClassification
from repro_torch.models import cnn
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainConfig

SHAPES = {"a": (3, 3, 4, 5), "b": (7,), "c": (6, 4)}
CASES = {
    "sgd": {"momentum": 0.9, "nesterov": True},
    "sgd-wd": {"momentum": 0.9, "weight_decay": 1e-3},
    "adamw": {},
    "adamw-nowd": {"weight_decay": 0.0},
    "rmsprop": {},
    "rmsprop-wd": {"weight_decay": 1e-3},
    "adafactor": {},
    "adafactor-wd": {"weight_decay": 1e-3},
}


def _close(got: np.ndarray, want: np.ndarray, tag: str,
           rel: float = 1e-6) -> None:
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=tag)


def _port(x) -> np.ndarray:
    """A reference tensor in the port's layout: conv HWIO -> OIHW."""
    x = np.asarray(x)
    return np.ascontiguousarray(np.transpose(x, (3, 2, 0, 1))
                                if x.ndim == 4 else x)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_updates_match_reference(case, steps):
    name, hp = case.split("-")[0], CASES[case]
    r = np.random.default_rng(len(case) + steps)
    init = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jopt = jmake_optimizer(name, **hp)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = jopt.init(jp)
    keys = sorted(init)
    params = [torch.nn.Parameter(torch.from_numpy(_port(init[k]))) for k in keys]
    opt = make_optimizer(name, params, **hp)
    assert opt.name == name
    lr = torch.tensor(0.05)
    for _ in range(steps):
        g = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                             jnp.float32(0.05))
        for p, k in zip(params, keys):
            p.grad = torch.from_numpy(_port(g[k]))
        opt.step(lr)
    for p, k in zip(params, keys):
        _close(p.detach().numpy(), _port(jp[k]), f"{case} {k}")
    # the state, leaf for leaf where the trees line up
    sd = opt.state_dict()
    if name == "sgd":
        for b, k in zip(sd["momentum"], keys):
            _close(b.numpy(), _port(js[k]), f"{case} momentum {k}")
    elif name in ("adamw", "rmsprop"):
        for f in ("m", "v"):
            for b, k in zip(sd[f], keys):
                _close(b.numpy(), _port(js[f][k]), f"{case} {f} {k}")
    else:
        for s, k in zip(sd["s"], keys):
            for f, v in s.items():
                want = np.asarray(js["s"][k][f])
                assert v.shape == want.shape, (case, f, k)
                _close(v.numpy(), want, f"{case} {f} {k}")
    if "t" in sd:
        assert int(sd["t"]) == int(js["t"]) == steps


@pytest.mark.parametrize("name,hp", [
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("adamw", {}),
    ("rmsprop", {}),
    ("adafactor", {}),
])
def test_optimizers_reduce_quadratic(name, hp):
    params = [torch.nn.Parameter(torch.tensor([5.0, -3.0])),
              torch.nn.Parameter(torch.tensor([[1.0, 2.0], [3.0, 4.0]]))]
    opt = make_optimizer(name, params, **hp)

    def loss():
        return sum((p ** 2).sum() for p in params)

    l0 = float(loss().detach())
    for _ in range(50):
        opt.zero_grad()
        loss().backward()
        opt.step(torch.tensor(0.05))
    assert float(loss().detach()) < 0.5 * l0


@pytest.mark.parametrize("name", ["sgd", "adamw", "rmsprop", "adafactor"])
def test_state_dict_in_place_and_reset(name):
    hp = {"momentum": 0.9} if name == "sgd" else {}
    params = [torch.nn.Parameter(torch.randn(4, 3)),
              torch.nn.Parameter(torch.randn(5))]
    opt = make_optimizer(name, params, **hp)
    for _ in range(2):
        for p in params:
            p.grad = torch.randn_like(p)
        opt.step(0.01)
    held = opt.state_tensors()
    assert held and all(a is b for a, b in zip(
        held, [t for _, t in ckpt.flatten(opt.state_dict())]))
    snap = {p: ckpt.to_numpy(t).copy() for p, t in ckpt.flatten(opt.state_dict())}
    ptrs = [t.data_ptr() for t in held]
    opt.reset()
    assert all(not t.any() for t in held)
    opt.load_state_dict(ckpt._unflatten(opt.state_dict(), iter(snap.values())))
    assert [t.data_ptr() for t in opt.state_tensors()] == ptrs
    for p, t in ckpt.flatten(opt.state_dict()):
        assert np.array_equal(ckpt.to_numpy(t), snap[p]), p
    with pytest.raises(ValueError):
        make_optimizer("lamb", params)


def _trainer(name, engine, seed=0, ckpt_dir=None):
    ds = SyntheticClassification(num_samples=192, image_size=8, seed=0)
    tc = TrainConfig(epochs=2, batch_size=32, strategy="kakurenbo",
                     engine=engine, scan_steps=4, fused_scoring=True,
                     optimizer=name, optimizer_hp={}, seed=seed,
                     lr=LRSchedule(1e-3, "cosine", 2, 1),
                     checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
                     checkpoint_every=1 if ckpt_dir else 0)
    model = cnn.CNN(cnn.CNNConfig(image_size=8, widths=(8,), hidden=16),
                    torch.Generator().manual_seed(seed))
    return Trainer(tc, model, None, ds, logits_fn=lambda m, b: m(b["images"]),
                   device="cpu")


def _state(tr):
    return {p: ckpt.to_numpy(v).copy() for p, v in ckpt.flatten(tr._ckpt_tree())}


@pytest.mark.parametrize("name", ["adamw", "rmsprop", "adafactor"])
def test_scan_matches_host_and_restarts(name, tmp_path):
    runs = {}
    for engine in ("scan", "host"):
        tr = _trainer(name, engine)
        assert tr.engine.name == engine
        hist = tr.run()
        runs[engine] = ([h.train_loss for h in hist], _state(tr))
    assert runs["scan"][0] == runs["host"][0]
    for k, v in runs["scan"][1].items():
        assert v.tobytes() == runs["host"][1][k].tobytes(), k
    assert any(k.startswith("/opt_state/") for k in runs["scan"][1])
    for engine in ("scan", "host"):
        d = tmp_path / engine
        with pytest.raises(RuntimeError, match="injected"):
            _trainer(name, engine, ckpt_dir=d).run(fail_at_epoch=1)
        tr = _trainer(name, engine, seed=5, ckpt_dir=d)
        assert tr.restore_latest() and tr.epoch == 1
        hist = tr.run()
        assert hist[-1].train_loss == runs[engine][0][-1]
        for k, v in _state(tr).items():
            assert v.tobytes() == runs[engine][1][k].tobytes(), (engine, k)


CNN_SMALL = dict(image_size=8, widths=(8, 16), hidden=32)
CNN_N, CNN_BATCH, CNN_EPOCHS = 192, 64, 2


@pytest.mark.parametrize("name", ["adamw", "rmsprop", "adafactor"])
def test_cnn_run_matches_jax_trainer(name):
    jcfg = jcnn.CNNConfig(**CNN_SMALL)
    common = dict(epochs=CNN_EPOCHS, batch_size=CNN_BATCH, strategy="baseline",
                  fused_scoring=True, optimizer=name, optimizer_hp={}, seed=0)
    jtr = JTrainer(
        JTrainConfig(lr=JLRSchedule(0.01, "cosine", CNN_EPOCHS, 1), **common),
        lambda rng: jcnn.init(rng, jcfg), None,
        JSynthetic(num_samples=CNN_N, image_size=8, seed=0),
        logits_fn=lambda p, b: jcnn.forward(p, jcfg, b["images"]))
    init = {k: np.array(v) for k, v in jtr.params.items()}
    jhist = jtr.run()

    tcfg = cnn.CNNConfig(**CNN_SMALL)
    model = cnn.CNN(tcfg)
    model.load_state_dict(cnn.params_from_jax(init, tcfg))
    tr = Trainer(TrainConfig(lr=LRSchedule(0.01, "cosine", CNN_EPOCHS, 1),
                             **common),
                 model, None,
                 SyntheticClassification(num_samples=CNN_N, image_size=8, seed=0),
                 logits_fn=lambda m, b: m(b["images"]), device="cpu")
    key, perms = jplanops.strategy_key(0, "baseline"), []
    for _ in range(CNN_EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(
            jax.random.permutation(sub, CNN_N))))
    it = iter(perms)
    tr.strategy.draw_permutation = lambda: next(it)
    thist = tr.run()

    for e, (h, j) in enumerate(zip(thist, jhist)):
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4), e
    want = cnn.params_from_jax({k: np.array(v) for k, v in jtr.params.items()},
                               tcfg)
    for k, v in model.state_dict().items():
        _close(v.numpy(), want[k].numpy(), f"{name} {k}", rel=1e-5)


def test_adamw_in_groups_is_bit_identical(monkeypatch):
    """AdamW updates in groups of at most ``GROUP_BYTES`` of parameters (its
    temporaries bounded for a model near the card's size): the same bits
    as one group, and the groups cover every parameter once, in order."""
    from repro_torch.optim import optimizers
    r = np.random.default_rng(0)
    shapes = [(7, 5), (40,), (3, 4, 6), (1,), (64, 2)]

    def run():
        ps = [torch.nn.Parameter(torch.from_numpy(
            r.normal(size=s).astype(np.float32))) for s in shapes]
        opt = make_optimizer("adamw", ps, weight_decay=0.1)
        for step in range(3):
            for p in ps:
                p.grad = torch.from_numpy(
                    np.random.default_rng(step).normal(size=p.shape)
                    .astype(np.float32))
            opt.step(1e-2)
        return [p.detach().clone() for p in ps] + opt.state_tensors()

    one = run()
    r = np.random.default_rng(0)
    monkeypatch.setattr(optimizers, "GROUP_BYTES", 300)
    sizes = [4 * int(np.prod(s)) for s in shapes]
    groups = optimizers._groups(
        [torch.empty(s) for s in shapes], optimizers.GROUP_BYTES)
    assert groups == [[0, 1], [2, 3], [4]]            # 140+160, 288+4, 512
    assert sizes[4] > 300                             # a larger tensor alone
    for a, b in zip(one, run()):
        assert torch.equal(a, b)
