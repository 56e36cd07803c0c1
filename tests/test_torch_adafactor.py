"""PyTorch port, Adafactor over the reference's stacked layer leaves.

The reference keeps each layer stack as one ``(L, ...)`` leaf and runs
``adafactor()`` over that tree; the port trains per-layer tensors.
``launch/train.py::optimizer_for`` hands ``Adafactor`` the stacks
(``stack_groups``), and each is updated as the one leaf:

- the reference's ``adafactor()`` on a stacked tree (a 3-D and a 4-D
  stack, a stack of vectors, a matrix and a vector of their own), with
  and without weight decay, against the port on the per-layer lists:
  after 1 and 5 updates every parameter and every ``r``/``c``/``v`` within
  1e-6 of each tensor's largest entry, the state in the reference's
  shapes;
- the live state of ``optimizer_for`` on a model's shards has the shapes
  (and dtype) of ``launch/train.py::abstract_train_state``'s;
- one device: three steps of ``make_train_step`` with Adafactor on
  ``dense-d`` (LR 1e-2) and ``moe-d`` (LR 1e-3, ``LR`` says why) within
  1e-5 of the JAX ``make_train_step`` with ``make_optimizer("adafactor")``
  on the stacked tree.

The sharded update is ``tests/test_torch_dryrun.py``'s gloo world.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.launch.train import (_opt_abstract, make_train_step,
                                      optimizer_for, stack_groups)
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.optim import make_optimizer

L = 3
#: The stacked tree: the leaves of ``layers`` are (L, ...) stacks.
TREE = {"embed": (6, 4), "out": (4,),
        "layers": {"w": (L, 4, 5), "n": (L, 4), "q": (L, 4, 2, 3)}}


def _draw(r, shapes):
    if isinstance(shapes, dict):
        return {k: _draw(r, v) for k, v in shapes.items()}
    return r.normal(size=shapes).astype(np.float32)


def _per_layer(tree: dict) -> dict:
    out = dict(tree)
    out["layers"] = [{k: v[i] for k, v in tree["layers"].items()}
                     for i in range(L)]
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.nn.Parameter(torch.from_numpy(tree.copy()))


def _stacked_state(js) -> list[dict]:
    """The reference's state leaves in ``flatten``'s order of the stacked
    tree (the port's logical leaves)."""
    s = js["s"]
    return [s["embed"], *(s["layers"][k] for k in sorted(s["layers"])),
            s["out"]]


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_stacked_leaves_match_reference(wd, steps):
    r = np.random.default_rng(steps + int(wd * 1e4))
    init = _draw(r, TREE)
    hp = {"weight_decay": wd} if wd else {}
    jopt = jmake_optimizer("adafactor", **hp)
    jp = jax.tree.map(jnp.asarray, init)
    js = jopt.init(jp)
    tree = _tensors(_per_layer(init))
    leaves = [t for _, t in flatten(tree)]
    opt = make_optimizer("adafactor", leaves, stacks=stack_groups(tree), **hp)
    for _ in range(steps):
        g = _draw(r, TREE)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.float32(0.1))
        for t, (_, a) in zip(leaves, flatten(_per_layer(g))):
            t.grad = torch.from_numpy(a.copy())
        opt.step(0.1)
    want = dict(flatten(_per_layer(jax.tree.map(np.asarray, jp))))
    for path, t in flatten(tree):
        w = want[path]
        np.testing.assert_allclose(
            t.detach().numpy(), w, rtol=0,
            atol=1e-6 * float(np.abs(w).max()), err_msg=path)
    got = opt.state_dict()
    assert len(got["s"]) == 5
    for mine, ref in zip(got["s"], _stacked_state(js)):
        assert mine.keys() == ref.keys()
        for f, v in mine.items():
            w = np.asarray(ref[f])
            assert tuple(v.shape) == w.shape, (f, v.shape, w.shape)
            np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                       atol=1e-6 * float(np.abs(w).max()))
    assert int(got["t"]) == int(js["t"]) == steps


DENSE = dict(name="dense-d", family="dense", num_layers=2, d_model=64,
             num_heads=8, num_kv_heads=4, d_ff=128, vocab_size=256,
             head_dim=16, qk_norm=True, optimizer="adafactor")
MOE = dict(name="moe-d", family="moe", num_layers=2, d_model=64, num_heads=8,
           num_kv_heads=4, d_ff=0, vocab_size=256, head_dim=16,
           optimizer="adafactor")


def _configs():
    return {"dense-d": (ArchConfig(**DENSE), JArchConfig(**DENSE)),
            "moe-d": (ArchConfig(**MOE, moe=MoEConfig(8, 2, 64,
                                                      capacity_factor=8.0)),
                      JArchConfig(**MOE, moe=JMoEConfig(8, 2, 64,
                                                        capacity_factor=8.0)))}


def test_live_state_has_the_abstract_shapes():
    """``optimizer_for``'s state on a model's per-layer tree: the shapes
    and dtypes ``abstract_train_state`` describes (the stacked tree's)."""
    for cfg, _ in _configs().values():
        model = build_model(cfg, device="cpu")
        local = model.shard(model.init(torch.Generator().manual_seed(0)))
        opt = optimizer_for(cfg, local)
        want = _opt_abstract("adafactor", model.abstract_params(torch.float32),
                             True)
        got = [(tuple(t.shape), t.dtype) for t in opt.state_tensors()]
        assert got == [(tuple(t.shape), t.dtype) for _, t in flatten(want)]


B, S = 8, 32


def _setup(arch):
    cfg, jcfg = _configs()[arch]
    jm = jbuild_model(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 256, (B, S)).astype(np.int32),
             "mask": np.ones((B, S), bool)}
    model = build_model(cfg, device="cpu")
    local = transformer.params_from_jax(params, shard=model)
    for _, t in flatten(local):
        t.requires_grad_(True)
    return cfg, jm, params, batch, model, local


#: The LR each model's three steps run at.  At 1e-2 moe-d's trajectories
#: part within three steps, the port's from JAX's and the mesh's from one
#: device's alike (parameters 1.4e-6, 4.9e-5, then 2.3e-2 apart: an
#: expert choice flips; Adafactor's factored normalisation gives the rows
#: of small, summation-order-sensitive gradients updates of order the LR).
LR = {"dense-d": 1e-2, "moe-d": 1e-3}


@pytest.mark.parametrize("arch", ["dense-d", "moe-d"])
def test_one_device_matches_jax_train_step(arch):
    """Three steps of the port's ``make_train_step`` with
    ``optimizer_for``'s Adafactor (``moe-d``: its (L, E, d, ff) expert
    stacks) within 1e-5 of the JAX ``make_train_step`` on the stacked
    tree, the losses too."""
    cfg, jm, params, batch, model, local = _setup(arch)
    jopt = jmake_optimizer("adafactor")
    jstep = jax.jit(jtrain.make_train_step(jm, jopt))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    step = make_train_step(model, optimizer_for(cfg, local))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jp, js, jloss, _ = jstep(jp, js, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                 jnp.float32(LR[arch]))
        loss, _ = step(local, tb, LR[arch])
        assert abs(float(loss) - float(jloss)) <= 1e-5
    want = dict(flatten(_per_layer_n(jax.tree.map(np.asarray, jp))))
    for path, t in flatten(local):
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=0,
                                   atol=1e-5, err_msg=path)


def _per_layer_n(tree: dict) -> dict:
    out = dict(tree)
    layers = tree["layers"]
    n = jax.tree.leaves(layers)[0].shape[0]
    out["layers"] = [jax.tree.map(lambda a: a[i], layers) for i in range(n)]
    return out
