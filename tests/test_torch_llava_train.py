"""PyTorch port, the trainer's gradient for a parameter the loss does not
reach: zeros, as the reference's ``jax.grad`` of the whole tree gives.

Reduced llava-next-mistral-7b trains on text alone (as both packages'
``lm_train`` examples do), so its ``mm_proj`` is outside the loss; AdamW's
weight decay still moves it a step.  Through
``examples/torch_lm_train.py::make_trainer`` (the scanned engine), from the
reference's initial parameters (attention projections at their input's
fan-in, ``tests/test_torch_zoo_train.py``'s control) and with the
reference's shuffles:

- every leaf, ``mm_proj`` included, within 1e-4 relative of the JAX
  ``Trainer``'s (the zoo's band for LM training) after 4 KAKURENBO epochs,
  the per-epoch losses too, and ``mm_proj`` moved;
- a ``mesh_shape=(1,)`` run (a gloo world of one, one backward and an
  all-reduce a step) equal to the one-device run bit for bit, both in one
  spawned process on one thread.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_arch as jget_arch
from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import planops as jplanops
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.launch.mesh import spawn

import torch_model_axis_scenarios as sc

ARCH = "llava-next-mistral-7b"
STEPS, N, BATCH, SEQ = 16, 64, 16, 16
EPOCHS = STEPS // (N // BATCH)
KW = dict(steps=STEPS, num_samples=N, batch=BATCH, seq_len=SEQ)


def _condition(params: dict, cfg) -> dict:
    params = jax.tree.map(np.array, params)
    a, dh = params["layers"]["attn"], cfg.resolved_head_dim
    for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                      ("wv", cfg.d_model), ("wo", cfg.num_heads * dh)):
        a[name] = a[name] * np.float32((a[name].shape[-2] / fan) ** 0.5)
    return params


@pytest.fixture(scope="module")
def runs():
    """The JAX Trainer as ``examples/lm_train.py`` sets it up, its initial
    tree and shuffles, and the port's two runs from them."""
    jcfg = jget_arch(ARCH).reduced()
    jm = jbuild_model(jcfg)
    tc = JTrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo",
        optimizer="adamw", optimizer_hp={},
        lr=JLRSchedule(1e-2, "cosine", EPOCHS, 1),
        kakurenbo=JKakurenboConfig(
            max_fraction=0.3,
            fraction_milestones=(0, EPOCHS // 3, EPOCHS // 2,
                                 3 * EPOCHS // 4)), seed=0)

    def loss_fn(params, batch):
        return jm.loss_and_metrics(
            params, {k: jnp.asarray(v) for k, v in batch.items()})

    jtr = JTrainer(tc, lambda rng: jax.tree.map(
        jnp.asarray, _condition(jm.init(rng), jcfg)), loss_fn,
        JSyntheticLM(num_samples=N, seq_len=SEQ, vocab_size=64, order=1,
                     easy_fraction=0.7, seed=0), None)
    init = jax.tree.map(np.asarray, jtr.params)
    jhist = jtr.run()
    key, perms = jplanops.strategy_key(0, "kakurenbo"), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(np.array(jax.random.permutation(sub, N)))
    port = spawn(sc.llava_world, 1, "gloo", "cpu", (init, perms, KW))[0]
    return init, jhist, jax.tree.map(np.asarray, jtr.params), port


def _jax_leaf(tree: dict, name: str) -> np.ndarray:
    """A port parameter name (``layers.1.attn.wq``) in the reference's
    stacked tree."""
    parts = name.split(".")
    if parts[0] == "layers":
        leaf = tree["layers"]
        for p in parts[2:]:
            leaf = leaf[p]
        return leaf[int(parts[1])]
    return tree[parts[0]]


def test_every_leaf_matches_jax_trainer(runs):
    init, jhist, jparams, port = runs
    one = port["one"]
    assert len(one["loss"]) == len(jhist) == EPOCHS
    for got, h in zip(one["loss"], jhist):
        assert got == pytest.approx(h.train_loss, rel=1e-4)
    for name, got in one["params"].items():
        want = _jax_leaf(jparams, name)
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= 1e-4 * scale, (name, err, scale)
    moved = np.abs(one["params"]["mm_proj"] - init["mm_proj"]).max()
    assert moved > 0, "mm_proj did not move: its gradient was never set"


def test_world_one_equals_one_device(runs):
    port = runs[3]
    one, mesh = port["one"], port["mesh"]
    assert one["loss"] == mesh["loss"]
    assert one["hidden"] == mesh["hidden"]
    assert one["params"].keys() == mesh["params"].keys()
    for k, v in one["params"].items():
        np.testing.assert_array_equal(v, mesh["params"][k], err_msg=k)
