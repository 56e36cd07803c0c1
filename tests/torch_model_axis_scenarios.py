"""Scenarios of the port's model axis, run in every rank of a gloo world
on the CPU (``tests/test_torch_model_axis.py``).

A world of 8 ranks is spawned once (``repro_torch.launch.mesh.spawn``); in
it each case builds its ``("data", "model")`` mesh
(``launch/mesh.py::make_data_model_mesh``) and context
(``launch/train.py::build_ctx``), takes this rank's shards of the given
global parameters (``Model.shard``), and runs one step of
``make_train_step`` at LR 0 (SGD: nothing moves), so that every
parameter's ``grad`` is its reduced gradient; the gradients and the
step's loss and per-sample metrics are gathered back whole
(``Model.gather``).  Each rank runs PyTorch on one thread.  This module
imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.launch.mesh import make_data_model_mesh
from repro_torch.launch.train import build_ctx, make_train_step
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import SGD


def _batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def grads_step(cfg, ctx, params: dict, batch: dict) -> dict:
    """One LR-0 step of ``make_train_step`` on ``ctx``'s shards (None: one
    device): the loss, the per-sample (loss, PA, PC) and every leaf's
    gradient, whole, as numpy, keyed by ``checkpoint.flatten``'s paths."""
    model = build_model(cfg, ctx, device="cpu")
    local = transformer.params_from_jax(params, shard=model)
    leaves = [t for _, t in flatten(local)]
    for t in leaves:
        t.requires_grad_(True)
    loss, (lv, pa, pc) = make_train_step(model, SGD(leaves))(
        local, _batch(batch), 0.0)
    grads = model.gather(_grad_tree(local))
    return {"loss": float(loss), "lv": lv.numpy(), "pa": pa.numpy(),
            "pc": pc.numpy(),
            "grads": {k: v.numpy() for k, v in flatten(grads)},
            "local_shapes": [tuple(t.shape) for t in leaves]}


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def axis_world(rank: int, world: int, cases: list) -> dict:
    """Every ``(name, cfg, params, batch, mesh shape, build_ctx kwargs)``
    case in order; ``{name: grads_step's record}``."""
    torch.set_num_threads(1)
    out, meshes = {}, {}
    for name, cfg, params, batch, shape, kw in cases:
        if shape not in meshes:
            meshes[shape] = make_data_model_mesh(*shape)
        ctx = build_ctx(cfg, meshes[shape], **kw)
        out[name] = grads_step(cfg, ctx, params, batch)
    return out


def random_batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """The reference test's batch: tokens and labels uniform over the
    vocab, every position unmasked."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "mask": np.ones((b, s), bool)}


# ---------------------------------------------------------------------------
# The trainer's zero gradients (tests/test_torch_llava_train.py)


def _lm_example():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "torch_lm_train.py"
    spec = importlib.util.spec_from_file_location("torch_lm_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def llava_run(init: dict | None, perms: list | None, mesh: bool,
              **kw) -> dict:
    """Reduced llava trained on text by ``examples/torch_lm_train.py``'s
    ``make_trainer`` from ``init`` (a reference tree) with the reference's
    shuffles ``perms``; ``mesh``: at ``mesh_shape=(1,)`` (one backward and
    an all-reduce a step).  Per-epoch losses and every leaf, by name."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import LM, transformer
    cfg = get_arch("llava-next-mistral-7b").reduced()
    model = LM(cfg, transformer.params_from_jax(init, "cpu"))
    mesh_kw = (dict(mesh_shape=(1,), grad_chunks=1, grad_allreduce="psum")
               if mesh else {})
    tr = _lm_example().make_trainer(
        "llava-next-mistral-7b", device="cpu", model=model, ckpt_dir="",
        **kw, **mesh_kw)
    if perms is not None:
        it = iter(torch.as_tensor(p) for p in perms)
        tr.strategy._inner.draw_permutation = lambda: next(it)
    hist = tr.run()
    return {"loss": [h.train_loss for h in hist],
            "hidden": [h.hidden_fraction for h in hist],
            "params": {k: v.detach().numpy().copy()
                       for k, v in tr.model.named_parameters()}}


def llava_world(rank: int, world: int, init: dict, perms: list,
                kw: dict) -> dict:
    """One device and ``mesh_shape=(1,)`` in the same process, one thread."""
    torch.set_num_threads(1)
    return {"one": llava_run(init, perms, False, **kw),
            "mesh": llava_run(init, perms, True, **kw)}


def unit_world(rank: int, world: int, cases: list) -> dict:
    """Each ``(name, cfg, params, batch, build_ctx kwargs)`` at a (1, 1)
    mesh and without a context: whether the loss, the per-sample metrics
    and every gradient agree bit for bit."""
    torch.set_num_threads(1)
    mesh = make_data_model_mesh(1, 1)
    out = {}
    for name, cfg, params, batch, kw in cases:
        a = grads_step(cfg, build_ctx(cfg, mesh, **kw), params, batch)
        b = grads_step(cfg, None, params, batch)
        out[name] = {
            "loss": a["loss"], "one_loss": b["loss"],
            "lv": all(np.array_equal(a[k], b[k]) for k in ("lv", "pa", "pc")),
            "grads": a["grads"].keys() == b["grads"].keys() and all(
                np.array_equal(a["grads"][k], b["grads"][k])
                for k in a["grads"])}
    return out
