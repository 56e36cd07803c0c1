"""PyTorch port, the MoE FFN (``models/moe.py``) against the JAX package's.

- ``moe_ffn`` against the reference's ``moe_ffn`` with ``ctx=None`` (its
  local path), from the same numpy parameters and inputs: y and the aux
  term within 1e-6, and the routing integers (each choice's expert, its
  position in the expert's queue, whether it is kept, its dispatch slot)
  exactly equal to the ones the reference computes (recorded from inside
  its ``_route_local``).  Cases: T not a multiple of E, a router skewed
  so that one expert gets more choices than its capacity (dropped
  choices), an all-zero router (every probability tied: the lower expert
  first, as ``jax.lax.top_k``), and top-1;
- the gradient of every MoE leaf and of x against ``jax.grad`` of the
  same function (a cotangent on y plus a multiple of aux), 1e-5 relative
  per leaf, with the capacity overflowing;
- the capacity formula and the parameter layout equal the reference's;
- the backward twice from the same inputs gives the same bits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe


class _Where:
    """``jnp`` with its ``where`` calls recorded (arguments and result)."""

    def __init__(self, mod):
        self._mod = mod
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def where(self, *args):
        out = self._mod.where(*args)
        self.calls.append((args, out))
        return out


def _params(d, e, ff, seed, skew=0.0, zero_router=False):
    r = np.random.default_rng(seed)
    p = {"router": (r.normal(size=(d, e)) * 0.5).astype(np.float32),
         "w_gate": (r.normal(size=(e, d, ff)) * d ** -0.5).astype(np.float32),
         "w_up": (r.normal(size=(e, d, ff)) * d ** -0.5).astype(np.float32),
         "w_down": (r.normal(size=(e, ff, d)) * ff ** -0.5).astype(np.float32)}
    if zero_router:
        p["router"][:] = 0.0
    # A positive x . router[:, 0] for every token puts expert 0 first.
    p["router"][:, 0] += skew
    return p


def _x(b, s, d, seed, positive=False):
    x = np.random.default_rng(seed + 1).normal(size=(b, s, d))
    return (np.abs(x) if positive else x).astype(np.float32)


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


#: (B, S, d, E, k, d_ff, skew, zero router): T = B * S.
CASES = {
    "ragged_t": (3, 7, 16, 4, 2, 8, 0.0, False),        # T = 21, E = 4
    "overflow": (2, 24, 16, 4, 2, 8, 3.0, False),       # expert 0 > cap
    "ties": (2, 5, 8, 4, 2, 8, 0.0, True),               # all probs equal
    "top1_overflow": (4, 9, 16, 3, 1, 12, 3.0, False),
    "wide": (2, 33, 32, 8, 2, 16, 0.0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_jax_with_equal_routing(case, monkeypatch):
    b, s, d, e, k, ff, skew, zero = CASES[case]
    p = _params(d, e, ff, seed=len(case), skew=skew, zero_router=zero)
    x = _x(b, s, d, seed=len(case), positive=skew > 0)
    rec = _Where(jnp)
    monkeypatch.setattr(jmoe, "jnp", rec)
    tops = []
    top_k = jax.lax.top_k
    monkeypatch.setattr(jax.lax, "top_k",
                        lambda a, kk: tops.append(top_k(a, kk)) or tops[-1])
    jy, jaux = jmoe.moe_ffn(_jax(p), jnp.asarray(x), JMoEConfig(e, k, ff), None)
    ty, taux = moe.moe_ffn(_torch(p), torch.from_numpy(x), MoEConfig(e, k, ff))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6, atol=1e-6)

    r = moe.route(_torch(p), torch.from_numpy(x).reshape(-1, d),
                  MoEConfig(e, k, ff))
    (keep, slot, overflow), dst = rec.calls[0]     # the dispatch's where
    jtop_e = np.asarray(tops[0][1])
    cap = moe.capacity(MoEConfig(e, k, ff), b * s)
    assert r.cap == cap == int(overflow) // e
    assert np.array_equal(r.top_e.numpy(), jtop_e)
    assert np.array_equal(r.keep.numpy(), np.asarray(keep))
    assert np.array_equal(r.pos.numpy(),
                          np.asarray(slot) - jtop_e.reshape(-1) * cap)
    assert np.array_equal(r.dst.numpy(), np.asarray(dst))
    np.testing.assert_allclose(r.top_p.numpy(),
                               np.asarray(tops[0][0])
                               / np.asarray(tops[0][0]).sum(-1, keepdims=True),
                               rtol=1e-6, atol=1e-7)
    if skew:
        assert not r.keep.all(), "the capacity did not overflow"
    if zero:
        assert np.array_equal(jtop_e, np.tile(np.arange(k), (b * s, 1)))


def test_moe_gradients_match_jax_under_overflow():
    b, s, d, e, k, ff = 2, 24, 16, 4, 2, 8
    p = _params(d, e, ff, seed=3, skew=3.0)
    x = _x(b, s, d, seed=3, positive=True)
    gy = np.random.default_rng(9).normal(size=(b, s, d)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, JMoEConfig(e, k, ff), None)
        return jnp.sum(y * gy) + 3.0 * aux

    jg = jax.grad(jloss, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    tp = {kk: v.requires_grad_(True) for kk, v in _torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(tp, tx, MoEConfig(e, k, ff))
    r = moe.route(tp, tx.detach().reshape(-1, d), MoEConfig(e, k, ff))
    assert not r.keep.all()
    ((y * torch.from_numpy(gy)).sum() + 3.0 * aux).backward()
    for name, got, want in [*((kk, tp[kk].grad, jg[0][kk]) for kk in p),
                            ("x", tx.grad, jg[1])]:
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (name, rel)


def test_moe_backward_is_bit_identical_run_to_run():
    b, s, d, e, k, ff = 2, 24, 16, 4, 2, 8
    p, x = _params(d, e, ff, seed=4, skew=3.0), _x(b, s, d, 4, positive=True)

    def grads():
        tp = {kk: v.requires_grad_(True) for kk, v in _torch(p).items()}
        y, aux = moe.moe_ffn(tp, torch.from_numpy(x), MoEConfig(e, k, ff))
        (y.square().sum() + aux).backward()
        return [tp[kk].grad for kk in sorted(tp)]

    for a, c in zip(grads(), grads()):
        assert torch.equal(a, c)


@pytest.mark.parametrize("t", [1, 8, 21, 1024, 8192])
def test_capacity_is_the_references(t):
    for cfg in (MoEConfig(16, 2, 6400), MoEConfig(384, 8, 2048),
                MoEConfig(4, 2, 64)):
        e, k = cfg.num_experts, cfg.top_k
        from repro.configs.base import round_up
        assert moe.capacity(cfg, t) == round_up(
            int(cfg.capacity_factor * k * t / e) + 1, 8)
    assert moe.capacity(MoEConfig(16, 2, 6400), 8192) == 1288
    assert moe.capacity(MoEConfig(16, 2, 6400), 1024) == 168


def test_param_defs_are_the_gather_layout():
    cfg = MoEConfig(8, 2, 24)
    want = jax.tree.map(lambda d: (d.shape, d.init, d.scale),
                        jmoe.moe_param_defs(40, JMoEConfig(8, 2, 24)),
                        is_leaf=lambda d: hasattr(d, "shape"))
    got = {k: (d.shape, d.init, d.scale)
           for k, d in moe.moe_param_defs(40, cfg).items()}
    assert got == want
