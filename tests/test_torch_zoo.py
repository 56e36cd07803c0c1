"""PyTorch port, the decoder-only model zoo against the JAX package.

Over the nine decoder-only architectures of the registry, reduced
(``ArchConfig.reduced()``; hymba-1.5b at 4 layers, so that layer 1 is a
windowed one: at 2 layers both are global), from the reference's
parameters carried by ``params_from_jax``, on the CPU:

- the full forward's logits and loss mask, and the MoE's aux term, within
  1e-5 (relative, and of the largest magnitude absolute: ``_close``);
- ``loss_and_metrics`` (the scalar with the MoE's aux term, the
  per-sample triple) and every leaf's gradient against ``jax.grad`` of the
  reference's ``Model.loss_and_metrics``, 1e-5 relative per leaf; the VLM
  with ``patch_embeds`` in the batch, so that the patch positions are
  dropped before the metrics;
- prefill and 8 greedy decode steps against the JAX ``Model``: logits and
  every cache tensor within 1e-5, the greedy tokens equal; hymba's prompt
  longer than its (reduced) window of 32;
- hymba's ring cache: ``init_cache(ring=True)`` decoded from empty past
  the window, and a flat cache whose prompt and generation fit in the
  window decoded past its end, against the reference step by step;
- ``attend`` with a window over S <= window equals its unwindowed form
  (the reference's windowed attention there, and the port's B7 route);
- ``serve(..., device="cpu")`` for each architecture, the configs equal
  the reference's field for field, the parameter shapes at full width
  equal the reference's, and seamless-m4t-large-v2 raises ``KeyError``.

The conditioning controls of ``tests/test_torch_lm.py`` hold on both
sides: attention projections at their input's fan-in, ``a_log`` drawn
U[0, 1).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data import SyntheticLM
from repro_torch.launch.serve import serve
from repro_torch.models import LM, attention, build_model, transformer
from repro_torch.models.common import map_defs

ZOO = sorted(ARCHS)
HYMBA = "hymba-1.5b"
TOL = 1e-5


def _cfgs(arch: str):
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    if arch == HYMBA:
        cfg = dataclasses.replace(cfg, num_layers=4)
        jcfg = dataclasses.replace(jcfg, num_layers=4)
    return cfg, jcfg


def _reference(arch: str, seed: int = 0):
    """The reduced configs, the JAX model and its init as a numpy tree,
    under the conditioning controls."""
    cfg, jcfg = _cfgs(arch)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.array, jm.init(jax.random.key(seed)))
    layers = jp["layers"]
    if "attn" in layers:
        a, dh = layers["attn"], cfg.resolved_head_dim
        for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                          ("wv", cfg.d_model), ("wo", cfg.num_heads * dh)):
            a[name] = a[name] * np.float32((a[name].shape[-2] / fan) ** 0.5)
    if "ssm" in layers:
        layers["ssm"]["a_log"] = np.random.default_rng(seed).uniform(
            0, 1, layers["ssm"]["a_log"].shape).astype(np.float32)
    return cfg, jm, jp


def _close(a, b, tol=TOL):
    """Within ``tol`` relative, and ``tol`` of the reference's largest
    magnitude absolute: float32 keeps about 1e-6 of a value whatever its
    size, and hymba's forward (both packages alike, against a float64 run)
    carries ~4e-6 of its largest logit at 4 layers."""
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol, atol=tol * scale)


def _patches(cfg, b: int, seed: int = 5):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.num_patch_tokens, 1024)).astype(np.float32)


def _batch(cfg, b: int = 3, s: int = 20, seed: int = 0) -> dict:
    """A SyntheticLM batch (vocab 64) with masked positions, a weight per
    sample and, for the VLM, patch embeddings (numpy)."""
    ds = SyntheticLM(num_samples=b, seq_len=s, vocab_size=64, order=1,
                     easy_fraction=0.7, seed=seed)
    batch = ds.get(np.arange(b))
    r = np.random.default_rng(seed)
    batch["mask"] = r.random((b, s)) < 0.8
    batch["weight"] = r.random(b).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = _patches(cfg, b)
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


def _leaf(tree, name):
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[parts[0]]
    tree = tree["layers"]
    for k in parts[2:]:
        tree = tree[k]
    return tree[int(parts[1])]


@pytest.mark.parametrize("arch", ZOO)
def test_forward_matches_jax(arch):
    cfg, jm, jp = _reference(arch, seed=1)
    batch = _batch(cfg, b=2, s=24, seed=1)
    del batch["weight"]
    jl, jmask, jaux = jtransformer.forward(
        jm.cfg, jm.ctx, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmask, taux = transformer.forward(
        cfg, transformer.params_from_jax(jp, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == jl.shape
    _close(tl, jl)
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    _close(taux.item(), float(jaux))
    if cfg.family == "moe":
        assert taux.item() > 0
    assert transformer.global_layer_flags(cfg) == np.asarray(
        jtransformer.global_layer_flags(jm.cfg)).tolist()


@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_gradients_match_jax(arch):
    cfg, jm, jp = _reference(arch)
    batch = _batch(cfg)
    (js, (jl, jpa, jpc)), jg = jax.value_and_grad(
        jm.loss_and_metrics, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = LM(cfg, transformer.params_from_jax(jp, "cpu", unstack=True))
    scalar, (loss, pa, pc) = lm.loss_and_metrics(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    scalar.backward()
    np.testing.assert_allclose(scalar.item(), float(js), rtol=TOL)
    assert loss.shape == (3,)                 # text positions only
    np.testing.assert_allclose(loss.detach().numpy(), jl, rtol=TOL, atol=1e-6)
    assert np.array_equal(pa.numpy(), np.asarray(jpa))
    np.testing.assert_allclose(pc.detach().numpy(), jpc, rtol=1e-6, atol=1e-6)
    jg = jax.tree.map(np.asarray, jg)
    names = [n for n, _ in lm.named_parameters()]
    assert len(names) == len(jax.tree.leaves(jg["layers"])) * cfg.num_layers \
        + len([k for k in jg if k != "layers"])
    for name, p in lm.named_parameters():
        want = _leaf(jg, name)
        assert p.grad is not None and p.grad.shape == want.shape, name
        rel = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        assert rel <= TOL, (name, rel)


def _prompt(cfg, arch, b, s, seed):
    batch = {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _patches(cfg, b, seed)
    return batch


def _same_caches(tc, jc):
    assert tc.keys() == jc.keys()
    assert tc["len"] == int(jc["len"])
    for k in tc:
        if k != "len":
            assert tuple(tc[k].shape) == jc[k].shape, k
            _close(tc[k], jc[k])


def _greedy(jm, jp, tm, tp, jl, jc, tl, tc, steps):
    """``steps`` greedy decode steps on both sides from their prefills:
    logits within TOL and the tokens equal at every step."""
    jdecode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = tl[:, -1:].argmax(dim=-1)
    for step in range(steps):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), step
        jl, jc = jdecode(jp, jtok, jc)
        tl, tc = tm.decode_step(tp, ttok, tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(dim=-1)
    return jc, tc


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_greedy_decode_match_jax(arch):
    cfg, jm, jp = _reference(arch, seed=2)
    b, steps = 2, 8
    s = 40 if arch == HYMBA else 12          # hymba: past its window of 32
    batch = _prompt(cfg, arch, b, s, seed=3)
    max_len = s + steps + cfg.num_patch_tokens
    jl, jc = jax.jit(lambda p, x: jm.prefill(p, x, max_len=max_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tp = build_model(cfg, "cpu"), transformer.params_from_jax(jp, "cpu")
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                        max_len=max_len)
    assert tl.shape == (b, 1, cfg.vocab_size)
    _close(tl, jl)
    _same_caches(tc, jc)
    assert tc["len"] == s + cfg.num_patch_tokens
    jc, tc = _greedy(jm, jp, tm, tp, jl, jc, tl, tc, steps)
    _same_caches(tc, jc)


@pytest.mark.parametrize("flat", [False, True])
def test_hymba_ring_cache_matches_jax(flat):
    """``init_cache(ring=True)`` decoded from empty, or a flat cache no
    longer than the window (prompt 20 + 8 of 32), decoded past the window
    (and past the flat cache's end, where its index wraps)."""
    cfg, jm, jp = _reference(HYMBA, seed=4)
    tm, tp = build_model(cfg, "cpu"), transformer.params_from_jax(jp, "cpu")
    b, steps = 2, 40
    if flat:
        batch = _prompt(cfg, HYMBA, b, 20, seed=6)
        jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                            max_len=28)
        tl, tc = tm.prefill(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, max_len=28)
        assert tc["k"].shape[2] == 28 <= cfg.attn_window
    else:
        jc = jm.init_cache(b, 64, dtype=jnp.float32, ring=True)
        tc = tm.init_cache(b, 64, dtype=torch.float32, ring=True)
        assert tc["k"].shape[2] == cfg.attn_window == 32
        tok = np.full((b, 1), 3, np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
    _close(tl, jl)
    jc, tc = _greedy(jm, jp, tm, tp, jl, jc, tl, tc, steps)
    assert tc["len"] > cfg.attn_window
    _same_caches(tc, jc)


def test_ring_cache_needs_a_window():
    cfg = get_arch("smollm-135m").reduced()
    with pytest.raises(ValueError, match="window"):
        transformer.init_cache(cfg, 2, 16, device="cpu", ring=True)


@pytest.mark.parametrize("s,window", [(24, 32), (32, 32), (40, 32)])
def test_attend_with_a_window_over_short_sequences_is_causal(s, window):
    r = np.random.default_rng(s)
    q, k, v = (r.normal(size=(2, s, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    jwin = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        window=window, is_global=False)
    jcausal = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    twin = attention.attend(tq, tk, tv, window=window, is_global=False)
    _close(twin, jwin, 1e-6)
    if s <= window:
        # The reference's windowed mask masks nothing more than the causal.
        assert np.array_equal(np.asarray(jwin), np.asarray(jcausal))
        assert torch.equal(twin, attention.attend(tq, tk, tv))
    else:
        assert not np.allclose(np.asarray(jwin), np.asarray(jcausal))


@pytest.mark.parametrize("arch", ZOO)
def test_serve_cpu(arch):
    kw = dict(batch=2, prompt_len=40 if arch == HYMBA else 10, gen_tokens=3,
              seed=0, verbose=False)
    got = serve(arch, device="cpu", num_layers=4 if arch == HYMBA else None,
                **kw)
    assert set(got) == {"arch", "prefill_s", "decode_per_token_ms",
                        "decode_tok_per_s", "generated"}
    assert got["arch"] == arch and got["generated"].shape == (2, 3)
    cfg = get_arch(arch).reduced()
    assert ((0 <= got["generated"])
            & (got["generated"] < cfg.vocab_size)).all()


def test_serve_vlm_draws_the_references_patch_embeds(monkeypatch):
    """The VLM's prompt batch: tokens, then (B, 8, 1024) patch embeddings
    from the same ``default_rng(seed)``, as the reference's serve draws
    them; the cache covers the patch positions."""
    arch = "llava-next-mistral-7b"
    seen = []
    prefill = transformer.prefill

    def spy(cfg, params, batch, max_len=None):
        seen.append(({k: v.numpy().copy() for k, v in batch.items()}, max_len))
        return prefill(cfg, params, batch, max_len)

    monkeypatch.setattr(transformer, "prefill", spy)
    serve(arch, device="cpu", batch=2, prompt_len=6, gen_tokens=2, seed=4,
          verbose=False)
    (batch, max_len), = seen
    rng = np.random.default_rng(4)
    assert np.array_equal(batch["tokens"], rng.integers(0, 257, (2, 6)))
    assert np.array_equal(batch["patch_embeds"], rng.normal(
        size=(2, 8, 1024)).astype(np.float32))
    assert max_len == 6 + 2 + 8


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_registry_is_the_references(arch):
    if arch == "seamless-m4t-large-v2":
        with pytest.raises(KeyError, match=r"A\.6\(d\)"):
            get_arch(arch)
        return
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jbuild_model(jcfg).abstract_params())
    assert map_defs(lambda d: d.shape, transformer.param_defs(cfg)) == jshapes
