"""PyTorch port, serving mamba2 and smollm against the JAX package.

- the port's ``Model.prefill`` then greedy ``decode_step`` against the
  JAX ``Model``'s on ``mamba2-130m.reduced()`` and ``smollm-135m.reduced()``,
  from the reference's parameters carried by ``params_from_jax``, on the
  CPU: prefill logits and the cache (SSM state and conv buffer, or k and v)
  within 2e-4; the greedy tokens of 8 decode steps equal;
- the contract of ``tests/test_arch_smoke.py::test_reduced_prefill_matches_forward``
  on the port: prefill's last logits equal the forward's at S - 1 within
  2e-4, one decode step's equal the forward's at S within 3e-3;
- ``serve(..., device="cpu")`` returns the keys of ``repro.launch.serve``;
- the port's config copies equal the reference's, field for field, and
  the encoder-decoder builds through ``models/encdec.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.launch.serve import serve as jserve
from repro.models import build_model as jbuild_model
from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import serve
from repro_torch.models import build_model, encdec, transformer

ARCH = "mamba2-130m"
DENSE = "smollm-135m"


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _models(cfg, jcfg, seed=0):
    jm = jbuild_model(jcfg)
    jparams = jm.init(jax.random.key(seed))
    tparams = transformer.params_from_jax(jax.tree.map(np.asarray, jparams),
                                          "cpu")
    return jm, jparams, build_model(cfg, device="cpu"), tparams


@pytest.mark.parametrize("b,s", [(2, 40), (3, 16)])
def test_prefill_and_greedy_decode_match_jax(b, s):
    cfg, jcfg = get_arch(ARCH).reduced(), jget_arch(ARCH).reduced()
    jm, jparams, tm, tparams = _models(cfg, jcfg)
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (b, s))
    steps = 8
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        max_len=s + steps)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        max_len=s + steps)
    assert tl.shape == (b, 1, cfg.vocab_size)
    _close(tl, jl, 2e-4)
    for k in ("ssm_state", "conv_buf"):
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k], 2e-4)
    assert tc["len"] == int(jc["len"]) == s
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = tl[:, -1:].argmax(dim=-1)
    for step in range(steps):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), step
        jl, jc = jm.decode_step(jparams, jtok, jc)
        tl, tc = tm.decode_step(tparams, ttok, tc)
        _close(tl, jl, 3e-3)
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(dim=-1)
    assert tc["len"] == int(jc["len"]) == s + steps


def test_port_prefill_matches_forward(rng):
    """``test_arch_smoke.py:81``'s contract, on the port."""
    B, S = 2, 32
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    logits_full, mask, aux = transformer.forward(cfg, params, {"tokens": toks})
    assert logits_full.shape == (B, S + 1, cfg.vocab_size) and mask.all()
    lg, cache = model.prefill(params, {"tokens": toks[:, :S]}, max_len=S + 1)
    _close(lg[:, 0], logits_full[:, S - 1], 2e-4)
    lg2, cache2 = model.decode_step(params, toks[:, S:S + 1], cache)
    _close(lg2[:, 0], logits_full[:, -1], 3e-3)
    assert (cache["len"], cache2["len"]) == (S, S + 1)


def test_decode_from_empty_cache(rng):
    """``test_arch_smoke.py::test_reduced_decode_step`` on the port."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 16, dtype=torch.float32)
    tok = torch.ones(2, 1, dtype=torch.int64)
    logits, cache = model.decode_step(params, tok, cache)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all() and cache["len"] == 1
    _, cache = model.decode_step(params, tok, cache)
    assert cache["len"] == 2


def test_serve_cpu_returns_the_reference_keys():
    kw = dict(reduced=True, batch=2, prompt_len=20, gen_tokens=4, seed=0,
              verbose=False)
    got = serve(ARCH, device="cpu", **kw)
    want = jserve(ARCH, **kw)
    assert set(got) == set(want)
    assert got["arch"] == want["arch"] == ARCH
    assert got["generated"].shape == want["generated"].shape == (2, 4)
    assert ((0 <= got["generated"]) & (got["generated"] < 257)).all()
    for k in ("prefill_s", "decode_per_token_ms", "decode_tok_per_s"):
        assert got[k] > 0


@pytest.mark.parametrize("reduce", [False, True])
def test_configs_are_copies_of_the_reference(reduce):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_unported_architectures_raise():
    """An unknown arch raises ``KeyError``; the encoder-decoder, the last
    of the reference's ten, is ported: seamless-m4t-large-v2 is the
    reference's config and builds through ``models/encdec.py``."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    cfg = get_arch("seamless-m4t-large-v2")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_arch("seamless-m4t-large-v2"))
    model = build_model(cfg.reduced(), device="cpu")
    defs = model.param_defs()
    assert {"enc_in", "enc_layers", "dec_layers"} <= set(defs)
    assert "xattn" in defs["dec_layers"] and "layers" not in defs
    assert defs == encdec.param_defs(cfg.reduced())
    other = dataclasses.replace(get_arch(DENSE), family="encdec",
                                num_encoder_layers=1, encoder_input_dim=8)
    assert set(build_model(other, device="cpu").param_defs()) == set(defs)


# ---------------------------------------------------------------------------
# The dense family: smollm-135m
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s", [(2, 40), (3, 16)])
def test_dense_prefill_and_greedy_decode_match_jax(b, s):
    cfg, jcfg = get_arch(DENSE).reduced(), jget_arch(DENSE).reduced()
    jm, jparams, tm, tparams = _models(cfg, jcfg)
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (b, s))
    steps = 8
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        max_len=s + steps)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        max_len=s + steps)
    assert tl.shape == (b, 1, cfg.vocab_size)
    _close(tl, jl, 2e-4)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape == (
            cfg.num_layers, b, s + steps, cfg.num_kv_heads, cfg.head_dim)
        assert tc[k].dtype == torch.float32
        _close(tc[k], jc[k], 2e-4)
    assert tc["len"] == int(jc["len"]) == s
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = tl[:, -1:].argmax(dim=-1)
    for step in range(steps):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), step
        jl, jc = jm.decode_step(jparams, jtok, jc)
        tl, tc = tm.decode_step(tparams, ttok, tc)
        _close(tl, jl, 3e-3)
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(dim=-1)
    assert tc["len"] == int(jc["len"]) == s + steps
    for k in ("k", "v"):
        _close(tc[k], jc[k], 2e-4)


def test_dense_prefill_matches_forward(rng):
    """``test_arch_smoke.py:81``'s contract, on the port's dense family."""
    B, S = 2, 32
    cfg = get_arch(DENSE).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    logits_full, mask, aux = transformer.forward(cfg, params, {"tokens": toks})
    assert logits_full.shape == (B, S + 1, cfg.vocab_size) and mask.all()
    lg, cache = model.prefill(params, {"tokens": toks[:, :S]}, max_len=S + 1)
    _close(lg[:, 0], logits_full[:, S - 1], 2e-4)
    lg2, cache2 = model.decode_step(params, toks[:, S:S + 1], cache)
    _close(lg2[:, 0], logits_full[:, -1], 3e-3)
    assert (cache["len"], cache2["len"]) == (S, S + 1)


def test_dense_forward_matches_jax():
    cfg, jcfg = get_arch(DENSE).reduced(), jget_arch(DENSE).reduced()
    jm, jparams, _, tparams = _models(cfg, jcfg, seed=1)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 24))
    from repro.models import transformer as jtransformer
    jl, _, _ = jtransformer.forward(jcfg, jm.ctx, jparams,
                                    {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _, _ = transformer.forward(cfg, tparams,
                                   {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, 2e-4)
    assert transformer.global_layer_flags(cfg) == np.asarray(
        jtransformer.global_layer_flags(jcfg)).tolist()


def test_dense_decode_from_empty_cache():
    cfg = get_arch(DENSE).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 16, dtype=torch.float32)
    assert tuple(cache["k"].shape) == (cfg.num_layers, 2, 16, 2, 16)
    tok = torch.ones(2, 1, dtype=torch.int64)
    logits, cache = model.decode_step(params, tok, cache)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits).all() and cache["len"] == 1
    assert cache["k"][:, :, 0].any() and not cache["k"][:, :, 1:].any()
    _, cache = model.decode_step(params, tok, cache)
    assert cache["len"] == 2 and cache["v"][:, :, 1].any()


def test_dense_param_shapes_match_jax():
    cfg, jcfg = get_arch(DENSE), jget_arch(DENSE)
    jshapes = jax.tree.map(lambda a: tuple(a.shape),
                           jbuild_model(jcfg).abstract_params())
    tshapes = transformer.param_defs(cfg)
    from repro_torch.models.common import map_defs
    assert map_defs(lambda d: d.shape, tshapes) == jshapes
    assert "lm_head" in tshapes and not cfg.tie_embeddings
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        jshapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert 160e6 < n < 166e6             # about 163M parameters


def test_serve_smollm_cpu_returns_the_reference_keys():
    kw = dict(reduced=True, batch=2, prompt_len=20, gen_tokens=4, seed=0,
              verbose=False)
    got = serve(DENSE, device="cpu", **kw)
    want = jserve(DENSE, **kw)
    assert set(got) == set(want)
    assert got["arch"] == want["arch"] == DENSE
    assert got["generated"].shape == want["generated"].shape == (2, 4)
    assert ((0 <= got["generated"]) & (got["generated"] < 257)).all()


@pytest.mark.parametrize("reduce", [False, True])
def test_smollm_config_is_a_copy_of_the_reference(reduce):
    cfg, jcfg = get_arch(DENSE), jget_arch(DENSE)
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
