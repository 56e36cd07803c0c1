"""PyTorch port, the decode step as the reference compiles it: the cache's
position ``len`` a 0-d int32 tensor on the cache's device, and a step
that reads nothing back to the host, so that ``launch/serve.py::
capture_decode`` can record it as one CUDA graph (the card's part is
``chip_smoke.py``'s: captured against eager bit for bit).

On the CPU, against the JAX package:

- for a model of each family, reduced (smollm dense, mamba2 ssm, hymba
  hybrid at 4 layers with its window of 32, phi3.5-moe moe, llava vlm,
  seamless-m4t encdec): ``len`` after ``init_cache``, ``prefill`` and
  each greedy ``decode_step`` is a 0-d int32 tensor on the cache's
  device equal to the reference's, and the logits are within the 1e-5 of
  ``tests/test_torch_{serve,zoo,encdec}.py`` of ``jax.jit(decode_step)``'s;
- hymba's ring cache decoded from 4 slots short of its wrap to past it:
  each step writes exactly the slot ``len % 32`` (every other slot
  unchanged bit for bit), and the logits and the cache are within 1e-5 of
  the reference's ring decode;
- each family's ``decode_step`` runs to its end on ``meta`` tensors
  (``Model.abstract_params``, the token, ``init_cache``): a read of a
  device value on the host (``int``, ``bool``, ``.item()``, a size taken
  from ``len``) raises there, so this stands in for "capturable";
- ``attention.update_cache`` at a tensor index equals the int index and
  the reference's ``dynamic_update_slice_in_dim`` bit for bit at every
  start the reference clamps, negative ones included;
- ``decode_step`` leaves the cache it was given as it was: its ``len``,
  SSM state and conv buffer (k and v are written in place, as documented);
- ``serve(device="cpu")`` decodes eagerly (``graph=None`` = ``False``
  there); ``graph=True`` on the CPU, and ``capture_decode`` on CPU
  tensors or on a sharded ``Model``, raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, build_model, transformer

TOL = 1e-5
HYMBA = "hymba-1.5b"
#: A model of each family.
FAMILIES = {"dense": "smollm-135m", "ssm": "mamba2-130m", "hybrid": HYMBA,
            "moe": "phi3.5-moe-42b-a6.6b", "vlm": "llava-next-mistral-7b",
            "encdec": "seamless-m4t-large-v2"}


def _cfgs(arch: str):
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    if arch == HYMBA:                    # layer 1 windowed (window 32)
        cfg = dataclasses.replace(cfg, num_layers=4)
        jcfg = dataclasses.replace(jcfg, num_layers=4)
    return cfg, jcfg


def _reference(arch: str, seed: int = 0):
    """The reduced configs, the JAX model and its init as a numpy tree,
    under the conditioning controls of the zoo's tests: every attention
    projection at its input's fan-in, an SSM's ``a_log`` U[0, 1)."""
    cfg, jcfg = _cfgs(arch)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.array, jm.init(jax.random.key(seed)))
    for stack in ("layers", "enc_layers", "dec_layers"):
        layers = jp.get(stack, {})
        for block in ("attn", "xattn"):
            if block in layers:
                a, dh = layers[block], cfg.resolved_head_dim
                for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                                  ("wv", cfg.d_model),
                                  ("wo", cfg.num_heads * dh)):
                    a[name] = a[name] * np.float32(
                        (a[name].shape[-2] / fan) ** 0.5)
        if "ssm" in layers:
            layers["ssm"]["a_log"] = np.random.default_rng(seed).uniform(
                0, 1, layers["ssm"]["a_log"].shape).astype(np.float32)
    return cfg, jm, jp


def _close(a, b, tol=TOL):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol, atol=tol * scale)


def _prompt(cfg, b: int, s: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = r.normal(
            size=(b, cfg.num_patch_tokens, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = r.normal(
            size=(b, 2 * s, cfg.encoder_input_dim)).astype(np.float32)
    return batch


def _position(cache: dict, want) -> None:
    """``len``: a 0-d int32 tensor on the cache's device, ``want``."""
    n = cache["len"]
    assert isinstance(n, torch.Tensor) and n.shape == () \
        and n.dtype == torch.int32, n
    assert n.device == cache["k" if "k" in cache else "ssm_state"].device
    assert int(n) == int(want)


@pytest.mark.parametrize("family", FAMILIES)
def test_len_is_the_references_int32_scalar(family):
    arch = FAMILIES[family]
    cfg, jm, jp = _reference(arch, seed=1)
    b, steps = 2, 3
    s = 36 if arch == HYMBA else 8         # hymba: past its window of 32
    tm = build_model(cfg, device="cpu")
    tp = transformer.params_from_jax(jp, "cpu")
    _position(tm.init_cache(b, 16, torch.float32), 0)
    batch = _prompt(cfg, b, s, seed=2)
    max_len = s + steps + cfg.num_patch_tokens
    jl, jc = jax.jit(lambda p, x: jm.prefill(p, x, max_len=max_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                        max_len=max_len)
    _position(tc, jc["len"])
    assert int(tc["len"]) == s + cfg.num_patch_tokens
    jdecode = jax.jit(jm.decode_step)
    for _ in range(steps):
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jdecode(jp, jtok, jc)
        tl, tc = tm.decode_step(tp, ttok, tc)
        _position(tc, jc["len"])
        _close(tl, jl)


def test_ring_decode_across_the_wrap_matches_jax():
    """Reduced hymba's ring cache (32 slots) with ``len`` set to 28,
    decoded 8 steps across the wrap: each step writes slot ``len % 32``
    of every layer and no other, and the logits and the cache stay within
    1e-5 of the reference's ring decode from the same cache."""
    cfg, jm, jp = _reference(HYMBA, seed=3)
    tm = build_model(cfg, device="cpu")
    tp = transformer.params_from_jax(jp, "cpu")
    b, start = 2, cfg.attn_window - 4
    r = np.random.default_rng(4)
    jc = jm.init_cache(b, 64, dtype=jnp.float32, ring=True)
    tc = tm.init_cache(b, 64, dtype=torch.float32, ring=True)
    assert tc["k"].shape[2] == cfg.attn_window == 32
    # A filled ring: the same k, v, SSM state and conv buffer on both sides.
    for k in ("k", "v", "ssm_state", "conv_buf"):
        fill = r.normal(size=jc[k].shape).astype(np.float32)
        jc[k] = jnp.asarray(fill)
        tc[k] = torch.from_numpy(fill.copy())
    jc["len"] = jnp.int32(start)
    tc["len"].fill_(start)
    tok = r.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    jdecode = jax.jit(jm.decode_step)
    for step in range(8):
        slot = (start + step) % cfg.attn_window
        before = {k: tc[k].clone() for k in ("k", "v")}
        jl, jc = jdecode(jp, jtok, jc)
        tl, tc = tm.decode_step(tp, ttok, tc)
        _position(tc, start + step + 1)
        for k in ("k", "v"):
            changed = (tc[k] != before[k]).flatten(3).any(-1).any(1)
            want = torch.zeros_like(changed)
            want[:, slot] = True
            assert torch.equal(changed, want), (step, k)
            others = [i for i in range(cfg.attn_window) if i != slot]
            assert torch.equal(tc[k][:, :, others], before[k][:, :, others])
            _close(tc[k], jc[k])
        _close(tl, jl)
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


#: (family, ring cache): the ring for the families with a window.
META_CASES = [(f, ring) for f in FAMILIES for ring in (False, True)
              if not ring or get_arch(FAMILIES[f]).attn_window is not None]


@pytest.mark.parametrize("family,ring", META_CASES)
def test_decode_step_reads_nothing_to_the_host(family, ring):
    """On ``meta`` tensors every value is unknown: a step that read one
    to the host (``int``, ``bool``, ``.item()``, ``torch.full``/``arange``
    sized by ``len``, a Python branch on it) raises there."""
    cfg = get_arch(FAMILIES[family]).reduced()
    model = build_model(cfg, device="meta")
    params = model.abstract_params(torch.float32)
    cache = model.init_cache(2, 16, torch.float32, ring=ring)
    token = torch.empty((2, 1), dtype=torch.int64, device="meta")
    logits, new = model.decode_step(params, token, cache)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    assert new["len"].shape == () and new["len"].dtype == torch.int32
    assert new["len"].device.type == "meta"


S_MAX = 8


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("where", ["0", "5", "S_max-n", "S_max-n+1", "S_max",
                                   "S_max+3", "-1", "-n", "-S_max",
                                   "-S_max-1"])
def test_update_cache_at_a_tensor_index_is_the_int_index(where, n):
    idx = eval(where, {"S_max": S_MAX, "n": n})
    r = np.random.default_rng(7)
    kc, vc = (r.normal(size=(2, S_MAX, 2, 4)).astype(np.float32)
              for _ in range(2))
    kn, vn = (r.normal(size=(2, n, 2, 4)).astype(np.float32) for _ in range(2))
    by_int = [torch.from_numpy(a.copy()) for a in (kc, vc)]
    by_tensor = [torch.from_numpy(a.copy()) for a in (kc, vc)]
    attention.update_cache(*by_int, torch.from_numpy(kn),
                           torch.from_numpy(vn), idx)
    out = attention.update_cache(*by_tensor, torch.from_numpy(kn),
                                 torch.from_numpy(vn),
                                 torch.tensor(idx, dtype=torch.int32))
    assert out[0] is by_tensor[0] and out[1] is by_tensor[1]
    want = jattn.update_cache(*map(jnp.asarray, (kc, vc, kn, vn)),
                              jnp.int32(idx))
    for a, b, w in zip(by_tensor, by_int, want):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec"])
def test_decode_step_leaves_the_cache_it_was_given(family):
    """The new cache's ``len``, SSM state and conv buffer are new tensors:
    the old cache keeps its own values (k and v are written in place)."""
    cfg, _, jp = _reference(FAMILIES[family], seed=5)
    tm = build_model(cfg, device="cpu")
    tp = transformer.params_from_jax(jp, "cpu")
    batch = _prompt(cfg, 2, 6, seed=6)
    _, cache = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in
                               batch.items()}, max_len=10)
    kept = {k: v.clone() for k, v in cache.items() if k not in ("k", "v")}
    _, new = tm.decode_step(tp, torch.zeros((2, 1), dtype=torch.int64), cache)
    assert int(new["len"]) == int(kept["len"]) + 1
    assert new["len"] is not cache["len"]
    for k, v in kept.items():
        assert torch.equal(cache[k], v), k
    for k in ("ssm_state", "conv_buf"):
        if k in cache:
            assert new[k] is not cache[k] and not torch.equal(new[k], cache[k])


def test_serve_decodes_eagerly_on_the_cpu():
    kw = dict(reduced=True, batch=2, prompt_len=8, gen_tokens=4, seed=0,
              verbose=False, device="cpu")
    default = serve_mod.serve("smollm-135m", **kw)
    eager = serve_mod.serve("smollm-135m", graph=False, **kw)
    np.testing.assert_array_equal(default["generated"], eager["generated"])
    assert "decode_capture_s" not in default     # nothing was captured
    with pytest.raises(ValueError, match="CUDA graph"):
        serve_mod.serve("smollm-135m", graph=True, **kw)


def test_capture_decode_refuses_the_cpu_and_a_sharded_model():
    cfg = get_arch("smollm-135m").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 8, torch.float32)
    token = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        serve_mod.capture_decode(model, params, token, cache)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_data_model_mesh
    from repro_torch.launch.train import build_ctx
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        ctx = build_ctx(cfg, make_data_model_mesh(2, 2), fsdp=True)
        sharded = build_model(cfg, ctx, device="cpu")
        assert sharded.sharded
        with pytest.raises(ValueError, match="sharded Model"):
            serve_mod.capture_decode(sharded, params, token, cache)
    finally:
        dist.destroy_process_group()
