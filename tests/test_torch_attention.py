"""PyTorch port, attention and kernel B7 against the JAX package.

Kernel B7 runs only on the card (``chip_smoke.py`` holds it against its
plain version there).  Here, on inputs made from a seed with numpy:

- ``ops.flash_attention`` on CPU tensors — the plain version,
  ``flash_attention_plain`` — against the Pallas kernel in interpret mode
  (``repro.kernels.ops.flash_attention``, as ``tests/test_kernels.py`` runs
  it) and ``ref.flash_attention_ref``, on that file's 4 shapes, causal or
  not, float32 (1e-5) and bfloat16 (2e-2), its own tolerances; and at a
  ragged S against ``flash_attention_ref``, which takes any S;
- the wrapper's checks (mixed devices, ranks, GQA ratio, a last dimension
  that is not dense), which hold on every device;
- ``rope``, ``gated_mlp``, ``project_qkv`` (qk_norm on and off),
  ``attend`` (S above, at and below ``q_chunk``, with a window and
  ``is_global`` both ways), ``decode_attend`` against their JAX counterparts within 1e-5,
  and ``update_cache`` exactly, at every start the reference clamps.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention, common

TOL = 1e-5


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _qkv(b, s, hq, hkv, d, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, hq, d)).astype(np.float32),
            r.normal(size=(b, s, hkv, d)).astype(np.float32),
            r.normal(size=(b, s, hkv, d)).astype(np.float32))


def _to_torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (2, 128, 4, 2, 16), (1, 256, 8, 8, 32), (2, 128, 6, 3, 64),
    (1, 512, 2, 1, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_both_jax_implementations(
        b, s, hq, hkv, d, causal, dtype):
    """``test_kernels.py::test_flash_attention``'s cases."""
    arrs = _qkv(b, s, hq, hkv, d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = tops.flash_attention(*_to_torch(arrs, tdt), causal=causal)
    assert out.shape == (b, s, hq, d) and out.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    jin = [jnp.asarray(a, jdt) for a in arrs]
    _close(out.float(), jops.flash_attention(*jin, causal=causal, blk_q=64,
                                             blk_k=64), tol)
    _close(out.float(), flash_attention_ref(*jin, causal=causal), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_length(causal):
    """S = 200 is no multiple of a block: the JAX kernel asserts one, the
    port's wrapper takes it (the kernel masks its last tile)."""
    arrs = _qkv(2, 200, 6, 2, 32, seed=3)
    out = tops.flash_attention(*_to_torch(arrs), causal=causal)
    _close(out, flash_attention_ref(*map(jnp.asarray, arrs), causal=causal))


def test_flash_attention_wrapper_checks():
    q, k, v = _to_torch(_qkv(1, 16, 4, 2, 16))
    assert torch.equal(tfa.flash_attention(q, k, v),
                       tfa.flash_attention_plain(q, k, v))
    assert torch.equal(tfa.flash_attention(q, k, v, causal=False),
                       tfa.flash_attention_plain(q, k, v, causal=False))
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_attention(q.to("meta"), k, v)
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        tfa.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tfa.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="Hkv"):
        tfa.flash_attention(q, k[:, :8], v)
    wide = torch.randn(1, 16, 2, 32)
    with pytest.raises(ValueError, match="dense"):
        tfa.flash_attention(q, wide[..., ::2], v)


def test_rope_and_gated_mlp_match_jax():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(5, 17)]).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(common.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               jcommon.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    h = r.normal(size=(2, 5, 24)).astype(np.float32)
    ws = [r.normal(size=shape).astype(np.float32) * 0.2
          for shape in ((24, 40), (24, 40), (40, 24))]
    _close(common.gated_mlp(*map(torch.from_numpy, [h, *ws])),
           jcommon.gated_mlp(*map(jnp.asarray, [h, *ws])))


def _attn_params(d, hq, hkv, dh, qk_norm, seed=2):
    r = np.random.default_rng(seed)
    defs = attention.attn_param_defs(d, hq, hkv, dh, qk_norm)
    return {k: (r.normal(size=v.shape) * (0.2 if len(v.shape) > 1 else 1)
                ).astype(np.float32) for k, v in defs.items()}


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_and_out_proj_match_jax(qk_norm):
    d, hq, hkv, dh = 32, 4, 2, 16
    p = _attn_params(d, hq, hkv, dh, qk_norm)
    x = np.random.default_rng(4).normal(size=(2, 10, d)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)[None, :]
    got = attention.project_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), torch.from_numpy(pos),
                                1e4, qk_norm, 1e-6)
    want = jattn.project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jnp.asarray(pos), 1e4, qk_norm,
                             1e-6)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        _close(a, b)
    o = attention.out_proj(got[0], torch.from_numpy(p["wo"]))
    _close(o, jnp.einsum("bshk,hkd->bsd", want[0], jnp.asarray(p["wo"])))


def test_attn_param_defs_match_jax():
    for qk_norm in (False, True):
        got = attention.attn_param_defs(64, 9, 3, 16, qk_norm)
        want = jattn.attn_param_defs(64, 9, 3, 16, qk_norm)
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert {k: v.init for k, v in got.items()} == {
            k: v.init for k, v in want.items()}


@pytest.mark.parametrize("s,q_chunk", [(64, 16), (40, 16), (12, 16), (16, 16)])
@pytest.mark.parametrize("window,is_global", [(None, True), (5, False),
                                              (5, True)])
def test_attend_matches_jax(s, q_chunk, window, is_global):
    """S a multiple of ``q_chunk`` and above it (chunked), not a multiple,
    below it and equal to it (one block), with and without a window."""
    arrs = _qkv(2, s, 4, 2, 16, seed=s)
    got = attention.attend(*_to_torch(arrs), causal=True, window=window,
                           is_global=is_global, q_chunk=q_chunk)
    want = jattn.attend(*map(jnp.asarray, arrs), causal=True, window=window,
                        is_global=is_global, q_chunk=q_chunk)
    _close(got, want)
    if window is None or is_global:          # what B7 computes on the card
        _close(got, tfa.flash_attention_plain(*_to_torch(arrs)))


@pytest.mark.parametrize("cache_len", [1, 7, 16])
@pytest.mark.parametrize("window,is_global", [(None, True), (4, False),
                                              (4, True)])
def test_decode_attend_matches_jax(cache_len, window, is_global):
    r = np.random.default_rng(cache_len)
    q = r.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc = r.normal(size=(2, 16, 2, 16)).astype(np.float32)
    vc = r.normal(size=(2, 16, 2, 16)).astype(np.float32)
    got = attention.decode_attend(*map(torch.from_numpy, (q, kc, vc)),
                                  cache_len, window=window, is_global=is_global)
    want = jattn.decode_attend(*map(jnp.asarray, (q, kc, vc)),
                               jnp.int32(cache_len), window=window,
                               is_global=is_global)
    assert tuple(got.shape) == want.shape
    _close(got, want)


S_MAX = 8


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("where", ["0", "5", "S_max-n", "S_max-n+1", "S_max",
                                   "S_max+3", "-1", "-S_max-1"])
def test_update_cache_writes_in_place_as_jax_writes(where, n):
    """Bit for bit the reference's ``dynamic_update_slice_in_dim``: a
    negative start counts from the end, then the start is clamped into
    [0, S_max - n], so past the end and negative writes land as there."""
    idx = eval(where, {"S_max": S_MAX, "n": n})
    r = np.random.default_rng(5)
    kc, vc = (r.normal(size=(2, S_MAX, 2, 4)).astype(np.float32)
              for _ in range(2))
    kn, vn = (r.normal(size=(2, n, 2, 4)).astype(np.float32) for _ in range(2))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = attention.update_cache(tk, tv, torch.from_numpy(kn),
                                 torch.from_numpy(vn), idx)
    assert out[0] is tk and out[1] is tv
    want = jattn.update_cache(*map(jnp.asarray, (kc, vc, kn, vn)), idx)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
