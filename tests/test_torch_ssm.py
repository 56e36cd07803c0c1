"""PyTorch port, the Mamba2 SSD scan and block against the JAX package.

Kernel B6 runs only on the card (``chip_smoke.py`` holds it against its
plain version there).  Here the port's ``ops.ssd_scan`` on CPU tensors —
the plain version, ``ssd_scan_plain`` — is held against both JAX
implementations on the same inputs made from a seed with numpy:

- ``repro.kernels.ops.ssd_scan``, the Pallas kernel in interpret mode, as
  ``tests/test_kernels.py`` runs it, and ``repro.models.ssm.ssd_scan_ref``,
  both within 1e-4 (``test_kernels.py``'s tolerance), at that file's three
  shapes, a ragged length, a length shorter than a chunk and one case at
  mamba2-130m's N = 128, P = 64, chunk 128;
- the naive per-step recurrence of ``test_kernels.py``, within 2e-4;
- the SSM block (``ssm_forward`` with its decode cache, ``ssm_decode_step``)
  on the reduced mamba2 config, from the reference's parameters carried by
  ``params_from_jax``, within 2e-4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import common, ssm, transformer

TOL = 1e-4


def _inputs(b, s, nh, p, n, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, s, nh, p)).astype(np.float32),
            r.normal(size=(b, s, nh)).astype(np.float32),
            r.uniform(0, 1, (nh,)).astype(np.float32),
            r.normal(size=(b, s, n)).astype(np.float32),
            r.normal(size=(b, s, n)).astype(np.float32),
            r.normal(size=(nh,)).astype(np.float32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,nh,p,n,chunk", [
    (2, 64, 3, 16, 8, 16), (1, 128, 2, 32, 16, 32), (2, 96, 1, 8, 4, 16),
    (2, 100, 2, 16, 8, 32),          # ragged: a partial last chunk
    (2, 20, 3, 8, 4, 32),            # shorter than one chunk
    (1, 300, 2, 64, 128, 128),       # mamba2-130m's N, P and chunk
])
def test_ssd_scan_matches_both_jax_implementations(b, s, nh, p, n, chunk):
    args = _inputs(b, s, nh, p, n)
    y, st = tops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert y.shape == (b, s, nh, p) and y.dtype == torch.float32
    assert st.shape == (b, nh, n, p) and st.dtype == torch.float32
    for fn in (jops.ssd_scan, jssm.ssd_scan_ref):
        yj, sj = fn(*map(jnp.asarray, args), chunk)
        _close(y, yj)
        _close(st, sj)


def test_ssd_scan_matches_sequential_recurrence():
    """Chunked SSD == naive per-step recurrence (``test_kernels.py:53``)."""
    b, s, nh, p, n, chunk = 1, 32, 2, 8, 4, 8
    x, dtr, a_log, bm, cm, _ = _inputs(b, s, nh, p, n, seed=1)
    dsk = np.zeros((nh,), np.float32)
    y, st = tops.ssd_scan(*map(torch.from_numpy, (x, dtr, a_log, bm, cm, dsk)),
                          chunk=chunk)
    a = -np.exp(a_log)
    dt = np.logaddexp(0, dtr)
    h = np.zeros((b, nh, n, p), np.float32)
    ys = np.zeros_like(x)
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None, :])
        upd = np.einsum("bh,bn,bhp->bhnp", dt[:, t], bm[:, t], x[:, t])
        h = h * decay[:, :, None, None] + upd
        ys[:, t] = np.einsum("bn,bhnp->bhp", cm[:, t], h)
    _close(y, ys, 2e-4)
    _close(st, h, 2e-4)


def test_ssd_scan_takes_column_slices_of_one_activation():
    """The model hands x, b and c over as views into its conv output; the
    wrapper takes them in place, with the result of contiguous copies and
    of JAX's ``ops.ssd_scan``."""
    b, s, nh, p, n, chunk = 2, 40, 3, 8, 4, 16
    x, dt, a_log, bm, cm, dsk = _inputs(b, s, nh, p, n, seed=2)
    xbc = torch.from_numpy(np.concatenate(
        [x.reshape(b, s, nh * p), bm, cm], axis=-1))
    xv, bv, cv = torch.split(xbc, [nh * p, n, n], dim=-1)
    xv = xv.view(b, s, nh, p)
    assert not (xv.is_contiguous() or bv.is_contiguous() or cv.is_contiguous())
    rest = tuple(map(torch.from_numpy, (dt, a_log)))
    y, st = tops.ssd_scan(xv, *rest, bv, cv, torch.from_numpy(dsk), chunk)
    y_c, st_c = tops.ssd_scan(xv.contiguous(), *rest, bv.contiguous(),
                              cv.contiguous(), torch.from_numpy(dsk), chunk)
    assert torch.equal(y, y_c) and torch.equal(st, st_c)
    yj, sj = jops.ssd_scan(*map(jnp.asarray, (x, dt, a_log, bm, cm, dsk)), chunk)
    _close(y, yj)
    _close(st, sj)


def test_ssd_scan_plain_is_the_models_oracle():
    assert ssm.ssd_scan_ref is tssd.ssd_scan_plain


def test_ssd_scan_wrapper_checks_shapes():
    x, dt, a_log, bm, cm, dsk = map(torch.from_numpy, _inputs(1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="dt must be"):
        tssd.ssd_scan(x, dt[:, :8], a_log, bm, cm, dsk, 8)
    with pytest.raises(ValueError, match="c must be"):
        tssd.ssd_scan(x, dt, a_log, bm, cm[..., :3], dsk, 8)
    with pytest.raises(ValueError, match="x must be"):
        tssd.ssd_scan(x[0], dt, a_log, bm, cm, dsk, 8)


# ---------------------------------------------------------------------------
# Building blocks and the SSM block
# ---------------------------------------------------------------------------


def _jax_layer0(cfg):
    params = jbuild_model(cfg).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["ssm"])
    tp = transformer.params_from_jax(np_params, "cpu")["layers"]["ssm"]
    return jp, {k: v[0] for k, v in tp.items()}


def test_rms_norm_and_causal_conv_match_jax(rng):
    x = rng.normal(size=(2, 9, 24)).astype(np.float32) * 3
    w = rng.normal(size=(24,)).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    cw = rng.normal(size=(4, 24)).astype(np.float32)
    cb = rng.normal(size=(24,)).astype(np.float32)
    _close(ssm._causal_conv(*map(torch.from_numpy, (x, cw, cb))),
           jssm._causal_conv(*map(jnp.asarray, (x, cw, cb))), 1e-6)


@pytest.mark.parametrize("s", [37, 2])
def test_ssm_block_matches_jax(s, rng):
    cfg = get_arch("mamba2-130m").reduced()
    jcfg = jget_arch("mamba2-130m").reduced()
    di = cfg.ssm.expand * cfg.d_model
    jp, tp = _jax_layer0(jcfg)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    out, st, buf = ssm.ssm_forward(tp, torch.from_numpy(x), cfg.ssm, di,
                                   return_state=True)
    jout, jst, jbuf = jssm.ssm_forward(jp, jnp.asarray(x), jcfg.ssm, di,
                                       return_state=True)
    assert buf.shape == (2, min(s, cfg.ssm.conv_width - 1), di + 2 * cfg.ssm.state_dim)
    for a, b in ((out, jout), (st, jst), (buf, jbuf)):
        _close(a, b, 2e-4)
    # two recurrent steps from that cache
    cache = {"state": st, "conv_buf": buf}
    jcache = {"state": jst, "conv_buf": jbuf}
    if s < cfg.ssm.conv_width - 1:
        return
    for step in range(2):
        x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        o, cache = ssm.ssm_decode_step(tp, torch.from_numpy(x1), cache,
                                       cfg.ssm, di)
        jo, jcache = jssm.ssm_decode_step(jp, jnp.asarray(x1), jcache,
                                          jcfg.ssm, di)
        _close(o, jo, 2e-4)
        _close(cache["state"], jcache["state"], 2e-4)
        _close(cache["conv_buf"], jcache["conv_buf"], 2e-4)


def test_ssm_init_cache_matches_jax():
    cfg = get_arch("mamba2-130m").reduced()
    jcfg = jget_arch("mamba2-130m").reduced()
    c = ssm.ssm_init_cache(3, cfg.ssm, 128, device="cpu")
    jc = jssm.ssm_init_cache(3, jcfg.ssm, 128)
    for k in ("state", "conv_buf"):
        assert tuple(c[k].shape) == jc[k].shape and not c[k].any()


def test_param_shapes_and_init_kinds():
    cfg = get_arch("mamba2-130m").reduced()
    jcfg = jget_arch("mamba2-130m").reduced()
    jshapes = jax.tree.map(lambda a: a.shape,
                           jbuild_model(jcfg).abstract_params())
    params = common.init_params(transformer.param_defs(cfg),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    tshapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert tshapes == jshapes
    p = params["layers"]["ssm"]
    assert not p["conv_b"].any() and not p["dt_bias"].any()
    assert (p["d_skip"] == 1).all() and (p["norm_w"] == 1).all()
    assert (params["layers"]["ln1"] == 1).all()
    assert (p["a_log"] >= 0).all() and (p["a_log"] <= np.log(16.0) + 1e-6).all()
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    assert abs(float(p["conv_w"].std()) - 0.5) < 0.05
    assert abs(float(p["w_in"].std()) - cfg.d_model ** -0.5) < 0.01
    # a generator seeded alike draws the same parameters
    again = common.init_params(transformer.param_defs(cfg),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(again["layers"]["ssm"]["w_out"], p["w_out"])
