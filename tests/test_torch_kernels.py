"""PyTorch port, kernels: each plain version against the Pallas kernel.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each against
its plain version there).  Here the plain PyTorch versions — what a wrapper
runs on a CPU tensor — are held against the JAX package's Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them, on the same inputs
made from a seed with numpy.  Integers exactly; ``ce``/``pmax`` within 1e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.loss_confidence import loss_confidence_kernel
from repro.kernels.threshold_select import (histogram_kernel,
                                            histogram_with_range,
                                            minmax_kernel)
from repro_torch.kernels import backend
from repro_torch.kernels import loss_confidence as lc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import threshold_select as ts

TOL = 1e-5


def _logits(t, v, seed=0, scale=3.0):
    r = np.random.default_rng(seed)
    return ((r.normal(size=(t, v)) * scale).astype(np.float32),
            r.integers(0, v, t).astype(np.int32))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# B1 loss_confidence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,v", [(128, 10), (256, 512)])
def test_loss_confidence_plain_matches_pallas_kernel(t, v):
    lg, lab = _logits(t, v)
    ce, cor, pm = loss_confidence_kernel(jnp.asarray(lg), jnp.asarray(lab),
                                         interpret=True)
    ce_t, cor_t, pm_t = lc.loss_confidence_plain(torch.from_numpy(lg),
                                                 torch.from_numpy(lab))
    assert cor_t.dtype == torch.bool
    assert np.array_equal(cor_t.numpy().astype(np.int32), np.asarray(cor))
    _close(ce_t, ce)
    _close(pm_t, pm)


# ragged T and V: the JAX wrapper pads to its block grid, the port masks
@pytest.mark.parametrize("t,v", [(7, 33), (100, 1000), (300, 257), (1, 10)])
def test_loss_confidence_ragged_matches_padded_pallas(t, v):
    lg, lab = _logits(t, v, seed=t)
    ce, cor, pm = jops.loss_confidence(jnp.asarray(lg), jnp.asarray(lab),
                                       interpret=True)
    ce_t, cor_t, pm_t = tops.loss_confidence(torch.from_numpy(lg),
                                             torch.from_numpy(lab))
    assert np.array_equal(cor_t.numpy(), np.asarray(cor))
    _close(ce_t, ce)
    _close(pm_t, pm)


@pytest.mark.parametrize("t,v", [(128, 10), (64, 1000), (5, 3)])
def test_loss_confidence_plain_matches_reference_metrics(t, v):
    lg, lab = _logits(t, v, seed=1)
    ce, cor, pm = jops._reference_metrics(jnp.asarray(lg), jnp.asarray(lab))
    ce_t, cor_t, pm_t = lc.loss_confidence_plain(torch.from_numpy(lg),
                                                 torch.from_numpy(lab))
    assert np.array_equal(cor_t.numpy() != 0, np.asarray(cor))
    _close(ce_t, ce)
    _close(pm_t, pm)


def test_loss_confidence_bf16_and_ties():
    """bf16 logits accumulate in f32; a tied max counts as correct (the
    kernel's ``gold >= max`` rule, not argmax)."""
    lg, lab = _logits(64, 50, seed=2)
    lg[0, :] = 1.0
    lab[0] = 7                       # every logit ties: correct, pmax = 1/V
    lb = jnp.asarray(lg, jnp.bfloat16)
    ce, cor, pm = loss_confidence_kernel(lb, jnp.asarray(lab), interpret=True)
    ce_t, cor_t, pm_t = lc.loss_confidence_plain(
        torch.from_numpy(lg).to(torch.bfloat16), torch.from_numpy(lab))
    assert (np.array_equal(cor_t.numpy().astype(np.int32), np.asarray(cor))
            and cor_t[0] == 1)
    _close(ce_t, ce)
    _close(pm_t, pm)
    assert abs(float(pm_t[0]) - 1 / 50) < 1e-7


# ---------------------------------------------------------------------------
# B2 minmax / B3 histogram
# ---------------------------------------------------------------------------


def _selection(n, invalid, kind, seed=0):
    r = np.random.default_rng(seed)
    loss = {"exp": lambda: r.exponential(1.0, n),
            "equal": lambda: np.full(n, 2.5),
            "zeros": lambda: np.where(r.random(n) < 0.5, -0.0, 0.0),
            "normal": lambda: r.normal(size=n) * 5}[kind]().astype(np.float32)
    if invalid == "single":
        return loss, np.arange(n) == n // 3
    return loss, r.random(n) >= invalid


CASES = [(1000, 0.2, "normal"), (2048, 0.0, "exp"), (3000, 0.3, "exp"),
         (777, 1.0, "exp"), (500, 0.0, "equal"), (600, 0.2, "zeros"),
         (2048, "single", "exp")]


@pytest.mark.parametrize("n,invalid,kind", CASES)
def test_minmax_plain_matches_pallas_kernel(n, invalid, kind):
    loss, valid = _selection(n, invalid, kind)
    want = np.asarray(jops.loss_minmax(jnp.asarray(loss), jnp.asarray(valid),
                                       interpret=True))
    got = ts.minmax_plain(torch.from_numpy(loss), torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert np.array_equal(got.numpy(), want)
    if n % 2048 == 0:               # the kernel itself, unpadded
        direct = minmax_kernel(jnp.asarray(loss), jnp.asarray(valid),
                               interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(direct))


@pytest.mark.parametrize("n,invalid,kind", CASES)
@pytest.mark.parametrize("bins", [512, 64])
def test_histogram_plain_matches_pallas_kernel(n, invalid, kind, bins):
    loss, valid = _selection(n, invalid, kind, seed=1)
    lo_hi = np.asarray(jops.loss_minmax(jnp.asarray(loss), jnp.asarray(valid),
                                        interpret=True))
    lo = np.minimum(lo_hi[0], lo_hi[1])
    want = np.asarray(jops.loss_histogram(
        jnp.asarray(loss), jnp.asarray(valid), jnp.float32(lo),
        jnp.float32(lo_hi[1]), bins, interpret=True))
    got = ts.histogram_plain(torch.from_numpy(loss), torch.from_numpy(valid),
                             torch.from_numpy(lo_hi), bins)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == int(valid.sum())
    if n % 2048 == 0:
        direct = histogram_kernel(jnp.asarray(loss), jnp.asarray(valid),
                                  jnp.float32(lo), jnp.float32(lo_hi[1]),
                                  bins=bins, interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(direct))


@pytest.mark.parametrize("n", [2048, 4096])
def test_histogram_with_range_matches_pallas(n):
    """The histogram-select's range and histogram stages against the
    reference's two kernels chained on the device."""
    loss, valid = _selection(n, 0.3, "exp", seed=2)
    h, lo, hi = histogram_with_range(jnp.asarray(loss), jnp.asarray(valid),
                                     interpret=True)
    _, _, h_t, lo_hi, _ = ts.histogram_select_plain(
        torch.from_numpy(loss), torch.from_numpy(valid), 0.3)
    assert np.array_equal(h_t.numpy(), np.asarray(h))
    assert float(lo_hi[0]) == float(lo) and float(lo_hi[1]) == float(hi)


def test_ops_wrappers_match_jax_ops():
    """``histogram_select`` on CPU tensors (its plain version) against the
    reference's ``ops.loss_minmax`` and ``ops.loss_histogram``."""
    loss, valid = _selection(1500, 0.25, "exp", seed=3)
    lo, hi = jops.loss_minmax(jnp.asarray(loss), jnp.asarray(valid),
                              interpret=True)
    _, high, hist, lo_hi, _ = ts.histogram_select(
        torch.from_numpy(loss), torch.from_numpy(valid), 0.3, 0.02)
    assert float(lo_hi[0]) == float(lo) and float(lo_hi[1]) == float(hi)
    want = jops.loss_histogram(jnp.asarray(loss), jnp.asarray(valid),
                               jnp.minimum(lo, hi), hi, 512, interpret=True)
    assert np.array_equal(hist.numpy(), np.asarray(want))
    assert high is not None and high.shape == (1500,)
    assert backend.LAUNCHES["histogram_select"] == 0


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor takes the plain version; anything else goes to the
    kernel path, whose checks refuse what is not on a CUDA device."""
    lg = torch.zeros(4, 10, device="meta")
    lab = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lc.loss_confidence(lg, lab)
    loss = torch.zeros(8, device="meta")
    valid = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ts.histogram_select(loss, valid, 0.3)
    with pytest.raises(ValueError, match="CUDA"):
        ts.histogram_select(loss, valid, 0.3, 0.02, bins=64)
    with pytest.raises(ValueError, match="want loss"):
        ts.histogram_select(loss, valid[:4], 0.3)
    with pytest.raises(ValueError, match="logits"):
        lc.loss_confidence(torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    assert backend.LAUNCHES["loss_confidence"] == 0
    assert backend.LAUNCHES["histogram_select"] == 0


# ---------------------------------------------------------------------------
# Fused scoring: forward and the analytic gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,v", [(128, 10), (64, 1000), (7, 33)])
def test_fused_loss_metrics_grad_matches_jax(t, v):
    lg, lab = _logits(t, v, seed=3)
    w = np.random.default_rng(4).random(t).astype(np.float32)

    def jloss(a):
        return jnp.mean(jops.fused_loss_metrics(a, jnp.asarray(lab))[0] * w)

    g_j = jax.grad(jloss)(jnp.asarray(lg))
    ce_j, pa_j, pc_j = jops.fused_loss_metrics(jnp.asarray(lg), jnp.asarray(lab))

    x = torch.from_numpy(lg).requires_grad_(True)
    ce, pa, pc = tops.fused_loss_metrics(x, torch.from_numpy(lab))
    (ce * torch.from_numpy(w)).mean().backward()
    assert pa.dtype == torch.bool and not pa.requires_grad
    assert not pc.requires_grad
    assert np.array_equal(pa.numpy(), np.asarray(pa_j))
    _close(ce.detach(), ce_j)
    _close(pc, pc_j)
    _close(x.grad, g_j)


def test_fused_loss_metrics_bf16_grad_dtype():
    lg, lab = _logits(16, 20, seed=5)
    x = torch.from_numpy(lg).to(torch.bfloat16).requires_grad_(True)
    ce, _, _ = tops.fused_loss_metrics(x, torch.from_numpy(lab))
    ce.mean().backward()
    assert ce.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    g_j = jax.grad(lambda a: jnp.mean(jops.fused_loss_metrics(
        a, jnp.asarray(lab))[0]))(jnp.asarray(lg, jnp.bfloat16))
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(g_j, np.float32), rtol=0, atol=1e-2)
