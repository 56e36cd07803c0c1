"""PyTorch port, fused scoring: B1's backward and the differentiable triple.

- ``loss_confidence_backward_plain`` (what B1's backward wrapper runs on a
  CPU tensor) against ``jax.vjp`` of the JAX package's
  ``repro.kernels.ops.fused_loss_metrics``, whose bwd it ports, with a
  random per-row cotangent: float32 within 1e-6, bfloat16 within one bf16
  ulp (both compute in float32 and round once; their ``ce`` differ in the
  last bits, which may carry one rounding across a bf16 boundary);
- ``ops._FusedLossMetrics`` on the CPU: its gradient is the plain
  backward's bit for bit, PA is bool and carries no gradient, and the three
  outputs do not share storage;
- the slice as a whole at the reference's wide-head fused-scoring model
  (``benchmarks/step_throughput.py::fused_scoring_main``, narrowed): the
  gradient of the fused-scoring loss against the JAX package's;
- the wrapper refuses a tensor that is neither on the CPU nor on CUDA.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against these plain versions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro_torch.kernels import backend
from repro_torch.kernels import loss_confidence as lc
from repro_torch.kernels import ops as tops
from repro_torch.models import cnn

SHAPES = [(128, 10), (64, 1000), (7, 33), (3, 8192)]


def _inputs(t, v, seed):
    r = np.random.default_rng(seed)
    return ((r.normal(size=(t, v)) * 3).astype(np.float32),
            r.integers(0, v, t).astype(np.int32),
            r.normal(size=t).astype(np.float32))


def _jax_grad(logits, labels, g):
    """``jax.vjp`` of the reference's fused scoring, cotangent g on ce."""
    (ce, pa, pc), vjp = jax.vjp(
        lambda a: jops.fused_loss_metrics(a, jnp.asarray(labels)), logits)
    zero_pa = np.zeros(pa.shape, dtype=jax.dtypes.float0)
    return vjp((jnp.asarray(g), zero_pa, jnp.zeros_like(pc)))[0]


def _plain_grad(logits, labels, g):
    ce, _, _ = lc.loss_confidence_plain(logits, labels)
    return lc.loss_confidence_backward_plain(logits, labels, ce, g)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps: the sign-magnitude bits mapped to a monotone
    integer (+0 and -0 both to 0)."""
    def key(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize("t,v", SHAPES)
def test_backward_plain_matches_jax_vjp_f32(t, v):
    lg, lab, g = _inputs(t, v, seed=t + v)
    want = np.asarray(_jax_grad(jnp.asarray(lg), lab, g))
    got = _plain_grad(torch.from_numpy(lg), torch.from_numpy(lab),
                      torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (t, v)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("t,v", SHAPES)
def test_backward_plain_matches_jax_vjp_bf16(t, v):
    lg, lab, g = _inputs(t, v, seed=2 * t + v)
    want = _jax_grad(jnp.asarray(lg, jnp.bfloat16), lab, g)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    got = _plain_grad(torch.from_numpy(lg).bfloat16(), torch.from_numpy(lab),
                      torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    assert int(_bf16_ulps(got, want).max()) <= 1


def test_bf16_ulp_distance():
    x = torch.tensor([1.0, 1.0, -2.0, 0.0, -0.0, 3.0]).bfloat16()
    y = torch.tensor([1.0, 1.0078125, -2.015625, -0.0, 0.0, -3.0]).bfloat16()
    assert _bf16_ulps(x, y).tolist() == [0, 1, 1, 0, 0, 2 * 16448]


def test_backward_wrapper_on_cpu_is_the_plain_version():
    lg, lab, g = (torch.from_numpy(a) for a in _inputs(16, 40, seed=1))
    ce, _, _ = lc.loss_confidence(lg, lab)
    # A stride-0 cotangent, as the mean's gradient arrives.
    gm = torch.full((), 1 / 16).expand(16)
    for gg in (g, gm):
        assert torch.equal(lc.loss_confidence_backward(lg, lab, ce, gg),
                           lc.loss_confidence_backward_plain(lg, lab, ce, gg))
    assert backend.LAUNCHES[lc.BWD_NAME] == 0


@pytest.mark.parametrize("t,v", [(128, 10), (7, 33), (3, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_grad_is_the_plain_backward_bit_for_bit(t, v, dtype):
    lg, lab, g = (torch.from_numpy(a) for a in _inputs(t, v, seed=3))
    x = lg.to(dtype).requires_grad_(True)
    ce, pa, pc = tops.fused_loss_metrics(x, lab)
    (grad,) = torch.autograd.grad(ce, x, g)
    assert grad.dtype == dtype
    assert torch.equal(grad, lc.loss_confidence_backward_plain(
        x.detach(), lab, ce.detach(), g))
    # The mean's gradient, as the trainer's loss has it.
    ce, _, _ = tops.fused_loss_metrics(x, lab)
    ce.mean().backward()
    assert torch.equal(x.grad, lc.loss_confidence_backward_plain(
        x.detach(), lab, ce.detach(), torch.full((t,), 1.0) / t))


def test_fused_outputs_pa_bool_without_grad_and_not_aliased():
    lg, lab, g = (torch.from_numpy(a) for a in _inputs(32, 50, seed=4))
    x = lg.clone().requires_grad_(True)
    ce, pa, pc = tops.fused_loss_metrics(x, lab)
    assert ce.requires_grad and ce.dtype == torch.float32
    assert pa.dtype == torch.bool and not pa.requires_grad and pa.grad_fn is None
    assert pc.dtype == torch.float32 and not pc.requires_grad
    storages = {t.untyped_storage().data_ptr() for t in (ce, pa, pc)}
    assert len(storages) == 3
    ce0, pa0 = ce.detach().clone(), pa.clone()
    # A caller's in-place change of PA or PC leaves ce and its gradient be.
    pa.logical_not_()
    pc.mul_(0.0)
    assert torch.equal(ce.detach(), ce0)
    assert torch.equal(pa, ~pa0) and not pc.any()
    (grad,) = torch.autograd.grad(ce, x, g)
    assert torch.equal(grad, lc.loss_confidence_backward_plain(lg, lab, ce0, g))


def test_ops_loss_confidence_returns_bool():
    lg, lab, _ = (torch.from_numpy(a) for a in _inputs(6, 12, seed=5))
    ce, cor, pm = tops.loss_confidence(lg.reshape(2, 3, 12), lab.reshape(2, 3))
    assert cor.dtype == torch.bool and cor.shape == (2, 3)
    want = lc.loss_confidence_plain(lg, lab)
    assert torch.equal(cor.reshape(-1), want[1])
    assert torch.equal(ce.reshape(-1), want[0])


def test_wide_head_fused_scoring_grad_matches_jax():
    """The reference's wide-head fused-scoring model (``fused_scoring_main``:
    image 8, widths (8,), hidden 32), narrowed to 512 classes and batch 64:
    d mean(ce * w) / d params, the fused-scoring loss of the train step,
    against the JAX package's on the same params and batch."""
    kw = dict(image_size=8, widths=(8,), hidden=32, num_classes=512)
    jcfg, tcfg = jcnn.CNNConfig(**kw), cnn.CNNConfig(**kw)
    params = {k: np.array(v) for k, v in
              jcnn.init(jax.random.key(0), jcfg).items()}
    r = np.random.default_rng(6)
    images = r.normal(size=(64, 8, 8, 3)).astype(np.float32)
    labels = r.integers(0, 512, 64).astype(np.int32)
    w = r.random(64).astype(np.float32)

    def jloss(p):
        logits = jcnn.forward(p, jcfg, jnp.asarray(images))
        ce, _, _ = jops.fused_loss_metrics(logits, jnp.asarray(labels))
        return jnp.mean(ce * w)

    jgrads = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    model = cnn.CNN(tcfg)
    model.load_state_dict(cnn.params_from_jax(params, tcfg))
    ce, _, _ = tops.fused_loss_metrics(model(torch.from_numpy(images)),
                                       torch.from_numpy(labels))
    (ce * torch.from_numpy(w)).mean().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    want = cnn.params_from_jax({k: np.asarray(v) for k, v in jgrads.items()},
                               tcfg)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_backward_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain version; anything else goes to the
    kernel path, whose checks refuse what is not on a CUDA device."""
    lg = torch.zeros(4, 10, device="meta")
    lab = torch.zeros(4, dtype=torch.int32, device="meta")
    ce = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lc.loss_confidence_backward(lg, lab, ce, ce)
    cpu = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        lc.loss_confidence_backward(torch.zeros(4, 10),
                                    torch.zeros(4, dtype=torch.int32), cpu,
                                    torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="want ce and g"):
        lc.loss_confidence_backward(torch.zeros(4, 10),
                                    torch.zeros(4, dtype=torch.int32), cpu,
                                    torch.zeros(3))
    with pytest.raises(ValueError, match="logits"):
        lc.loss_confidence_backward(cpu, cpu.int(), cpu, cpu)
    assert backend.LAUNCHES[lc.BWD_NAME] == 0
