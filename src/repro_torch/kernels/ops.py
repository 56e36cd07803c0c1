"""Public wrappers over the kernels, and the differentiable fused scoring.

Port of ``repro/kernels/ops.py``.  Each
wrapper dispatches by the device of its inputs: the plain PyTorch version on
the CPU, the CUDA kernel on a CUDA tensor.  Unlike the JAX package there is
no padding to a block grid: the kernels mask their ragged edges.

``fused_loss_metrics`` is the train hot path's entry point: the per-sample
(ce, PA, PC) triple of paper Sec. 3.4 in one streaming pass, differentiable
through ``ce`` by an analytic backward (``torch.autograd.Function``).

``ssd_scan`` (B6) and ``flash_attention`` (B7) carry a gradient too.  The
JAX package has no backward for either kernel: its trainer differentiates
the plain forms (``ssd_scan_ref``, the jnp ``attend``).  So on CUDA tensors
each goes through an autograd Function whose forward launches the kernel
and whose backward recomputes the kernel's plain version from the saved
inputs and returns its ``torch.autograd.grad``: the reference's gradient,
beside the kernel's forward numerics (which the no-grad selection pass and
the refresh see as well).  A kernel wrapper itself makes no autograd node
and refuses inputs that need a gradient while grad mode is on
(``backend.refuse_grad``).  On meta tensors in the dry run
(``backend.crediting``) the Functions' backward recomputes nothing:
``meta_grads`` returns empty gradients and credits the plain backward's
operations by formula.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import loss_confidence as _lc
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import threshold_select as _ts


def loss_confidence(logits: torch.Tensor, labels: torch.Tensor):
    """(..., V) logits + (...) labels -> per-element (ce, correct, pmax)."""
    shape = labels.shape
    ce, cor, pmax = _lc.loss_confidence(
        logits.reshape(-1, logits.shape[-1]).contiguous(),
        labels.reshape(-1).contiguous())
    return ce.reshape(shape), cor.reshape(shape), pmax.reshape(shape)


def rank_select(scores: torch.Tensor, k, high: bool = False) -> torch.Tensor:
    """Exact (N,) bool mask of the ``k`` smallest (or largest) scores by
    count-then-select, equal to the stable-argsort rank masks (see
    ``threshold_select.rank_select_mask`` for the tie contract): the one
    rank-select kernel (B4 and B5) on a CUDA tensor, its plain version on a
    CPU one."""
    return _ts.rank_select_mask(scores, k, high=high)


def plain_grads(plain, saved, needs_grad, grads) -> tuple:
    """The gradient of ``plain(*saved)`` against the output cotangents
    ``grads`` (None: that output has none), for each input whose
    ``needs_grad`` is set (None for the others): ``plain`` recomputed under
    ``torch.enable_grad()`` from detached copies of the saved inputs."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(bool(n))
                  for t, n in zip(saved, needs_grad)]
        outs = plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if wrt and pairs else ())
    return tuple(next(got, None) if n else None for n in needs_grad)


#: A backward through the plain version recomputes the forward's products
#: and makes two more for each (the gradients of both operands).
BACKWARD_OPS_FACTOR = 3


def meta_grads(name: str, saved, needs_grad, ops: float) -> tuple:
    """The backward of a kernel's autograd Function on meta tensors: empty
    gradients of the saved inputs' shapes, ``ops`` (the forward's)
    credited ``BACKWARD_OPS_FACTOR`` times under ``name + "_bwd"``, its
    bytes those of the inputs read and the gradients written."""
    nbytes = sum(t.numel() * t.element_size() for t in saved)
    backend.credit_meta(name + "_bwd", BACKWARD_OPS_FACTOR * ops,
                        nbytes + sum(t.numel() * t.element_size()
                                     for t, n in zip(saved, needs_grad) if n))
    return tuple(torch.empty_like(t) if n else None
                 for t, n in zip(saved, needs_grad))


class _SSDScan(torch.autograd.Function):
    """Forward: kernel B6 (its plain version on the CPU).  Backward: the
    gradient of ``ssd_scan_plain`` recomputed from the saved inputs (the
    reference differentiates ``ssd_scan_ref``); ``chunk`` gets none."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip)
        # The final state's cotangent is None unless a caller uses it.
        ctx.set_materialize_grads(False)
        return _ssd.ssd_scan(x, dt, a_log, b, c, d_skip, chunk)

    @staticmethod
    def backward(ctx, g_y, g_state):
        saved = ctx.saved_tensors
        if backend.on_meta(saved):
            x, b = saved[0], saved[3]
            ops = _ssd.scan_ops(*x.shape[:2], x.shape[2], x.shape[3],
                                b.shape[-1], ctx.chunk)
            return (*meta_grads(_ssd.NAME, saved, ctx.needs_input_grad[:6],
                                ops), None)

        def plain(*t):
            return _ssd.ssd_scan_plain(*t, ctx.chunk)

        return (*plain_grads(plain, saved,
                             ctx.needs_input_grad[:6], (g_y, g_state)), None)


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel B7 (its plain version on the CPU).  Backward: the
    gradient of ``flash_attention_plain`` recomputed from the saved q, k
    and v (the reference differentiates its jnp ``attend``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _fa.flash_attention(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if backend.on_meta(saved):
            b, s, hq, d = saved[0].shape
            ops = _fa.attention_ops(b, s, hq, d, ctx.causal)
            return (*meta_grads(_fa.NAME, saved, ctx.needs_input_grad[:3],
                                ops), None)

        def plain(q, k, v):
            return _fa.flash_attention_plain(q, k, v, ctx.causal)

        return (*plain_grads(plain, saved,
                             ctx.needs_input_grad[:3], (g,)), None)


def ssd_scan(x, dt, a_log, b, c, d_skip, chunk: int = 128):
    """Same signature as ``models.ssm.ssd_scan_ref`` (the oracle).

    x: (B,S,NH,P); dt: (B,S,NH) raw (pre-softplus); b,c: (B,S,N).  Kernel
    B6 on CUDA tensors, which reads x, dt, b and c in place through their
    strides, b and c per batch (no broadcast to the heads), and masks a
    ragged tail instead of padding it, differentiable through its plain
    version (``_SSDScan``); on CPU ones the plain version under autograd.
    Returns y in x's dtype and the final state in float32.
    """
    if x.device.type == "cpu":
        return _ssd.ssd_scan(x, dt, a_log, b, c, d_skip, chunk)
    return _SSDScan.apply(x, dt, a_log, b, c, d_skip, chunk)


def flash_attention(q, k, v, causal: bool = True):
    """q: (B,S,Hq,D); k,v: (B,S,Hkv,D). Returns (B,S,Hq,D) in q's dtype.

    Kernel B7 on CUDA tensors, which reads q, k and v in place through
    their strides (no transposes to a (B.H, S, D) layout) and masks a
    ragged S instead of asserting a block multiple, differentiable through
    its plain version (``_FlashAttention``); on CPU ones the plain version,
    the twin of ``ref.flash_attention_ref``, under autograd.
    """
    if q.device.type == "cpu":
        return _fa.flash_attention(q, k, v, causal)
    return _FlashAttention.apply(q, k, v, causal)


class _FusedLossMetrics(torch.autograd.Function):
    """Forward: kernel B1, one launch (its plain version on the CPU).
    Backward: B1's backward kernel, one launch (its plain version on the
    CPU): the analytic ``(softmax - onehot) * g`` with lse rebuilt as
    ``ce + gold`` from the saved forward result, one elementwise pass over
    the logits.  Only ``ce`` carries gradient; PA/PC are selection
    bookkeeping."""

    @staticmethod
    def forward(ctx, logits, labels):
        ce, correct, pmax = _lc.loss_confidence(logits, labels)
        ctx.save_for_backward(logits, labels, ce)
        ctx.mark_non_differentiable(correct, pmax)
        # PA/PC never get a gradient: make (and launch) no zeros for them.
        ctx.set_materialize_grads(False)
        return ce, correct, pmax

    @staticmethod
    def backward(ctx, g_ce, _g_correct, _g_pmax):
        logits, labels, ce = ctx.saved_tensors
        return _lc.loss_confidence_backward(logits, labels, ce, g_ce), None


def fused_loss_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Per-sample ``(ce, pa, pc)`` from (B, V) logits in one fused pass,
    differentiable through ``ce``."""
    return _FusedLossMetrics.apply(logits.contiguous(), labels.contiguous())
