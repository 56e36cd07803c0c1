"""Fused per-sample (CE, prediction accuracy, prediction confidence), and
the analytic gradient of the CE.

Port of ``repro/kernels/loss_confidence.py``.  KAKURENBO needs (loss, PA, PC)
for every sample of every step (paper Sec. 3.4); one online-softmax pass
over each row of the (T, V) logits gives all three.  The gradient of ``ce``
is the reference's custom_vjp bwd (``repro/kernels/ops.py``): one
elementwise pass over the logits, with lse rebuilt from the saved ``ce``.
Both CUDA kernels live in ``csrc/loss_confidence.cu``;
``loss_confidence_plain`` (the twin of ``repro.kernels.ops._reference_metrics``)
and ``loss_confidence_backward_plain`` are their plain PyTorch versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend

NAME = "loss_confidence"
BWD_NAME = "loss_confidence_bwd"
#: Largest T or V the kernels index with 32-bit ints (a column tile past V
#: must still fit).
MAX_DIM = 2 ** 31 - 2 ** 16
_FORWARD = {torch.float32: "lc_forward_f32", torch.bfloat16: "lc_forward_bf16"}
_BACKWARD = {torch.float32: "lc_backward_f32",
             torch.bfloat16: "lc_backward_bf16"}


def loss_confidence_plain(logits: torch.Tensor, labels: torch.Tensor):
    """(T, V) logits, (T,) labels -> (ce f32, correct bool, pmax f32), (T,).

    Two reductions (max, sum-exp) and the gold gather; ``correct`` is
    ``gold >= max``, the kernel's tie rule (not argmax).
    """
    lf = logits.float()
    m = lf.amax(dim=-1)
    sumexp = torch.exp(lf - m[:, None]).sum(dim=-1)
    lse = m + torch.log(sumexp)
    gold = lf.gather(1, labels.long()[:, None])[:, 0]
    ce = lse - gold
    correct = gold >= m
    pmax = 1.0 / sumexp
    return ce, correct, pmax


def loss_confidence_backward_plain(logits: torch.Tensor, labels: torch.Tensor,
                                   ce: torch.Tensor,
                                   g: torch.Tensor) -> torch.Tensor:
    """d(sum(ce * g))/d(logits) in the logits' dtype: ``(softmax - onehot) *
    g`` with lse rebuilt as ``ce + gold`` from the saved forward result."""
    lf = logits.float()
    lab = labels.long()[:, None]
    gold = lf.gather(1, lab)[:, 0]
    lse = ce + gold
    probs = torch.exp(lf - lse[:, None])
    onehot = lab == torch.arange(lf.shape[1], device=lf.device)
    return ((probs - onehot.float()) * g[:, None]).to(logits.dtype)


def _check(name: str, logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{name}: want logits (T, V) and labels (T,); got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")


def _entry(name: str, entries: dict, logits: torch.Tensor,
           labels: torch.Tensor) -> str:
    entry = entries.get(logits.dtype)
    if entry is None:
        raise ValueError(f"{name}: logits must be float32 or bfloat16, got "
                         f"{logits.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"{name}: labels must be int32, got {labels.dtype}")
    if max(logits.shape) > MAX_DIM:
        raise ValueError(f"{name}: shape {tuple(logits.shape)} too large")
    return entry


def loss_confidence(logits: torch.Tensor, labels: torch.Tensor):
    """Kernel B1: ``(ce f32, correct bool, pmax f32)`` for (T, V) logits.

    A CPU tensor takes ``loss_confidence_plain``; meta tensors in the dry
    run empty outputs, the work credited (``backend.on_meta``); a CUDA tensor
    launches the kernel (f32 or bf16 logits, i32 labels, any T and V) or
    raises (also on logits that require grad in grad mode:
    ``ops.fused_loss_metrics`` carries the gradient).  One
    launch, three separate outputs (a caller may change any in place).
    """
    _check(NAME, logits, labels)
    if logits.is_cpu and labels.is_cpu:
        return loss_confidence_plain(logits, labels)
    backend.refuse_grad(NAME, {"logits": logits})
    t, v = logits.shape
    if backend.on_meta((logits, labels)):
        backend.credit_meta(NAME, 5 * t * v,
                            logits.element_size() * t * v + 13 * t)
        return (torch.empty(t, dtype=torch.float32, device="meta"),
                torch.empty(t, dtype=torch.bool, device="meta"),
                torch.empty(t, dtype=torch.float32, device="meta"))
    dev = backend.check_cuda(NAME, {"logits": logits, "labels": labels})
    entry = _entry(NAME, _FORWARD, logits, labels)
    ce = torch.empty(t, dtype=torch.float32, device=dev)
    correct = torch.empty(t, dtype=torch.bool, device=dev)
    pmax = torch.empty(t, dtype=torch.float32, device=dev)
    backend.launch(entry, NAME, dev, logits.data_ptr(), labels.data_ptr(),
                   ce.data_ptr(), correct.data_ptr(), pmax.data_ptr(), t, v)
    return ce, correct, pmax


def loss_confidence_backward(logits: torch.Tensor, labels: torch.Tensor,
                             ce: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """B1's backward: ``dlogits`` (T, V) in the logits' dtype from the
    forward's ``ce`` and the cotangent ``g`` (T,) of ``ce``.

    A CPU tensor takes ``loss_confidence_backward_plain``; meta tensors in
    the dry run an empty output, the work credited; a CUDA tensor launches
    the kernel or raises.  ``g`` is read through its stride, so
    the mean's expanded gradient (stride 0) needs no copy.
    """
    _check(BWD_NAME, logits, labels)
    if ce.shape != labels.shape or g.shape != labels.shape:
        raise ValueError(f"{BWD_NAME}: want ce and g of shape "
                         f"{tuple(labels.shape)}; got {tuple(ce.shape)} and "
                         f"{tuple(g.shape)}")
    if logits.is_cpu and labels.is_cpu and ce.is_cpu and g.is_cpu:
        return loss_confidence_backward_plain(logits, labels, ce, g)
    if backend.on_meta((logits, labels, ce, g)):
        t, v = logits.shape
        backend.credit_meta(BWD_NAME, 5 * t * v,
                            2 * logits.element_size() * t * v + 16 * t)
        return torch.empty_like(logits)
    dev = backend.check_cuda(BWD_NAME, {"logits": logits, "labels": labels,
                                        "ce": ce})
    if g.device != dev:
        raise ValueError(f"{BWD_NAME}: g lies on {g.device}, not {dev}")
    entry = _entry(BWD_NAME, _BACKWARD, logits, labels)
    if ce.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"{BWD_NAME}: ce and g must be float32, got "
                         f"{ce.dtype} and {g.dtype}")
    t, v = logits.shape
    dlogits = torch.empty_like(logits)
    backend.launch(entry, BWD_NAME, dev, logits.data_ptr(), labels.data_ptr(),
                   ce.data_ptr(), g.data_ptr(), g.stride(0),
                   dlogits.data_ptr(), t, v)
    return dlogits
