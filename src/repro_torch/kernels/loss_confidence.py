"""Fused per-sample (CE, prediction accuracy, prediction confidence).

Port of ``repro/kernels/loss_confidence.py``.  KAKURENBO needs (loss, PA, PC)
for every sample of every step (paper Sec. 3.4); one online-softmax pass
over each row of the (T, V) logits gives all three.  The CUDA kernel lives in
``csrc/loss_confidence.cu``; ``loss_confidence_plain`` is its plain PyTorch
version (the twin of ``repro.kernels.ops._reference_metrics``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend

NAME = "loss_confidence"


def loss_confidence_plain(logits: torch.Tensor, labels: torch.Tensor):
    """(T, V) logits, (T,) labels -> (ce f32, correct i32, pmax f32), (T,).

    Two reductions (max, sum-exp) and the gold gather; ``correct`` is
    ``gold >= max``, the kernel's tie rule (not argmax).
    """
    lf = logits.float()
    m = lf.amax(dim=-1)
    sumexp = torch.exp(lf - m[:, None]).sum(dim=-1)
    lse = m + torch.log(sumexp)
    gold = lf.gather(1, labels.long()[:, None])[:, 0]
    ce = lse - gold
    correct = (gold >= m).to(torch.int32)
    pmax = 1.0 / sumexp
    return ce, correct, pmax


def loss_confidence(logits: torch.Tensor, labels: torch.Tensor):
    """Kernel B1: ``(ce, correct_i32, pmax)`` for (T, V) logits.

    A CPU tensor takes ``loss_confidence_plain``; a CUDA tensor launches the
    kernel (f32 or bf16 logits, i32 labels, any T and V) or raises.
    """
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{NAME}: want logits (T, V) and labels (T,); got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.device.type == "cpu" and labels.device.type == "cpu":
        return loss_confidence_plain(logits, labels)
    dev = backend.check_cuda(NAME, {"logits": logits, "labels": labels})
    entry = {torch.float32: "lc_forward_f32",
             torch.bfloat16: "lc_forward_bf16"}.get(logits.dtype)
    if entry is None:
        raise ValueError(f"{NAME}: logits must be float32 or bfloat16, got "
                         f"{logits.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"{NAME}: labels must be int32, got {labels.dtype}")
    t, v = logits.shape
    if max(t, v) >= 2 ** 31:
        raise ValueError(f"{NAME}: shape {tuple(logits.shape)} too large")
    ce = torch.empty(t, dtype=torch.float32, device=dev)
    correct = torch.empty(t, dtype=torch.int32, device=dev)
    pmax = torch.empty(t, dtype=torch.float32, device=dev)
    backend.launch(entry, NAME, dev, logits.data_ptr(), labels.data_ptr(),
                   ce.data_ptr(), correct.data_ptr(), pmax.data_ptr(), t, v)
    return ce, correct, pmax
