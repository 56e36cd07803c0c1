"""Forward attention with an online softmax: causal or not, GQA.

Port of ``repro/kernels/flash_attention.py`` (the Pallas kernel reached
through ``repro/kernels/ops.py::flash_attention``).  The CUDA kernel lives
in ``csrc/flash_attention.cu``; ``flash_attention_plain`` is its plain
PyTorch version, the twin of the oracle ``repro/kernels/ref.py::
flash_attention_ref``: GQA by reshape, scores in float32 times ``d ** -0.5``
after the product, masked entries ``-1e30``, the softmax in float32, the
probabilities cast to q's dtype before the product with V.

Shapes, as the reference's public layout: q (B, S, Hq, D), k and v
(B, S, Hkv, D) with ``Hq % Hkv == 0``; query head h reads KV head
``h // (Hq / Hkv)``.  Returns (B, S, Hq, D) in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

NAME = "flash_attention"
#: The head dimensions the kernel is built for (``csrc/flash_attention.cu``).
HEAD_DIMS = (16, 32, 64, 112, 128)
NEG_INF = -1e30
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Attention in plain PyTorch (the reference's ``flash_attention_ref``)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    q5 = q.reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(), k.float()) * d ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, s, hq, d)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{NAME}: q, k and v must be (B, S, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"{NAME}: k and v must be (B, S, Hkv, D) = ({b}, {s}, "
                         f"Hkv, {d}); got {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{NAME}: Hq = {hq} must be a multiple of Hkv = "
                         f"{k.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{NAME}: {name}'s last dimension must be dense "
                             f"(stride 1), got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Kernel B7: ``softmax(q k^T * d^-0.5) v`` per head.

    CPU tensors take ``flash_attention_plain``; CUDA tensors launch the
    kernel (float32 or bfloat16, all three of one type; D in
    ``HEAD_DIMS``; any S) or raise, and raise on an input that requires
    grad in grad mode (the launch has no backward: ``ops.flash_attention``
    carries the gradient).  The kernel reads q, k and v in place
    through their strides, so only their last dimension must be dense (on
    either device); the output is a new contiguous (B, S, Hq, D) tensor.
    """
    _check(q, k, v)
    tensors = {"q": q, "k": k, "v": v}
    if all(t.device.type == "cpu" for t in tensors.values()):
        return flash_attention_plain(q, k, v, causal)
    backend.refuse_grad(NAME, tensors)
    dev = backend.check_cuda(NAME, tensors, contiguous=False)
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{NAME}: q, k and v must all be float32 or all "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: the kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if b * hq >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"{NAME}: shape {tuple(q.shape)} too large")
    out = torch.empty(b, s, hq, d, dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    backend.launch(_ENTRY[q.dtype], NAME, dev, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), b, s, hq, hkv, d, int(causal),
                   d ** -0.5, strides)
    return out
