"""Gradient compression with error feedback (EF-SGD style).

Port of ``repro/dist/compression.py``.  Per-leaf uniform 8-bit
quantization: each step quantizes ``v = g + e`` (the gradient plus the
carried error) to the levels ``-127 .. 127`` of its own scale
``max(max|v|, 1e-12) / 127``, rounding half to even as ``jnp.round`` does,
and carries the residual ``v - q`` into the next step.  Error feedback
keeps the accumulated compressed gradients within one step's quantization
error of the true sum, so convergence is unaffected while the wire format
shrinks 4x (a collective would ship int8 and one float32 scale a leaf).

The residual is ``v - q`` as written, each of ``q = r * scale`` and the
difference rounded to float32 (the reference run op by op).  Under
``jax.jit`` on the CPU, XLA contracts the reference's ``v - round(v / s) *
s`` into a fused multiply-add in its vectorised loops (not in scalar
code), so the jitted reference's residual differs from this one in the
last bit in about one element in nine of a long leaf; the compressed
gradients agree bit for bit (ROADMAP C).

The port works on lists of tensors, in place and without a host sync, so
that the trainer's step still captures into a CUDA graph: ``v`` is built
in the residual's storage, the quantized gradient written into the
gradient's.  ``TrainConfig.grad_compression`` wires it into
``Trainer.train_step``, after the numeric guard's ``zero_if``.  The
reference's is plain jnp, so this is plain PyTorch (foreach ops).
"""
from __future__ import annotations

import torch

#: Symmetric int8: the quantized values are ``k * scale``, |k| <= 127.
LEVELS = 127.0
#: The scale's floor, for an all-zero ``v``.
MIN_AMAX = 1e-12


def init_error_feedback(params: list[torch.Tensor]) -> list[torch.Tensor]:
    """The zero residual, one tensor a parameter (call once at startup)."""
    return [torch.zeros_like(p, memory_format=torch.contiguous_format)
            .detach() for p in params]


@torch.no_grad()
def compress_grads(grads: list[torch.Tensor], ef: list[torch.Tensor]):
    """Quantize ``grads + ef`` leaf by leaf, in place: ``grads`` becomes the
    compressed gradients and ``ef`` the new residuals.  Returns both
    lists."""
    if not grads:
        return grads, ef
    torch._foreach_add_(ef, grads)                       # v = g + e
    scale = torch._foreach_norm(ef, float("inf"))        # max |v|
    torch._foreach_clamp_min_(scale, MIN_AMAX)
    torch._foreach_div_(scale, LEVELS)
    q = torch._foreach_div(ef, scale)
    torch._foreach_round_(q)                             # half to even
    torch._foreach_mul_(q, scale)
    torch._foreach_copy_(grads, q)                       # g <- q
    torch._foreach_sub_(ef, q)                           # e <- v - q
    return grads, ef
