"""Mamba2 SSD (state-space duality) block: chunked scan and recurrent decode.

Port of ``repro/models/ssm.py``.  The minimal SSD formulation (Dao & Gu
2024, arXiv:2405.21060):
  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x)    per head, state size N
  y_t = C_t . h_t + D * x_t
computed chunk-parallel by ``kernels/ops.ssd_scan``: kernel B6 on the card,
its plain version (``ssd_scan_ref`` here, the oracle's twin) on the CPU.
The JAX block chooses between the two with ``use_kernel``; the port chooses
by the device of the tensors, so on the card the plain scan never runs
forward.  B6 carries a gradient: ``ops.ssd_scan`` is an autograd Function
whose forward is the kernel and whose backward recomputes the plain scan
from the saved inputs and differentiates it, the gradient the reference's
trainer takes through ``ssd_scan_ref`` (to x, dt, B, C, ``a_log`` and
``d_skip``, and through them to ``w_in`` and the conv).

Single B/C group (n_groups = 1) as in mamba2-130m.  A depthwise causal conv
of width ``conv_width`` over (x, B, C) precedes the scan, written as the
reference's sum of shifted products (no cuDNN, so no TF32); decode keeps
the last ``conv_width - 1`` inputs as a buffer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_scan_ref  # noqa: F401
from repro_torch.models.common import ParamDef, rms_norm


def ssm_param_defs(d_model: int, ssm, d_inner: int) -> dict:
    n, nh = ssm.state_dim, d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * n
    return {
        # in_proj -> z (gate, d_inner) | x (d_inner) | B (N) | C (N) | dt (nh)
        "w_in": ParamDef((d_model, 2 * d_inner + 2 * n + nh), ("fsdp", "tp")),
        "conv_w": ParamDef((ssm.conv_width, conv_dim), (None, "tp"),
                           scale=0.5),
        "conv_b": ParamDef((conv_dim,), ("tp",), init="zeros"),
        "a_log": ParamDef((nh,), (None,), init="a_log"),
        "d_skip": ParamDef((nh,), (None,), init="ones"),
        "dt_bias": ParamDef((nh,), (None,), init="zeros"),
        "norm_w": ParamDef((d_inner,), ("tp",), init="ones"),
        "w_out": ParamDef((d_inner, d_model), ("tp", "fsdp")),
    }


def _split_in(p, x, d_inner, n, nh):
    proj = x @ p["w_in"].to(x.dtype)
    z, xin, b, c, dt = torch.split(proj, [d_inner, d_inner, n, n, nh], dim=-1)
    return z, xin, b, c, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. xbc: (B,S,C); w: (W,C)."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(width))
    return F.silu(out + bias)


def ssm_forward(p: dict, x: torch.Tensor, ssm, d_inner: int,
                norm_eps: float = 1e-6, return_state: bool = False):
    """Full-sequence SSD block forward. x: (B,S,d_model) -> (B,S,d_model).

    With ``return_state`` also returns the decode cache (final SSM state +
    conv buffer) so prefill can hand off to recurrent decoding.
    """
    n, nh, hd = ssm.state_dim, d_inner // ssm.head_dim, ssm.head_dim
    z, xin, b, c, dt = _split_in(p, x, d_inner, n, nh)
    xbc_pre = torch.cat([xin, b, c], dim=-1)
    xbc = _causal_conv(xbc_pre, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xin, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    xh = xin.reshape(*xin.shape[:2], nh, hd)
    dt = dt + p["dt_bias"].to(dt.dtype)
    y, h_final = kops.ssd_scan(xh, dt, p["a_log"], b, c, p["d_skip"], ssm.chunk)
    y = y.reshape(*y.shape[:2], d_inner)
    y = y * F.silu(z)                                        # gated
    y = rms_norm(y, p["norm_w"], norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    if return_state:
        return out, h_final, xbc_pre[:, -(ssm.conv_width - 1):, :]
    return out


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------


def ssm_init_cache(batch: int, ssm, d_inner: int, dtype=torch.float32,
                   device: torch.device | str | None = None) -> dict:
    """A zero decode cache on ``device`` (None: CUDA)."""
    device = resolve_device(device)
    n, nh, hd = ssm.state_dim, d_inner // ssm.head_dim, ssm.head_dim
    return {
        "state": torch.zeros(batch, nh, n, hd, dtype=torch.float32,
                             device=device),
        "conv_buf": torch.zeros(batch, ssm.conv_width - 1, d_inner + 2 * n,
                                dtype=dtype, device=device),
    }


def ssm_decode_step(p: dict, x: torch.Tensor, cache: dict, ssm, d_inner: int,
                    norm_eps: float = 1e-6):
    """One-token recurrent update. x: (B,1,d_model).  Returns the output and
    a new cache (the old one is not modified)."""
    n, nh, hd = ssm.state_dim, d_inner // ssm.head_dim, ssm.head_dim
    z, xin, b, c, dt = _split_in(p, x, d_inner, n, nh)
    xbc = torch.cat([xin, b, c], dim=-1)                      # (B,1,conv_dim)
    window = torch.cat([cache["conv_buf"].to(xbc.dtype), xbc], dim=1)
    conv_w = p["conv_w"].to(x.dtype)
    out = (window * conv_w).sum(dim=1) + p["conv_b"].to(x.dtype)
    xbc1 = F.silu(out)[:, None, :]
    new_buf = window[:, 1:, :]
    xin, b, c = torch.split(xbc1, [d_inner, n, n], dim=-1)
    xh = xin.reshape(-1, nh, hd).float()                      # (B,NH,P)
    b1, c1 = b[:, 0].float(), c[:, 0].float()                 # (B,N)
    dt1 = F.softplus((dt[:, 0] + p["dt_bias"]).float())       # (B,NH)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt1 * a)                                # (B,NH)
    upd = dt1[:, :, None, None] * b1[:, None, :, None] * xh[:, :, None, :]
    state = cache["state"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c1, state)
    y = y + p["d_skip"].float()[None, :, None] * xh
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm_w"], norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    return out, {"state": state, "conv_buf": new_buf}
