"""Mamba2 SSD chunked scan: the outputs y and the final state.

Port of ``repro/kernels/ssd_scan.py`` together with the work that
``repro/kernels/ops.py::ssd_scan`` does around it (softplus, ``a =
-exp(a_log)``, the D skip, the ragged tail).  The CUDA kernel lives in
``csrc/ssd_scan.cu``; ``ssd_scan_plain`` is its plain PyTorch version, the
twin of the oracle ``repro/models/ssm.py::ssd_scan_ref`` (intra-chunk
products, chunk states, a loop over chunks for the carried state).

Shapes, as the reference's: x (B, S, NH, P); dt (B, S, NH), raw (before
the softplus); a_log, d_skip (NH,); b, c (B, S, N), one group shared by
every head.  Returns y (B, S, NH, P) in x's dtype and the final state
(B, NH, N, P) in float32.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import backend

NAME = "ssd_scan"
#: What the kernel takes (``csrc/ssd_scan.cu``): 8 warps of 16 MMA rows
#: cover N and the chunk, and one warp's 8 column tiles cover P.
MAX_STATE_DIM, MAX_HEAD_DIM, MAX_CHUNK = 128, 64, 128


def ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk: int):
    """Chunked SSD in plain PyTorch (the reference's ``ssd_scan_ref``).

    S is padded up to a chunk multiple with dt = -1e30 (softplus 0: an
    identity step with no contribution), then sliced back.
    """
    B, S, NH, P = x.shape
    s_orig = S
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e30)
        S += pad
    N = b.shape[-1]
    nc = S // chunk
    a = -torch.exp(a_log.float())                            # (NH,) < 0
    dt = F.softplus(dt.float())                              # (B,S,NH) >= 0
    dta = dt * a

    xr = x.float().reshape(B, nc, chunk, NH, P)
    dtr = dt.reshape(B, nc, chunk, NH)
    br = b.float().reshape(B, nc, chunk, N)
    cr = c.float().reshape(B, nc, chunk, N)
    cum = torch.cumsum(dta.reshape(B, nc, chunk, NH), dim=2)  # (B,nc,l,NH)
    seg = cum[:, :, -1]                                      # (B,nc,NH)

    # Intra-chunk: mask the exponent, not the product (t < s would overflow).
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,t,s,NH)
    decay = torch.exp(diff.masked_fill(~tri[None, None, :, :, None], -1e30))
    cb = torch.einsum("bctn,bcsn->bcts", cr, br)
    scores = cb[..., None] * decay * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores, xr)

    # Chunk states: sum_s exp(seg - cum_s) dt_s b_s x_s^T.
    w = torch.exp(seg[:, :, None, :] - cum) * dtr            # (B,nc,s,NH)
    states = torch.einsum("bcsh,bcsn,bcshp->bchnp", w, br, xr)

    # Inter-chunk recurrence; each chunk sees the state before it.
    h = torch.zeros(B, NH, N, P, dtype=torch.float32, device=x.device)
    h_prev = []
    for i in range(nc):
        h_prev.append(h)
        h = h * torch.exp(seg[:, i])[:, :, None, None] + states[:, i]
    y_inter = torch.einsum("bctn,bcth,bchnp->bcthp", cr, torch.exp(cum),
                           torch.stack(h_prev, dim=1))

    y = (y_intra + y_inter).reshape(B, S, NH, P)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y[:, :s_orig].to(x.dtype), h


def scan_ops(b: int, s: int, nh: int, p: int, n: int, chunk: int) -> int:
    """B6's operations: the chunked form's products over the chunk lengths
    of ``s``, counting only the causal s <= t half of C.B^T and scores.X,
    C.B^T once per (batch, chunk) (b and c are one group shared by every
    head)."""
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    return b * sum(ln * (ln + 1) * n
                   + nh * (ln * (ln + 1) * p + 4 * ln * n * p) for ln in lens)


def ssd_scan(x, dt, a_log, b, c, d_skip, chunk: int):
    """Kernel B6: ``(y, final_state)`` of the chunked scan.

    A CPU tensor takes ``ssd_scan_plain``; meta tensors in the dry run empty
    outputs, the work credited (``backend.on_meta``); CUDA tensors launch the
    kernel's four steps (float32; N <= 128 and chunk <= 128, multiples of
    4; P <= 64; any S) or raise (also on an input that requires grad in
    grad mode: ``ops.ssd_scan`` carries the gradient), with their scratch (dt, cum, C.B^T per
    chunk, the chunk states: 50 MB at mamba2-130m's serve shape) allocated
    here.  The kernel reads x, dt, b and c through their strides, so
    views such as column slices of one activation need no copy; the last
    dimension of x, b and c must be dense.
    """
    if x.dim() != 4:
        raise ValueError(f"{NAME}: x must be (B, S, NH, P), got {tuple(x.shape)}")
    B, S, NH, P = x.shape
    N = b.shape[-1]
    want = {"dt": (B, S, NH), "a_log": (NH,), "b": (B, S, N), "c": (B, S, N),
            "d_skip": (NH,)}
    got = {"dt": dt, "a_log": a_log, "b": b, "c": c, "d_skip": d_skip}
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{NAME}: {k} must be {shape}, got "
                             f"{tuple(got[k].shape)}")
    tensors = {"x": x, **got}
    if all(t.device.type == "cpu" for t in tensors.values()):
        return ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk)
    backend.refuse_grad(NAME, tensors)
    if backend.on_meta(tensors.values()):
        backend.credit_meta(NAME, scan_ops(B, S, NH, P, N, chunk),
                            4 * (2 * x.numel() + dt.numel() + 2 * b.numel()
                                 + 2 * NH + B * NH * N * P))
        return (torch.empty(B, S, NH, P, dtype=x.dtype, device="meta"),
                torch.empty(B, NH, N, P, dtype=torch.float32, device="meta"))
    dev = backend.check_cuda(NAME, tensors, contiguous=False)
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{NAME}: {k} must be float32, got {t.dtype}")
        if k != "dt" and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{NAME}: {k}'s last dimension must be dense "
                             f"(stride 1), got strides {t.stride()}")
    if not (4 <= N <= MAX_STATE_DIM and 1 <= P <= MAX_HEAD_DIM
            and 4 <= chunk <= MAX_CHUNK and N % 4 == 0 and chunk % 4 == 0):
        raise ValueError(f"{NAME}: the kernel takes N <= {MAX_STATE_DIM} and "
                         f"chunk <= {MAX_CHUNK}, both multiples of 4, and "
                         f"P <= {MAX_HEAD_DIM}; got N={N}, P={P}, chunk={chunk}")
    if max(B * S, B * NH) >= 2 ** 31:
        raise ValueError(f"{NAME}: shape {tuple(x.shape)} too large")
    floats = backend.library().ssd_scan_scratch_floats(B, S, NH, P, N, chunk)
    if floats < 0:
        raise ValueError(f"{NAME}: shape {tuple(x.shape)} too large")
    y = torch.empty(B, S, NH, P, dtype=torch.float32, device=dev)
    state = torch.empty(B, NH, N, P, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(),
                                       *b.stride()[:2], *c.stride()[:2])
    backend.launch("ssd_scan_f32", NAME, dev, x.data_ptr(), dt.data_ptr(),
                   a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
                   d_skip.data_ptr(), y.data_ptr(), state.data_ptr(),
                   scratch.data_ptr(), B, S, NH, P, N, chunk, strides)
    return y, state
