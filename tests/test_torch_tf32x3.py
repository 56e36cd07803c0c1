"""The error budget of 3xTF32 products, held on the CPU.

Kernels B6 (SSD scan) and B7 (flash attention) run their float32 products
on the tensor cores as three TF32 products: each operand is split as
a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a - a_hi), and
a_hi b_hi + a_hi b_lo + a_lo b_hi is summed in float32 (the dropped
a_lo b_lo is ~2^-22 of the product).  Two splits are held: "rne", both
halves rounded to nearest even, and "kernel", the kernels' own
(``csrc/mma_tf32.cuh``): a_hi rounded to nearest with ties away from zero
by an integer add on the bits, a_lo = a - a_hi read by the tensor core with
its 13 low bits dropped.

TF32 keeps 10 stored mantissa bits, so a product of two TF32 values is
exact in float32: a float32 matmul of TF32-rounded operands on the CPU
computes what the tensor cores compute, up to the order of the float32
sums.

Here the two kernels' decompositions run with every product through
``matmul_3xtf32`` and are held, within the kernels' own tolerances, against
the plain float32 versions the card checks them against:

- the SSD scan in the kernel's form (C.B^T once per chunk and shared by
  every head, the chunk states, the carried state, y), on
  ``tests/test_kernels.py``'s decays and on mamba2's init decays, within
  ``SSD_TOL = 1e-4`` of ``ssd_scan_plain``;
- causal GQA attention, both products through it, within 1e-5 of
  ``flash_attention_plain``.

The same computations with one-pass TF32 products miss those tolerances:
that is why the kernels take three passes.

The float32 sums inside the tensor core truncate.  Emulated here as a
round toward zero of each MMA's exact sum, a chain of k-steps on one
accumulator drifts several times further from the exact product than a
float32 matmul does; the kernels' two remedies, a fresh accumulator each
k-step added on the CUDA cores (B6's C.B^T, B7's P.V per key tile) and
the small passes on an accumulator of their own (B6's other products),
bring it back near float32 rounding.  This is evidence for the numeric
design, not the kernels, which run only on the card.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tssd

SSD_TOL = 1e-4
ATTN_TOL = 1e-5


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (round to nearest, ties to even, on
    the 13 low mantissa bits), returned as float32 with those bits zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    keep = (bits >> 13) & 1
    bits = ((bits + 0xFFF + keep) >> 13) << 13
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(bits: torch.Tensor) -> torch.Tensor:
    bits = bits & 0xFFFFFFFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_round_away(x: torch.Tensor) -> torch.Tensor:
    """The kernels' a_hi: (bits + 0x1000) & ~0x1FFF, to nearest with ties
    away from zero."""
    return _from_bits((_bits(x) + 0x1000) & ~0x1FFF)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """A float32 read as TF32 by the tensor core: 13 low bits dropped."""
    return _from_bits(_bits(x) & ~0x1FFF)


def split_tf32(x: torch.Tensor, split: str = "rne"):
    if split == "rne":
        hi = tf32_round(x)
        return hi, tf32_round(x - hi)
    hi = tf32_round_away(x)
    return hi, tf32_trunc(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor,
                  split: str = "rne") -> torch.Tensor:
    """a @ b in float32 from three TF32 products, small terms first."""
    a_hi, a_lo = split_tf32(a.float(), split)
    b_hi, b_lo = split_tf32(b.float(), split)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def matmul_3xtf32_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return matmul_3xtf32(a, b, "kernel")


MM_3X = {"rne": matmul_3xtf32, "kernel": matmul_3xtf32_kernel}


def matmul_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 product (what plain TF32 gives)."""
    return tf32_round(a.float()) @ tf32_round(b.float())


def test_tf32_round_is_round_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's ulp at 1
    x = torch.tensor([one, one + ulp / 2, one + 1.5 * ulp, one + ulp / 4,
                      one + 0.75 * ulp, -(one + ulp / 2), 3.0e-39, 0.0, -0.0],
                     dtype=torch.float32)
    want = [one, one, one + 2 * ulp, one, one + ulp, -one]
    got = tf32_round(x)
    assert got[:6].tolist() == want
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    hi, lo = split_tf32(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(hi + lo) - float(np.float32(np.pi))) <= 2.0 ** -21 * 4
    away = tf32_round_away(x)
    assert away[:6].tolist() == [one, one + ulp, one + 2 * ulp, one,
                                 one + ulp, -(one + ulp)]
    assert tf32_trunc(x)[:6].tolist() == [one, one, one + ulp, one, one, -one]


def ssd_kernel_form(x, dt, a_log, b, c, d_skip, chunk: int, mm):
    """The SSD scan as kernel B6 decomposes it, every product through
    ``mm``: dt and the sequential cumsum per (batch, chunk, head); C.B^T
    once per (batch, chunk); the chunk states; the carried state; y."""
    B, S, NH, P = x.shape
    N = b.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    x = F.pad(x, (0, 0, 0, 0, 0, pad))
    b = F.pad(b, (0, 0, 0, pad))
    c = F.pad(c, (0, 0, 0, pad))
    dt = F.pad(F.softplus(dt), (0, 0, 0, pad))          # 0 past S
    a = -torch.exp(a_log)
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    y = torch.zeros(B, nc * chunk, NH, P)
    h = torch.zeros(B, NH, N, P)
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        cb = mm(c[:, sl], b[:, sl].transpose(1, 2))      # (B, l, l), shared
        states = []
        for hh in range(NH):
            dth = dt[:, sl, hh]                          # (B, l)
            cum = torch.cumsum(dth * a[hh], dim=1)       # sequential on CPU
            seg = cum[:, -1:]
            diff = cum[:, :, None] - cum[:, None, :]
            decay = torch.exp(diff.masked_fill(~tri, -1e30))
            scores = cb * decay * dth[:, None, :]
            xh = x[:, sl, hh]                            # (B, l, P)
            inter = mm(c[:, sl], h[:, hh]) * torch.exp(cum)[:, :, None]
            y[:, sl, hh] = (mm(scores, xh) + inter
                            + d_skip[hh] * xh)
            w = torch.exp(seg - cum) * dth               # (B, l)
            states.append(mm(b[:, sl].transpose(1, 2), w[:, :, None] * xh))
        h = h * torch.exp(torch.stack(
            [torch.cumsum(dt[:, sl, hh] * a[hh], 1)[:, -1]
             for hh in range(NH)], 1))[:, :, None, None] + torch.stack(states, 1)
    return y[:, :S], h


def _ssd_inputs(b, s, nh, p, n, decays: str, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(b, s, nh, p))
    dt = r.normal(size=(b, s, nh))
    if decays == "test_kernels":           # tests/test_kernels.py's draws
        a_log = r.uniform(0, 1, (nh,))
    else:                                  # mamba2's init: a in [-16, -1]
        a_log = np.log(r.uniform(1.0, 16.0, (nh,)))
    bm, cm = r.normal(size=(b, s, n)), r.normal(size=(b, s, n))
    dsk = r.normal(size=(nh,))
    return tuple(torch.tensor(v, dtype=torch.float32)
                 for v in (x, dt, a_log, bm, cm, dsk))


SSD_CASES = [
    ("test_kernels", (1, 256, 2, 64, 128, 128)),   # mamba2's N, P, chunk
    ("mamba2_init", (1, 256, 2, 64, 128, 128)),
    ("test_kernels", (2, 100, 2, 16, 8, 32)),      # ragged last chunk
]


def _ssd_err(mm, decays, shape):
    b, s, nh, p, n, chunk = shape
    args = _ssd_inputs(b, s, nh, p, n, decays)
    y_p, h_p = tssd.ssd_scan_plain(*args, chunk)
    y, h = ssd_kernel_form(*args, chunk, mm)
    return y, h, y_p, h_p


@pytest.mark.parametrize("split", ["rne", "kernel"])
@pytest.mark.parametrize("decays,shape", SSD_CASES)
def test_ssd_kernel_form_3xtf32_within_ssd_tol(decays, shape, split):
    y, h, y_p, h_p = _ssd_err(MM_3X[split], decays, shape)
    torch.testing.assert_close(y, y_p, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(h, h_p, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("decays,shape", SSD_CASES[:2])
def test_ssd_kernel_form_1xtf32_misses_ssd_tol(decays, shape):
    y, h, y_p, h_p = _ssd_err(matmul_1xtf32, decays, shape)
    assert not (torch.allclose(y, y_p, rtol=SSD_TOL, atol=SSD_TOL)
                and torch.allclose(h, h_p, rtol=SSD_TOL, atol=SSD_TOL))


def attention_kernel_form(q, k, v, causal: bool, mm):
    """Attention with both products through ``mm``: scores scaled after
    the product, -1e30 above the diagonal, float32 softmax."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    out = torch.empty_like(q)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    for bb in range(b):
        for h in range(hq):
            hk = h // (hq // hkv)
            sc = mm(q[bb, :, h], k[bb, :, hk].T) * d ** -0.5
            if causal:
                sc = sc.masked_fill(~mask, -1e30)
            out[bb, :, h] = mm(torch.softmax(sc, dim=-1), v[bb, :, hk])
    return out


def _qkv(b, s, hq, hkv, d, seed=0):
    r = np.random.default_rng(seed)
    return tuple(torch.tensor(r.normal(size=(b, s, h, d)), dtype=torch.float32)
                 for h in (hq, hkv, hkv))


ATTN_CASES = [(1, 192, 6, 2, 64, True), (1, 128, 2, 1, 128, True),
              (2, 64, 4, 2, 32, False)]


@pytest.mark.parametrize("split", ["rne", "kernel"])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal", ATTN_CASES)
def test_attention_3xtf32_within_1e5(b, s, hq, hkv, d, causal, split):
    q, k, v = _qkv(b, s, hq, hkv, d)
    want = tfa.flash_attention_plain(q, k, v, causal)
    got = attention_kernel_form(q, k, v, causal, MM_3X[split])
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_attention_1xtf32_misses_1e5():
    q, k, v = _qkv(*ATTN_CASES[0][:5])
    want = tfa.flash_attention_plain(q, k, v, True)
    got = attention_kernel_form(q, k, v, True, matmul_1xtf32)
    assert not torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)


def rz_float32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    r = x.to(torch.float32)
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def test_rz_float32_rounds_toward_zero():
    ulp = 2.0 ** -23
    x = torch.tensor([1 + 0.75 * ulp, -(1 + 0.75 * ulp), 1 + 0.25 * ulp, 3.0],
                     dtype=torch.float64)
    assert rz_float32(x).tolist() == [1.0, -1.0, 1.0, 3.0]


def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One MMA k-step as the tensor core sums it: TF32 products (exact),
    added to the accumulator, the sum truncated to float32."""
    return rz_float32(acc.double() + a.double() @ b.double())


def matmul_tensor_core(a: torch.Tensor, b: torch.Tensor,
                       accumulate: str) -> torch.Tensor:
    """a @ b in 3xTF32 (the kernels' split) over k-steps of 8, summed by
    ``_mma``.  ``chain``: all three passes of every k-step on one
    accumulator; ``fold``: each k-step from zero, added in float32 (round
    to nearest); ``split``: a_lo b_hi and a_hi b_lo on an accumulator of
    their own, added to the a_hi b_hi chain at the end."""
    a_hi, a_lo = split_tf32(a, "kernel")
    b_hi, b_lo = split_tf32(b, "kernel")
    acc = torch.zeros(a.shape[0], b.shape[1])
    small = torch.zeros_like(acc)
    for k in range(0, a.shape[1], 8):
        ks = slice(k, k + 8)
        if accumulate == "chain":
            acc = _mma(acc, a_lo[:, ks], b_hi[ks])
            acc = _mma(acc, a_hi[:, ks], b_lo[ks])
            acc = _mma(acc, a_hi[:, ks], b_hi[ks])
        elif accumulate == "fold":
            part = _mma(torch.zeros_like(acc), a_lo[:, ks], b_hi[ks])
            part = _mma(part, a_hi[:, ks], b_lo[ks])
            acc = acc + _mma(part, a_hi[:, ks], b_hi[ks])
        else:
            small = _mma(small, a_lo[:, ks], b_hi[ks])
            small = _mma(small, a_hi[:, ks], b_lo[ks])
            acc = _mma(acc, a_hi[:, ks], b_hi[ks])
    return acc + small


@pytest.mark.parametrize("k", [128, 64])      # B6's N and chunk; B7's D
@pytest.mark.parametrize("seed", [0, 1])
def test_truncating_sums_chain_drifts_fold_and_split_do_not(k, seed):
    r = np.random.default_rng(seed)
    a = torch.tensor(r.normal(size=(128, k)), dtype=torch.float32)
    b = torch.tensor(r.normal(size=(k, 128)), dtype=torch.float32)
    exact = a.double() @ b.double()

    def err(m):
        return float((m.double() - exact).abs().mean())
    f32 = err(a @ b)
    chain, fold, split = (err(matmul_tensor_core(a, b, m))
                          for m in ("chain", "fold", "split"))
    assert chain > 3 * f32
    assert fold < f32
    assert split < chain / 2 and split < 3 * f32
