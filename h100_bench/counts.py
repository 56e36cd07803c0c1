"""The yardstick's arithmetic: peaks of one H100 and the operations and
bytes of the port's kernels and of a training step.

A frozen copy of what ``chip_smoke.py`` counts (its ``bound()`` and the
counts inside ``check_loss_confidence``, ``check_loss_confidence_bwd``,
``check_ssd_scan`` and ``check_flash_attention``), with one peak under
every kernel: the card's dense TF32 rate, the fastest at which it
multiplies float32 operands, so that no float32-faithful implementation
of a kernel can read above 100% of it.
"""
from __future__ import annotations

#: HBM bandwidth of an H100 SXM (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
#: Dense TF32 tensor-core peak of an H100 SXM: the fastest float32-operand
#: multiply the card has; the denominator of every share below.
PEAK_OPS_PER_S = 495e12


def bound_s(nbytes: float, ops: float) -> float:
    """Least time (s) for the work: bytes at HBM rate or operations at the
    peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S)


# ---------------------------------------------------------------- B1

def b1_forward(t: int, v: int, elt: int = 4) -> tuple[float, float]:
    """(bytes, operations) of B1's forward over (T, V) logits: read the
    logits and labels once, write ce, pmax (f32) and correct (1 B); five
    operations an element (max, subtract, exp, add, compare)."""
    return t * v * elt + t * 4 + t * 9, 5.0 * t * v


def b1_backward(t: int, v: int, elt: int = 4) -> tuple[float, float]:
    """(bytes, operations) of B1's backward: read the logits, write their
    gradient, and 16 B a row (label, ce, g, gold)."""
    return 2 * t * v * elt + 16 * t, 5.0 * t * v


# ---------------------------------------------------------------- B6

def ssd_chunked_ops(b: int, s: int, nh: int, p: int, n: int,
                    chunk: int) -> int:
    """The chunked SSD's products over the chunk lengths of ``s``: only the
    causal half of C.B^T and scores.X, C.B^T once per (batch, chunk)."""
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    return b * sum(ln * (ln + 1) * n
                   + nh * (ln * (ln + 1) * p + 4 * ln * n * p) for ln in lens)


def b6(b: int, s: int, nh: int, p: int, n: int,
       chunk: int) -> tuple[float, float]:
    """(bytes, operations) of one B6 call: x and y, dt, B and C, A and D,
    and the final state, in float32; the fewer of the chunked form's and
    the per-token recurrence's (5 N P a token and head) operations."""
    ops = min(ssd_chunked_ops(b, s, nh, p, n, chunk), b * nh * s * 5 * n * p)
    nbytes = 4 * (2 * b * s * nh * p + b * s * nh + 2 * b * s * n + 2 * nh
                  + b * nh * n * p)
    return nbytes, ops


# ---------------------------------------------------------------- B7

def attention_ops(b: int, s: int, hq: int, d: int, causal: bool) -> int:
    """The two products of attention (scores and P.V), 2 operations a
    multiply-add, over the (query, key) pairs visited: the causal half
    where causal."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * hq * d * pairs


def b7(b: int, s: int, hq: int, hkv: int, d: int, causal: bool = True,
       elt: int = 4) -> tuple[float, float]:
    """(bytes, operations) of one B7 call: q and the output, k and v."""
    nbytes = elt * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    return nbytes, attention_ops(b, s, hq, d, causal)


# ---------------------------------------------------------------- step

def matmul_params(arch: dict) -> int:
    """Parameters that enter a matrix product a token: the projections of
    every layer and the output head (the embedding lookup is not one, and
    with tied embeddings its matrix is counted once, as the head)."""
    d, layers = arch["d_model"], arch["num_layers"]
    per_layer = 0
    if arch["num_heads"]:
        hd = arch["head_dim"]
        per_layer += d * hd * (2 * arch["num_heads"] + 2 * arch["num_kv_heads"])
    if arch["d_ff"]:
        per_layer += 3 * d * arch["d_ff"]
    ssm = arch.get("ssm")
    if ssm:
        di = ssm["expand"] * d
        nh = di // ssm["head_dim"]
        per_layer += d * (2 * di + 2 * ssm["state_dim"] + nh) + di * d
    return layers * per_layer + d * arch["vocab_size"]


def step_flops(arch: dict, batch: int, seq: int) -> float:
    """Model operations of one training step, recomputation not counted:
    6 a matmul parameter and token, plus the sequence mixer's products
    (causal attention, or the SSD scan's fewer form) three times (forward,
    and the backward's two)."""
    tokens = batch * seq
    mixer = 0
    if arch["num_heads"]:
        mixer = attention_ops(batch, seq, arch["num_heads"], arch["head_dim"],
                              True)
    ssm = arch.get("ssm")
    if ssm:
        di = ssm["expand"] * arch["d_model"]
        mixer += b6(batch, seq, di // ssm["head_dim"], ssm["head_dim"],
                    ssm["state_dim"], ssm["chunk"])[1]
    return 6.0 * matmul_params(arch) * tokens + 3.0 * arch["num_layers"] * mixer
