"""The yardstick's counters against hand counts at small shapes, and a
roofline share read from made-up device activities."""
import pytest

from h100_bench import counts, readers, trace
from h100_bench.tests.tiny import tiny


def test_b1_counts():
    # 2 rows of 3 logits: 24 B of logits, 8 of labels, 9 a row written.
    assert counts.b1_forward(2, 3) == (24 + 8 + 18, 30.0)
    assert counts.b1_backward(2, 3) == (48 + 32, 30.0)


def test_b6_counts_take_the_fewer_form():
    # S 4 in two chunks of 2, one head, N = P = 1: each chunk 2*3*1 for
    # C.B^T and 2*3*1 + 4*2 for the head, 20 a chunk; the recurrence 5 a
    # token: 20.  A chunk of 1 makes the chunked form cheaper than that.
    assert counts.ssd_chunked_ops(1, 4, 1, 1, 1, 2) == 40
    nbytes, ops = counts.b6(1, 4, 1, 1, 1, 2)
    assert ops == 20
    assert nbytes == 4 * (2 * 4 + 4 + 2 * 4 + 2 + 1)
    assert counts.ssd_chunked_ops(1, 4, 1, 1, 1, 1) == 4 * (2 + 2 + 4)
    assert counts.b6(1, 4, 1, 1, 1, 1)[1] == 20


def test_b7_counts():
    # 3 positions causal: 6 pairs, 2 products of 2 ops, head dim 2.
    assert counts.attention_ops(1, 3, 1, 2, True) == 4 * 2 * 6
    assert counts.attention_ops(1, 3, 1, 2, False) == 4 * 2 * 9
    assert counts.b7(1, 3, 2, 1, 2)[0] == 4 * (2 * 3 * 2 * 2 + 2 * 3 * 2)


def test_step_flops_dense():
    arch = {"d_model": 4, "num_layers": 1, "num_heads": 2, "num_kv_heads": 1,
            "head_dim": 2, "d_ff": 8, "vocab_size": 10, "ssm": None}
    # q 4x4, k and v 4x2 each, o 4x4: 48; MLP 3*4*8 = 96; head 40.
    assert counts.matmul_params(arch) == 48 + 96 + 40
    flops = counts.step_flops(arch, batch=2, seq=3)
    assert flops == 6 * 184 * 6 + 3 * counts.attention_ops(2, 3, 2, 2, True)


def test_step_flops_ssm():
    arch = {"d_model": 4, "num_layers": 2, "num_heads": 0, "num_kv_heads": 0,
            "head_dim": None, "d_ff": 0, "vocab_size": 10,
            "ssm": {"state_dim": 2, "head_dim": 4, "expand": 2,
                    "conv_width": 4, "chunk": 2}}
    # d_inner 8, 2 heads: w_in 4 x (16 + 4 + 2), w_out 8 x 4; head 40.
    assert counts.matmul_params(arch) == 2 * (4 * 22 + 32) + 40


def test_roofline_share_from_activities():
    cell = tiny("qwen3-1.7b-l7.kakurenbo")
    s, a = cell.shape, cell.arch
    least = counts.bound_s(*counts.b7(s["batch"], s["seq_len"], a["num_heads"],
                                      a["num_kv_heads"], a["head_dim"]))
    acts = [trace.Activity("void flash_attention_kernel<float, 16>(float*)",
                           0.0, 2e6 * least),
            trace.Activity("void flash_attention_kernel<float, 16>(float*)",
                           10.0, 10.0 + 2e6 * least),
            trace.Activity("ampere_sgemm_128x64_nn", 50.0, 90.0)]
    ctx = readers.Context(cell, {}, {}, [], acts, 1.0, 0.5)
    assert readers.roofline(ctx, "b7") == pytest.approx(50.0)
    assert readers.roofline(ctx, "b6") is None


def test_busy_and_gaps():
    acts = [trace.Activity("k1", 0.0, 10.0), trace.Activity("k2", 5.0, 20.0),
            trace.Activity("k3", 40.0, 50.0)]
    assert trace.busy_s(acts) == pytest.approx(30e-6)
    hosts = [trace.Activity("bench.refresh", 15.0, 45.0)]
    gaps = trace.idle_gaps(acts, hosts, 0.0, 60.0)
    assert gaps[0] == ["bench.refresh", pytest.approx(20e-6)]
    assert gaps[1][1] == pytest.approx(10e-6)
