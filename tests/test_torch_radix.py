"""PyTorch port, radix rank-select: B4 and B5 in one kernel, and the masks
built on it.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds its mask,
its four pass histograms and its threshold triple against the plain
version there).  Here the plain versions — what the wrapper runs on a CPU
tensor — are held against the JAX package: the Pallas kernels in interpret
mode and their jnp twins, ``radix_threshold``, ``rank_select_mask``,
``topk_hide`` and ``sort_high_mask``, and the stable-argsort oracles; and a
torch emulation of the kernel's split into contiguous block slices is held
against the sequential plain version.  Every result is an integer or a
bool, so every comparison is exact.  N stays at or below 8192 because
interpret mode is slow.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planops as jplanops
from repro.kernels import threshold_select as jts
from repro_torch.core import planops
from repro_torch.kernels import backend
from repro_torch.kernels import ops as tops
from repro_torch.kernels import threshold_select as ts


def _scores(n, kind, seed=0):
    r = np.random.default_rng(seed)
    if kind == "exp":
        x = r.exponential(1.0, n)
    elif kind == "events":            # FORGET-like: small ints, never-correct +inf
        x = np.where(r.random(n) < 0.1, np.inf, r.integers(0, 3, n))
    elif kind == "zeros":             # signed zeros must tie
        x = np.where(r.random(n) < 0.5, -0.0, 0.0)
    elif kind == "inf":
        x = np.where(r.random(n) < 0.2, -np.inf,
                     np.where(r.random(n) < 0.2, np.inf, r.normal(size=n)))
    elif kind == "equal":
        x = np.full(n, 2.5)
    else:                             # ties: a coarse grid of values
        x = np.round(r.normal(size=n), 1)
    return x.astype(np.float32)


def _stable_rank(x):
    order = np.argsort(x, kind="stable")
    rank = np.empty(len(x), np.int64)
    rank[order] = np.arange(len(x))
    return rank


KINDS = ["exp", "events", "zeros", "inf", "equal", "ties"]


@pytest.mark.parametrize("kind", KINDS)
def test_float_order_keys_match_reference(kind):
    x = _scores(1000, kind)
    want = np.asarray(jts.float_order_keys(jnp.asarray(x))).astype(np.int64)
    got = ts.float_order_keys(torch.from_numpy(x))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    # the int32 bits the kernels read are the same uint32 values
    bits = ts.order_key_bits(torch.from_numpy(x)).numpy().view(np.uint32)
    assert np.array_equal(bits.astype(np.int64), want)
    assert np.array_equal(np.argsort(want, kind="stable"),
                          np.argsort(x, kind="stable"))


def _prefixes(keys):
    """(shift, prefix) pairs with matches: the prefix of a real key."""
    k = int(keys[len(keys) // 3])
    return [(s, k & ts._prefix_mask(s)) for s in ts.RADIX_SHIFTS] + [(8, 0)]


@pytest.mark.parametrize("kind", ["exp", "events", "zeros"])
def test_byte_histogram_plain_matches_pallas_kernel(kind):
    x = _scores(4096, kind, seed=1)
    keys_j = jts.float_order_keys(jnp.asarray(x))
    bits = ts.order_key_bits(torch.from_numpy(x))
    for shift, prefix in _prefixes(np.asarray(keys_j)):
        p = jnp.uint32(prefix)
        want = np.asarray(jts.byte_histogram_kernel(keys_j, p, shift,
                                                    interpret=True))
        twin = np.asarray(jts._byte_histogram_jnp(keys_j, p, shift))
        got = ts.byte_histogram_plain(bits, torch.tensor(prefix), shift)
        assert got.dtype == torch.int32 and got.shape == (256,)
        assert np.array_equal(got.numpy(), want), (shift, prefix)
        assert np.array_equal(want, twin)


@pytest.mark.parametrize("n", [4096, 1500, 777])
def test_byte_histogram_plain_matches_jnp_ragged(n):
    x = _scores(n, "ties", seed=n)
    keys_j = jts.float_order_keys(jnp.asarray(x))
    bits = ts.order_key_bits(torch.from_numpy(x))
    for shift, prefix in _prefixes(np.asarray(keys_j)):
        want = np.asarray(jts._byte_histogram_jnp(keys_j, jnp.uint32(prefix),
                                                  shift))
        got = ts.byte_histogram_plain(bits, torch.tensor(prefix), shift)
        assert np.array_equal(got.numpy(), want)
        assert int(got.sum()) == int(((np.asarray(keys_j).astype(np.int64)
                                       & ts._prefix_mask(shift)) == prefix).sum())


def _window_cases(keys, n):
    """(thresh, tie_lo, tie_hi) windows: a tied key, the first/last ties,
    an empty window, a threshold no key has."""
    k = np.asarray(keys).astype(np.int64)
    t = int(k[n // 2])
    ties = int((k == t).sum())
    return [(t, 0, ties), (t, 0, 1), (t, ties - 1, ties), (t, 0, 0),
            (t, ties // 3, ties // 3 + ties // 2), (0xFFFFFFFF, 0, 0)]


@pytest.mark.parametrize("kind", ["events", "equal", "ties"])
def test_select_mask_plain_matches_pallas_kernel(kind):
    n = 4096
    x = _scores(n, kind, seed=2)
    keys_j = jts.float_order_keys(jnp.asarray(x))
    bits = ts.order_key_bits(torch.from_numpy(x))
    for t, lo, hi in _window_cases(keys_j, n):
        want = np.asarray(jts.select_mask_kernel(
            keys_j, jnp.uint32(t), jnp.int32(lo), jnp.int32(hi),
            interpret=True)) != 0
        twin = np.asarray(jts._select_mask_jnp(keys_j, jnp.uint32(t), lo, hi))
        got = ts.select_mask_plain(bits, torch.tensor(t), torch.tensor(lo),
                                   torch.tensor(hi))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want), (t, lo, hi)
        assert np.array_equal(want, twin)


@pytest.mark.parametrize("n", [2049, 777, 8192])
def test_select_mask_plain_matches_jnp_ragged(n):
    x = _scores(n, "events", seed=n)
    keys_j = jts.float_order_keys(jnp.asarray(x))
    bits = ts.order_key_bits(torch.from_numpy(x))
    for t, lo, hi in _window_cases(keys_j, n):
        want = np.asarray(jts._select_mask_jnp(keys_j, jnp.uint32(t), lo, hi))
        got = ts.select_mask_plain(bits, torch.tensor(t), torch.tensor(lo),
                                   torch.tensor(hi))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_radix_threshold_matches_reference(kind):
    n = 3000
    x = _scores(n, kind, seed=3)
    keys_j = jts.float_order_keys(jnp.asarray(x))
    bits = ts.order_key_bits(torch.from_numpy(x))
    for k in (0, 1, n // 3, n - 1, n):
        want = jts.radix_threshold(keys_j, jnp.int32(k), jts._byte_histogram_jnp)
        got = ts.radix_threshold(bits, k, ts.byte_histogram_plain)
        assert [int(v) for v in got] == [int(v) for v in want], k


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [4096, 1000, 2049])
def test_rank_select_mask_matches_reference_and_oracle(kind, n):
    x = _scores(n, kind, seed=n + 7)
    rank = _stable_rank(x)
    for k in (0, 1, n // 3, n):
        for high in (False, True):
            want = np.asarray(jts.rank_select_mask(jnp.asarray(x), jnp.int32(k),
                                                   high=high))
            got = tops.rank_select(torch.from_numpy(x), k, high=high)
            oracle = rank >= n - k if high else rank < k
            assert got.dtype == torch.bool
            assert np.array_equal(got.numpy(), want), (k, high)
            assert np.array_equal(got.numpy(), oracle), (k, high)
            assert int(got.sum()) == k


@pytest.mark.parametrize("high", [False, True])
def test_rank_select_matches_padded_pallas_path(high):
    """The reference's kernel path pads N to its 2048 block with PAD_KEY;
    the port masks the ragged edge instead.  Same masks."""
    n = 3000
    x = _scores(n, "events", seed=4)
    for k in (1, 1000, n):
        want = np.asarray(jts.rank_select_mask(
            jnp.asarray(x), jnp.int32(k), high=high, use_kernel=True,
            interpret=True))
        got = ts.rank_select_mask(torch.from_numpy(x), torch.tensor(k),
                                  high=high)
        plain = ts.rank_select_mask(torch.from_numpy(x), k, high=high,
                                    use_kernel=False)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("kind", ["events", "ties", "zeros"])
def test_topk_hide_matches_reference_and_oracle(kind):
    n = 2500
    x = _scores(n, kind, seed=5)
    for k in (0, 1, 750, n):
        want = np.asarray(jplanops.topk_hide(jnp.asarray(x), jnp.int32(k)))
        got = planops.topk_hide(torch.from_numpy(x), torch.tensor(k))
        oracle = planops.stable_rank_order(torch.from_numpy(x)) < k
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), oracle.numpy())
    assert np.array_equal(
        planops.stable_rank_order(torch.from_numpy(x)).numpy(),
        np.asarray(jplanops.stable_rank_order(jnp.asarray(x))))


@pytest.mark.parametrize("n,fraction", [(2048, 0.02), (777, 0.1), (4096, 0.3),
                                        (1000, 1.0)])
def test_sort_high_mask_matches_reference_and_oracle(n, fraction):
    """Invalid samples, NaN and +/-inf never take a top slot; ties break
    toward the larger index, as a stable ascending argsort does."""
    r = np.random.default_rng(n)
    loss = np.round(r.exponential(1.0, n), 1).astype(np.float32)
    loss[r.random(n) < 0.05] = np.nan
    loss[r.random(n) < 0.05] = np.inf
    loss[r.random(n) < 0.05] = -0.0
    valid = r.random(n) >= 0.2
    want = np.asarray(jplanops.sort_high_mask(jnp.asarray(loss),
                                              jnp.asarray(valid), fraction))
    oracle = np.asarray(jplanops.sort_high_mask_argsort(
        jnp.asarray(loss), jnp.asarray(valid), fraction))
    lt, vt = torch.from_numpy(loss), torch.from_numpy(valid)
    got = planops.sort_high_mask(lt, vt, fraction)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), oracle)
    assert np.array_equal(planops.sort_high_mask_argsort(lt, vt, fraction).numpy(),
                          oracle)
    assert not (got.numpy() & ~(valid & np.isfinite(loss))).any()


def test_radix_wrappers_refuse_non_cpu_non_cuda_tensors():
    scores = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ts.rank_select(scores, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ts.rank_select_mask(scores, torch.tensor(3), high=True)
    with pytest.raises(ValueError, match="CUDA"):
        tops.rank_select(scores, 3)
    assert backend.LAUNCHES["rank_select"] == 0
    # the CPU takes the plain version, counted as no launch
    mask, hists, triple = ts.rank_select(torch.arange(8.0), 3)
    assert mask.tolist() == [True] * 3 + [False] * 5
    assert hists.shape == (4, 256) and hists.dtype == torch.int32
    assert triple.shape == (3,) and triple.dtype == torch.int64
    assert backend.LAUNCHES["rank_select"] == 0


@pytest.mark.parametrize("k,want", [
    (7, (0, 0, 7)), (np.int64(-2), (0, 0, -2)),
    (torch.tensor(5, dtype=torch.int32), (0, 0, 5)),
    (torch.tensor([9]), (0, 0, 9))])
def test_rank_select_k_by_value(k, want):
    """A number or a CPU tensor goes to the kernel by value; only a CUDA
    tensor is read on the device."""
    assert ts._k_argument(k, torch.device("cuda", 0)) == want


@pytest.mark.parametrize("k,err", [
    (2.5, TypeError), (torch.tensor(3.0), ValueError),
    (torch.tensor([1, 2]), ValueError), (2 ** 63, ValueError)])
def test_rank_select_refuses_bad_k(k, err):
    with pytest.raises(err):
        ts._k_argument(k, torch.device("cuda", 0))


def _reference_passes(x, k, high):
    """The reference's keys, its four pass histograms, the prefixes it
    took them at, and its ``(thresh, needed, total)``."""
    keys = jts.float_order_keys(jnp.asarray(x))
    if high:
        keys = ~keys
    hists, prefixes = [], []

    def hist_fn(ks, prefix, shift):
        prefixes.append(prefix)
        hists.append(np.asarray(jts._byte_histogram_jnp(ks, prefix, shift)))
        return hists[-1]

    triple = jts.radix_threshold(keys, jnp.int32(k), hist_fn)
    return keys, np.stack(hists), prefixes, [int(v) for v in triple]


def _mixed(n, seed):
    """Signed zeros, +/-inf and repeated finite values side by side."""
    r = np.random.default_rng(seed)
    pool = np.array([-0.0, 0.0, np.inf, -np.inf, 1.5, -1.5, 3.0], np.float32)
    x = pool[r.integers(0, len(pool), n)]
    spread = r.random(n) < 0.3
    x[spread] = r.normal(size=int(spread.sum()))
    return x


@pytest.mark.parametrize("kind", KINDS + ["mixed"])
def test_rank_select_plain_intermediates_match_reference(kind):
    n = 3000
    x = (_mixed(n, 8) if kind == "mixed" else _scores(n, kind, seed=8))
    rank = _stable_rank(x)
    for k in (0, 1, n // 3, n - 1, n):
        for high in (False, True):
            _, hists_j, _, triple_j = _reference_passes(x, k, high)
            mask, hists, triple = ts.rank_select_plain(torch.from_numpy(x), k,
                                                       high)
            assert hists.dtype == torch.int32 and hists.shape == (4, 256)
            assert np.array_equal(hists.numpy(), hists_j), (k, high)
            assert triple.dtype == torch.int64
            assert triple.tolist() == triple_j, (k, high)
            want = np.asarray(jts.rank_select_mask(jnp.asarray(x), jnp.int32(k),
                                                   high=high))
            oracle = rank >= n - k if high else rank < k
            assert np.array_equal(mask.numpy(), want), (k, high)
            assert np.array_equal(mask.numpy(), oracle), (k, high)
            assert int(hists[0].sum()) == n


@pytest.mark.parametrize("high", [False, True])
def test_rank_select_plain_hists_match_pallas_kernel(high):
    """The four pass histograms against the Pallas ``byte_histogram_kernel``
    in interpret mode, at the reference's own prefixes."""
    n = 4096
    x = _scores(n, "events", seed=9)
    k = n // 3
    keys_j, hists_j, prefixes, _ = _reference_passes(x, k, high)
    _, hists, _ = ts.rank_select_plain(torch.from_numpy(x), k, high)
    for p, (shift, prefix) in enumerate(zip(ts.RADIX_SHIFTS, prefixes)):
        want = np.asarray(jts.byte_histogram_kernel(keys_j, prefix, shift,
                                                    interpret=True))
        assert np.array_equal(hists[p].numpy(), want), shift
        assert np.array_equal(want, hists_j[p])


def _emulate_kernel(x, k, high, g):
    """The kernel's decomposition in torch: G contiguous slices of
    ceil(N / G) keys, per-slice byte histograms summed into the pass's
    histogram (the atomics), the same bucket search in every block, and
    per-slice tie counts summed into exclusive offsets for the ranks."""
    n = len(x)
    size = -(-n // g)
    keys = ts.float_order_keys(torch.from_numpy(x))
    if high:
        keys = keys ^ ts._U32
    block = torch.arange(n) // size
    prefix, remaining = 0, k
    hists = []
    for shift in ts.RADIX_SHIFTS:
        match = (keys & ts._prefix_mask(shift)) == prefix
        local = torch.zeros(g, 256, dtype=torch.int32)
        local.index_put_((block[match], (keys[match] >> shift) & 0xFF),
                         torch.ones(int(match.sum()), dtype=torch.int32),
                         accumulate=True)
        hist = local.sum(0, dtype=torch.int32)
        hists.append(hist)
        cdf = torch.cumsum(hist, 0, dtype=torch.int64)
        # the kernel's rule: the one bin whose running count first reaches
        # remaining (cdf never falls); 255 when none does
        reached = cdf >= remaining
        first = reached & torch.cat([torch.tensor([True]), ~reached[:-1]])
        b = int(first.nonzero()[0]) if bool(reached.any()) else 255
        below = int(cdf[b - 1]) if b else 0
        total = int(cdf[b]) - below
        remaining -= below
        prefix |= b << shift
    ties = local[:, b].to(torch.int64)              # pass 3's count at T
    offset = torch.cumsum(ties, 0) - ties
    tie = keys == prefix
    padded = torch.zeros(g * size, dtype=torch.int64)
    padded[:n] = tie.to(torch.int64)
    within = torch.cumsum(padded.view(g, size), 1).view(-1)[:n]
    cum = offset[block] + within
    lo, hi = (total - remaining, total) if high else (0, remaining)
    mask = (keys < prefix) | (tie & (cum > lo) & (cum <= hi))
    return mask, torch.stack(hists), [prefix, remaining, total]


@pytest.mark.parametrize("kind", ["events", "ties", "equal", "mixed"])
@pytest.mark.parametrize("blocks", [1, 3, 132, "N"])
def test_rank_select_block_decomposition_matches_sequential(kind, blocks):
    n = 2049
    x = _mixed(n, 10) if kind == "mixed" else _scores(n, kind, seed=10)
    g = n if blocks == "N" else blocks
    for k in (0, 1, n // 3, n - 1, n):
        for high in (False, True):
            mask, hists, triple = ts.rank_select_plain(torch.from_numpy(x), k,
                                                       high)
            e_mask, e_hists, e_triple = _emulate_kernel(x, k, high, g)
            assert torch.equal(e_hists, hists), (k, high)
            assert e_triple == triple.tolist(), (k, high)
            assert torch.equal(e_mask, mask), (k, high)
