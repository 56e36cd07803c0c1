"""PyTorch port, the histogram-select (B2 and B3 fused with the CDF walks).

The kernel (``csrc/threshold_select.cu``) runs only on the card, where
``chip_smoke.py`` holds its masks, histogram, range and walk against
``histogram_select_plain`` exactly.  Here, on the CPU:

- the plain version against the JAX package's ``planops.histogram_masks``
  (plain, and through its Pallas kernels in interpret mode) and its
  ``ops.loss_minmax``/``ops.loss_histogram``, on the same inputs made from
  a seed with numpy: masks, range and histogram exactly;
- a torch emulation of the kernel's block decomposition (contiguous slices,
  per-block range posts, summed per-block histograms, the walk repeated in
  every block, the masks per slice) against the plain version bit for bit;
- the count ``floor(f32(F) * f32(N))`` against the reference's around 2**24,
  where f32(N) rounds.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planops as jplan
from repro.kernels import ops as jops
from repro_torch.core import planops
from repro_torch.kernels import backend
from repro_torch.kernels import threshold_select as ts


def _inputs(n, invalid, kind, seed=0):
    r = np.random.default_rng(seed)
    loss = {"exp": lambda: r.exponential(1.0, n),
            "equal": lambda: np.full(n, 2.5),
            "zeros": lambda: np.where(r.random(n) < 0.5, -0.0, 0.0),
            "normal": lambda: r.normal(size=n) * 5,
            "naninf": lambda: np.select(
                [r.random(n) < 0.05, r.random(n) < 0.05, r.random(n) < 0.05],
                [np.nan, np.inf, -np.inf], r.exponential(1.0, n))}[kind]()
    loss = loss.astype(np.float32)
    if invalid == "single":
        return loss, np.arange(n) == n // 3
    return loss, r.random(n) >= invalid


# N not a multiple of the reference's 2,048-row blocks except "single"/"normal"
CASES = [(3000, 0.3, "exp"), (777, 0.0, "equal"), (600, 0.2, "zeros"),
         (500, 1.0, "exp"), (2048, "single", "exp"), (1000, 0.2, "naninf"),
         (2048, 0.0, "normal")]
CASE_IDS = [f"{n}-{inv}-{kind}" for n, inv, kind in CASES]


def _jax_masks(loss, valid, low, high, bins, use_kernel):
    lm, hm = jplan.histogram_masks(jnp.asarray(loss), jnp.asarray(valid),
                                   jnp.float32(low), high, bins=bins,
                                   use_kernel=use_kernel)
    return np.asarray(lm), None if hm is None else np.asarray(hm)


def _check_masks(got, want):
    low, high = got[:2]
    assert low.dtype == torch.bool
    assert np.array_equal(low.numpy(), want[0])
    if want[1] is None:
        assert high is None
    else:
        assert np.array_equal(high.numpy(), want[1])


@pytest.mark.parametrize("bins", [512, 64])
@pytest.mark.parametrize("high", [0.0, 0.02])
@pytest.mark.parametrize("low", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("n,invalid,kind", CASES, ids=CASE_IDS)
def test_histogram_select_plain_matches_reference(n, invalid, kind, low, high,
                                                  bins):
    loss, valid = _inputs(n, invalid, kind)
    got = ts.histogram_select_plain(torch.from_numpy(loss),
                                    torch.from_numpy(valid), low, high, bins)
    _check_masks(got, _jax_masks(loss, valid, low, high, bins, False))
    hist, walk = got[2], got[4]
    finite = valid & np.isfinite(loss)
    assert hist.dtype == torch.int32 and int(hist.sum()) == int(finite.sum())
    assert walk.dtype == torch.int64 and walk.shape == (6,)
    assert int(walk[0]) == int(np.floor(np.float32(low) * np.float32(n)))
    if high == 0.0:
        assert walk[3:].tolist() == [0, 0, 0]


@pytest.mark.parametrize("bins", [512, 64])
@pytest.mark.parametrize("n,invalid,kind", CASES, ids=CASE_IDS)
def test_histogram_select_plain_matches_pallas_path(n, invalid, kind, bins):
    """Against the reference's kernels B2/B3 in interpret mode: its masks
    through ``use_kernel=True``, its raw range and histogram."""
    loss, valid = _inputs(n, invalid, kind, seed=1)
    got = ts.histogram_select_plain(torch.from_numpy(loss),
                                    torch.from_numpy(valid), 0.3, 0.02, bins)
    _check_masks(got, _jax_masks(loss, valid, 0.3, 0.02, bins, True))
    jl, jv = jnp.asarray(loss), jnp.asarray(valid & np.isfinite(loss))
    lo, hi = jops.loss_minmax(jl, jv, interpret=True)
    assert got[3].tolist() == [float(lo), float(hi)]
    want = jops.loss_histogram(jl, jv, jnp.minimum(lo, hi), hi, bins,
                               interpret=True)
    assert np.array_equal(got[2].numpy(), np.asarray(want))


def _walk(cdf, hist, count, top):
    """One block's walk as the kernel does it: the first bin whose running
    count reaches ``count`` (none: bins - 1); from the top, rcdf[j] =
    total - cdf[bins - 2 - j]."""
    bins, total = len(hist), int(cdf[-1])
    run = (total - np.concatenate([cdf[-2::-1], [0]]) if top else cdf)
    reached = np.flatnonzero(run >= count)
    j = int(reached[0]) if len(reached) else bins - 1
    include = (count - (int(run[j - 1]) if j else 0)) * 2 >= hist[
        bins - 1 - j if top else j]
    return (bins - 1 - j if top else j), bool(include)


def _emulate_kernel(loss, valid, low, high, bins, blocks):
    """The kernel's decomposition: ``blocks`` contiguous slices of
    ceil(N / blocks) (the last ones may be empty), in torch on the CPU."""
    n = loss.shape[0]
    x = torch.where(valid & torch.isfinite(loss), loss, torch.nan)
    size = -(-n // blocks)
    slices = [x[i * size:(i + 1) * size] for i in range(blocks)]
    big = torch.tensor(ts.BIG)
    # 1-2. per-block posts (invalid as BIG and -BIG, empty as +-inf)
    posts = [(torch.where(s.isnan(), big, s).amin(),
              torch.where(s.isnan(), -big, s).amax()) if len(s)
             else (torch.tensor(torch.inf), torch.tensor(-torch.inf))
             for s in slices]
    lo = torch.stack([p[0] for p in posts]).amin()
    hi = torch.stack([p[1] for p in posts]).amax()
    lo_b = torch.minimum(lo, hi)
    # 3. per-block histograms, summed
    idx = [ts.bin_index(s, lo_b, hi, bins) for s in slices]
    hist = sum(np.bincount(i[~s.isnan()].numpy(), minlength=bins)
               for i, s in zip(idx, slices))
    cdf = np.cumsum(hist, dtype=np.int64)
    # 4. the walk, in every block
    num_hide = int(np.floor(np.float32(low) * np.float32(n)))
    num_top = int(np.floor(np.float32(high) * np.float32(n))) if high else 0
    walks = {(num_hide, *_walk(cdf, hist, num_hide, False),
              num_top, *(_walk(cdf, hist, num_top, True) if high else (0, 0)))
             for _ in range(blocks)}
    assert len(walks) == 1
    walk = next(iter(walks))
    _, b, inc, _, bt, inc_t = walk
    # 5. the masks per slice
    ok = [~s.isnan() for s in slices]
    low_m = torch.cat([(i <= b if inc else i < b) & o for i, o in zip(idx, ok)])
    high_m = (torch.cat([(i >= bt if inc_t else i > bt) & o
                         for i, o in zip(idx, ok)]) if high else None)
    return low_m, high_m, hist, torch.stack([lo, hi]), walk


@pytest.mark.parametrize("blocks", [1, 3, 132, "N"])
@pytest.mark.parametrize("n,invalid,kind", CASES, ids=CASE_IDS)
def test_block_decomposition_matches_plain(n, invalid, kind, blocks):
    loss, valid = _inputs(n, invalid, kind, seed=2)
    lt, vt = torch.from_numpy(loss), torch.from_numpy(valid)
    for low, high, bins in ((0.3, 0.02, 512), (1.0, 0.0, 64)):
        want = ts.histogram_select_plain(lt, vt, low, high, bins)
        got = _emulate_kernel(lt, vt, low, high, bins,
                              n if blocks == "N" else blocks)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if high:
            assert torch.equal(got[1], want[1])
        assert np.array_equal(got[2], want[2].numpy())
        assert torch.equal(got[3], want[3])          # == : signed zeros tie
        assert list(got[4]) == want[4].tolist()


@pytest.mark.parametrize("n", [50_000, 1_281_167, 2 ** 24 - 1, 2 ** 24,
                               2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 + 5])
@pytest.mark.parametrize("fraction", [0.3, 0.02, 1.0, 0.7])
def test_fraction_count_matches_reference(n, fraction):
    """``floor(f32(F) * f32(N))``: the reference's ``num_hide`` line (its
    N reaches it as a float32 psum), which rounds N above 2**24."""
    want = jnp.floor(jnp.asarray(fraction, jnp.float32)
                     * jnp.asarray(n, jnp.float32)).astype(jnp.int32)
    got = ts.fraction_count(fraction, n, torch.device("cpu"))
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want)
    dev_scalar = torch.tensor(fraction, dtype=torch.float32)
    assert int(ts.fraction_count(dev_scalar, n, torch.device("cpu"))) == int(want)


def test_histogram_masks_routes_through_histogram_select():
    loss, valid = _inputs(3000, 0.3, "exp", seed=3)
    lt, vt = torch.from_numpy(loss), torch.from_numpy(valid)
    f = torch.tensor(0.3)
    for high in (0.0, 0.02):
        a = planops.histogram_masks(lt, vt, f, high, use_kernel=True)
        b = planops.histogram_masks(lt, vt, f, high, use_kernel=False)
        c = ts.histogram_select(lt, vt, f, high)
        assert torch.equal(a[0], b[0]) and torch.equal(a[0], c[0])
        assert (a[1] is None) == (high == 0.0)
        if high:
            assert torch.equal(a[1], b[1]) and torch.equal(a[1], c[1])
    assert backend.LAUNCHES["histogram_select"] == 0


@pytest.mark.parametrize("f,want", [
    (0.3, (None, float(np.float32(0.3)))), (1, (None, 1.0)),
    (torch.tensor(0.3, dtype=torch.float64), (None, 0.3)),
    (torch.tensor([0.25]), (None, 0.25))])
def test_fraction_argument_by_value(f, want):
    ptr, value = ts._fraction_argument(f, torch.device("cpu"))
    assert ptr is None
    assert np.float32(value) == np.float32(want[1])


@pytest.mark.parametrize("f,err", [
    (torch.tensor([0.1, 0.2]), "one float"), (torch.tensor(1), "one float"),
    (torch.zeros((), device="meta"), "float32 on")])
def test_fraction_argument_refuses(f, err):
    with pytest.raises(ValueError, match=err):
        ts._fraction_argument(f, torch.device("cuda", 0))
