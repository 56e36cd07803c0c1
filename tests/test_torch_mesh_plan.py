"""PyTorch port, the data-parallel plan's pieces against the JAX package.

- the cross-shard histogram selection (the staged path of
  ``planops.histogram_masks`` under a group: local range and histogram,
  reduced over the ranks, then the walks and this rank's masks) in gloo
  worlds of 1, 2, 4 and 8 CPU ranks, gathered, equals the JAX
  ``select_hidden(state, method="histogram")`` and ``histogram_masks`` on
  the whole state **exactly** (min, max and integer sums do not depend on
  the order of reduction), through the plain stages and through the
  staged kernels' wrappers (their plain versions on the CPU), with
  DropTop, invalid rows, non-finite losses, a rank with nothing valid and
  all-equal losses among the cases; its global histogram, range and walk
  equal ``histogram_select_plain``'s on the whole arrays;
- without a group the staged composition equals ``histogram_select_plain``
  bit for bit, and the staged kernel wrappers equal their plain stages;
- ``shard_rows``/``gather_rows`` round-trip and ``gather_state``
  reassembles a row-sharded ``SampleState``;
- ``scatter_observations`` on each rank's row slice (``offset=``), with a
  repeated id, a non-finite loss and the guard's mask, gathered, equals the
  global scatter;
- ``core.state.RowLayout``, the strategies' one view of the layout: its
  slice, a checkpoint's global arrays loaded into it and gathered back,
  and its scatter against the global one;
- one fold step's gradients and loss at world 1 against a chunk-by-chunk
  ``jax.value_and_grad`` fold of the reference's ``cnn.forward`` from the
  same parameters (``params_from_jax``), within 1e-6 relative a leaf, and
  the same bits at worlds 2, 4 and 8.

Each world is spawned once for the module (``tests/torch_mesh_scenarios.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import planops as jplanops
from repro.core import selection as jselection
from repro.core.state import SampleState as JSampleState
from repro.models import cnn as jcnn
from repro_torch.core import planops
from repro_torch.core.state import init_sample_state, scatter_observations
from repro_torch.data import SyntheticClassification
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.kernels import threshold_select as ts
from repro_torch.models import cnn

import torch_mesh_scenarios as sc

WORLDS = (1, 2, 4, 8)


def _cases():
    """(loss, valid, low fraction, DropTop fraction) over N = 512 rows."""
    rng = np.random.default_rng(0)
    n = sc.N
    exp = rng.exponential(size=n).astype(np.float32)
    nonfinite = exp.copy()
    nonfinite[[3, 100, 300]] = [np.nan, np.inf, -np.inf]
    first_half = np.zeros(n, bool)
    first_half[: n // 2] = rng.random(n // 2) < 0.9
    return [
        (exp, rng.random(n) < 0.7, 0.3, 0.02),
        (nonfinite, rng.random(n) < 0.8, 0.3, 0.0),
        (exp, np.zeros(n, bool), 0.3, 0.02),                 # nothing valid
        (np.full(n, 0.5, np.float32), np.ones(n, bool), 0.5, 0.05),
        (exp, first_half, 1.0, 0.02),                        # empty ranks
        (rng.normal(size=n).astype(np.float32), np.ones(n, bool), 0.0, 0.1),
    ]


def _fold_case():
    ds = SyntheticClassification(num_samples=sc.N, image_size=8, seed=0)
    batch = ds.get(np.arange(sc.BATCH))
    jcfg = jcnn.CNNConfig(image_size=8, widths=(8,), hidden=16)
    jparams = {k: np.array(v)
               for k, v in jcnn.init(jax.random.key(0), jcfg).items()}
    init = {k: v.numpy() for k, v in
            cnn.params_from_jax(jparams, sc.MODEL).items()}
    weight = np.random.default_rng(1).uniform(0.5, 2.0, sc.BATCH).astype(
        np.float32)
    return jcfg, jparams, dict(init=init, images=batch["images"],
                               labels=batch["labels"], weight=weight)


@pytest.fixture(scope="module")
def worlds():
    cases = _cases()
    _, _, fold = _fold_case()
    out = {}
    for world in WORLDS:
        ranks = sc.spawn_world(sc.plan_world, world, cases, fold)
        out[world] = ranks
    return out


def _jax_state(loss, valid):
    n = loss.shape[0]
    return JSampleState(
        loss=jnp.asarray(loss), pa=jnp.ones(n, bool),
        pc=jnp.ones(n, jnp.float32), hidden=jnp.zeros(n, bool),
        seen=jnp.where(jnp.asarray(valid), 0, -1).astype(jnp.int32),
        forget_events=jnp.zeros(n, jnp.int32),
        prev_correct=jnp.zeros(n, bool))


@pytest.mark.parametrize("world", WORLDS)
def test_cross_shard_histogram_equals_jax_exactly(worlds, world):
    for r in worlds[world]:
        for c, ((loss, valid, low, high), (lo_m, hi_m), sel) in enumerate(
                zip(_cases(), r["masks"], r["select"])):
            jlo, jhi = jplanops.histogram_masks(
                jnp.asarray(loss), jnp.asarray(valid), low, high)
            assert np.array_equal(lo_m, np.asarray(jlo)), (world, c)
            if high > 0:
                assert np.array_equal(hi_m, np.asarray(jhi)), (world, c)
            else:
                assert hi_m is None
            want = jselection.select_hidden(
                _jax_state(loss, valid), low, method="histogram",
                drop_top_fraction=high)
            for got in sel:
                assert np.array_equal(got, np.asarray(want)), (world, c)


@pytest.mark.parametrize("world", WORLDS)
def test_cross_shard_stages_equal_whole_plain(worlds, world):
    """The reduced histogram, range and walk are the single-device ones."""
    for c, ((loss, valid, low, high), (hist, lo_hi, walk)) in enumerate(
            zip(_cases(), worlds[world][0]["staged"])):
        _, _, whist, wlohi, wwalk = ts.histogram_select_plain(
            torch.from_numpy(loss), torch.from_numpy(valid), low, high)
        assert np.array_equal(hist, whist.numpy()), (world, c)
        assert np.array_equal(lo_hi, wlohi.numpy()), (world, c)
        assert np.array_equal(walk, wwalk.numpy()), (world, c)


@pytest.mark.parametrize("world", WORLDS)
def test_row_helpers_and_gather_state(worlds, world):
    for r in worlds[world]:
        assert r["round_trip"] and r["gather_state"]


@pytest.mark.parametrize("world", WORLDS)
def test_scatter_on_row_slices_equals_global(worlds, world):
    for r in worlds[world]:
        assert r["scatter"] == [True, True]


@pytest.mark.parametrize("world", WORLDS)
def test_row_layout_slice_checkpoint_and_scatter(worlds, world):
    for r in worlds[world]:
        assert r["layout"] == [True] * 4


def _jax_fold_grads(jcfg, jparams, case):
    """The reference's local_core fold at one device: chunk by chunk
    value_and_grad of the weighted mean CE, folded left to right, / C."""
    def loss_fn(params, images, labels, w):
        logits = jcnn.forward(params, jcfg, images)
        loss, _, _ = jcnn.per_sample_metrics(logits, labels)
        return jnp.mean(loss * w)

    rows = sc.BATCH // sc.CHUNKS
    vg = jax.value_and_grad(loss_fn)
    parts = [vg(jparams, case["images"][i * rows:(i + 1) * rows],
                case["labels"][i * rows:(i + 1) * rows],
                case["weight"][i * rows:(i + 1) * rows])
             for i in range(sc.CHUNKS)]
    acc_s, acc_g = parts[0]
    for s, g in parts[1:]:
        acc_s = acc_s + s
        acc_g = jax.tree.map(lambda a, b: a + b, acc_g, g)
    grads = {k: np.array(v / sc.CHUNKS) for k, v in acc_g.items()}
    return float(acc_s / sc.CHUNKS), cnn.params_from_jax(grads, sc.MODEL)


def test_fold_step_matches_jax_chunk_fold(worlds):
    jcfg, jparams, case = _fold_case()
    jloss, jgrads = _jax_fold_grads(jcfg, jparams, case)
    got = worlds[1][0]["fold"]
    assert got["loss"] == pytest.approx(jloss, rel=1e-6)
    assert got["grads"].keys() == jgrads.keys()
    for k, want in jgrads.items():
        want = want.numpy()
        err = np.abs(got["grads"][k] - want).max()
        assert err <= 1e-6 * np.abs(want).max(), (k, err)
    for world in WORLDS[1:]:
        for r in worlds[world]:
            assert r["fold"]["loss"] == got["loss"], world
            for k, g in got["grads"].items():
                assert np.array_equal(r["fold"]["grads"][k], g), (world, k)


@pytest.mark.parametrize("case", range(6))
def test_staged_composition_without_group_is_fused_plain(case):
    """``histogram_select_staged`` with no group, and the stage wrappers,
    give ``histogram_select_plain``'s bits."""
    loss, valid, low, high = _cases()[case]
    lt, vt = torch.from_numpy(loss), torch.from_numpy(valid)
    want = ts.histogram_select_plain(lt, vt, low, high)
    for use_kernel in (False, True):
        got = planops.histogram_select_staged(lt, vt, low, high,
                                              use_kernel=use_kernel,
                                              ctx=ParallelCtx())
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    lo_hi = ts.histogram_range(lt, vt)
    hist = ts.histogram_count(lt, vt, lo_hi)
    low_m, high_m, walk = ts.histogram_walk(lt, vt, hist, lo_hi, len(loss),
                                            low, high)
    assert torch.equal(lo_hi, want[3]) and torch.equal(hist, want[2])
    assert torch.equal(low_m, want[0]) and torch.equal(walk, want[4])


def test_scatter_offset_on_whole_state_is_unchanged():
    """At offset 0 over the whole state the slice path writes what the
    plain scatter writes (a world of one)."""
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 64, 32)
    loss = torch.from_numpy(rng.exponential(size=32).astype(np.float32))
    pa = torch.from_numpy(rng.random(32) < 0.5)
    pc = torch.from_numpy(rng.random(32).astype(np.float32))
    a, b = init_sample_state(64, "cpu"), init_sample_state(64, "cpu")
    for epoch in range(2):
        scatter_observations(a, idx, loss, pa, pc, epoch)
        scatter_observations(b, idx, loss, pa, pc, epoch, offset=0)
    for f in ("loss", "pa", "pc", "seen", "forget_events", "prev_correct"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
