"""Scenarios of the port's data-parallel trainer, run in every rank of a
gloo world on the CPU (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_plan.py``).

``tests/test_torch_samplers.py`` runs the samplers with row-sharded state
here too (``sampler_world``).  A world is spawned once per test module (``repro_torch.launch.mesh.spawn``:
one process a rank, a ``FileStore`` in a temporary directory, no network);
its ranks run every scenario of that module in the same order and each
returns its records, which the tests compare across ranks, world sizes and
against the JAX package.  Each rank runs PyTorch on one thread, so that a
chunk's forward and backward take the same bits in every process.  The
model is the reference's mesh test model (``tests/test_mesh_trainer.py``):
the CNN at image 8, widths (8,), hidden 16, N = 512, batch 64, 8 gradient
chunks.  This module imports no JAX: the ranks do not need it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (ForgetConfig, KakurenboConfig, LRSchedule,
                              make_strategy, planops)
from repro_torch.core.selection import select_hidden
from repro_torch.core.state import (RowLayout, gather_state,
                                    init_sample_state, scatter_observations)
from repro_torch.data import SyntheticClassification
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig

MODEL = cnn.CNNConfig(image_size=8, widths=(8,), hidden=16)
N, BATCH, CHUNKS = 512, 64, 8


def logits_fn(model, batch):
    return model(batch["images"])


def loss_fn(model, batch):
    loss, pa, pc = cnn.per_sample_metrics(logits_fn(model, batch),
                                          batch["labels"])
    w = batch.get("weight")
    scalar = (loss * w).mean() if w is not None else loss.mean()
    return scalar, (loss, pa, pc)


def make_trainer(world: int | None, epochs: int = 3,
                 selection: str = "histogram", compression: bool = False,
                 strategy: str = "kakurenbo", fused: bool = True,
                 checkpoint_dir: str | None = None, init=None, **tc_kw):
    """The reference's ``make_trainer`` on the port; ``world=None`` is the
    single-device trainer, ``init`` a state dict to start from."""
    ds = SyntheticClassification(num_samples=N, image_size=8, seed=0)
    kc = KakurenboConfig(selection=selection, max_fraction=0.3,
                         fraction_milestones=(0, 1, 2, 3))
    tc = TrainConfig(epochs=epochs, batch_size=BATCH, strategy=strategy,
                     kakurenbo=kc, lr=LRSchedule(0.05, "cosine", epochs, 1),
                     forget=ForgetConfig(fraction=0.3, warmup_epochs=2),
                     mesh_shape=(world,) if world else None,
                     grad_chunks=CHUNKS, grad_compression=compression,
                     fused_observe=fused, seed=0,
                     checkpoint_dir=checkpoint_dir,
                     checkpoint_every=1 if checkpoint_dir else 0, **tc_kw)
    model = cnn.CNN(MODEL, torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    return Trainer(tc, model, loss_fn, ds, None, logits_fn=logits_fn,
                   device="cpu")


def params(tr) -> list[np.ndarray]:
    return [p.detach().numpy().copy() for p in tr.model.parameters()]


def record_plans(tr) -> list:
    plans = []
    plan = tr.strategy.plan
    tr.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return plans


def records(plans, hist) -> list[dict]:
    return [{"hidden": np.sort(p.hidden_indices),
             "moveback": np.asarray(p.moveback_indices),
             "order": np.asarray(p.visible_indices).copy(),
             "loss": h.train_loss, "host_syncs": h.host_syncs,
             "engine": h.engine, "bwd": h.bwd_samples}
            for p, h in zip(plans, hist)]


def run(world, perms=None, **kw) -> dict:
    """A whole run: its per-epoch records and final parameters.  ``perms``
    replaces KAKURENBO's epoch permutations (the JAX trainer's)."""
    tr = make_trainer(world, **kw)
    if perms is not None:
        it = iter(torch.as_tensor(p) for p in perms)
        tr.strategy._inner.draw_permutation = lambda: next(it)
    plans = record_plans(tr)
    hist = tr.run()
    return {"recs": records(plans, hist), "params": params(tr)}


def restart(world, ckpt: str, epochs: int = 4, fail_at: int = 2,
            phase: str = "both", **kw) -> dict | None:
    """Crash before epoch ``fail_at`` with a checkpoint each epoch
    (``phase`` "crash" stops there), then restore into a trainer built from
    other weights and run to the end (``phase`` "resume" only restores,
    from the checkpoints in ``ckpt``)."""
    if phase in ("both", "crash"):
        tr = make_trainer(world, epochs=epochs, checkpoint_dir=ckpt, **kw)
        try:
            tr.run(fail_at_epoch=fail_at)
        except RuntimeError:
            pass
        if phase == "crash":
            return None
    other = {k: torch.zeros_like(v) for k, v in
             cnn.CNN(MODEL).state_dict().items()}
    tr2 = make_trainer(world, epochs=epochs, checkpoint_dir=ckpt, init=other,
                       **kw)
    assert tr2.restore_latest()
    resumed_at = tr2.epoch
    hist = tr2.run()
    return {"resumed_at": resumed_at, "loss": hist[-1].train_loss,
            "params": params(tr2)}


def straggler_worlds(world: int) -> tuple[int, int]:
    """The straggler monitor's world: the data-parallel degree by default,
    ``straggler_workers`` when set."""
    return (make_trainer(world, straggler_mitigation=True)._straggler.world_size,
            make_trainer(world, straggler_mitigation=True,
                         straggler_workers=3)._straggler.world_size)


def validation_messages(world: int) -> dict:
    """The reference's ``test_mesh_config_validation`` cases: each
    configuration's error message (None: it did not raise)."""
    ds = SyntheticClassification(num_samples=N, image_size=8, seed=0)
    out = {}
    cases = {"chunks": dict(mesh_shape=(world,), grad_chunks=world * 2 - 1,
                            batch_size=BATCH),
             "batch": dict(mesh_shape=(world,), grad_chunks=8, batch_size=60),
             "allreduce": dict(mesh_shape=(world,), grad_allreduce="mean"),
             "world": dict(mesh_shape=(world * 2,), grad_chunks=world * 2,
                           batch_size=BATCH)}
    for name, kw in cases.items():
        try:
            Trainer(TrainConfig(**kw), cnn.CNN(MODEL), loss_fn, ds,
                    device="cpu")
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = str(e)
    ctx = ParallelCtx(torch.distributed.group.WORLD)
    try:
        make_strategy("kakurenbo", N + 2, seed=0, ctx=ctx, device="cpu")
        out["rows"] = None
    except ValueError as e:
        out["rows"] = str(e)
    return out


def _setup(rank: int) -> None:
    torch.set_num_threads(1)


def trainer_world(rank: int, world: int, tasks: list) -> dict:
    """Every ``(name, function name, kwargs)`` task in order, in this rank;
    ``{name: result}``."""
    _setup(rank)
    out = {}
    for name, fn, kw in tasks:
        out[name] = globals()[fn](world, **kw)
    return out


# ---------------------------------------------------------------------------
# The plan's pieces (test_torch_mesh_plan.py)


def plan_world(rank: int, world: int, cases: list, fold_case=None) -> dict:
    """In each rank of a world: the cross-shard histogram masks of every
    case (through ``planops.histogram_masks`` under the group, gathered),
    the row helpers' round trip, ``gather_state``, the fused observe on
    this rank's rows, and (``fold_case``) one fold step's gradients."""
    _setup(rank)
    ctx = ParallelCtx(torch.distributed.group.WORLD)
    out = {"masks": [], "staged": [], "select": []}
    for loss, valid, low, high in cases:
        loss_l = ctx.shard_rows(torch.from_numpy(loss))
        valid_l = ctx.shard_rows(torch.from_numpy(valid))
        lo_mask, hi_mask = planops.histogram_masks(
            loss_l, valid_l, low, high, ctx=ctx)
        out["masks"].append((
            ctx.gather_rows(lo_mask).numpy(),
            None if hi_mask is None else ctx.gather_rows(hi_mask).numpy()))
        *_, hist, lo_hi, walk = planops.histogram_select_staged(
            loss_l, valid_l, low, high, use_kernel=True, ctx=ctx)
        out["staged"].append((hist.numpy(), lo_hi.numpy(), walk.numpy()))
        st = init_sample_state(len(loss), "cpu", rows=ctx.rows(len(loss)))
        st.loss.copy_(loss_l)
        st.pa.fill_(True)
        st.pc.fill_(1.0)
        st.seen.copy_(torch.where(valid_l, 0, -1))
        out["select"].append([
            ctx.gather_rows(select_hidden(st, low, method=m, ctx=ctx,
                                          drop_top_fraction=high)).numpy()
            for m in ("histogram", "histogram_pallas")])
    # shard_rows / gather_rows round trip, and gather_state.
    x = torch.arange(N * 3, dtype=torch.float32).reshape(N, 3)
    out["round_trip"] = bool(torch.equal(ctx.gather_rows(ctx.shard_rows(x)), x))
    st = _random_state(np.random.default_rng(5))
    local = {f: ctx.shard_rows(getattr(st, f)).clone()
             for f in ("loss", "pa", "pc", "hidden", "seen", "forget_events",
                       "prev_correct")}
    got = gather_state(type(st)(**local), ctx)
    out["gather_state"] = all(torch.equal(getattr(got, f), getattr(st, f))
                              for f in local)
    # The fused observe on this rank's rows, gathered, against the global
    # scatter (a repeated id, an invalid and a non-finite observation).
    rng = np.random.default_rng(6)
    idx = rng.integers(0, N, BATCH)
    idx[5] = idx[40]
    loss = torch.from_numpy(rng.exponential(size=BATCH).astype(np.float32))
    loss[7] = float("nan")
    pa = torch.from_numpy(rng.random(BATCH) < 0.5)
    pc = torch.from_numpy(rng.random(BATCH).astype(np.float32))
    valid = torch.from_numpy(rng.random(BATCH) < 0.8)
    start, stop = ctx.rows(N)
    for v in (None, valid):
        whole = _random_state(np.random.default_rng(7))
        mine = init_sample_state(N, "cpu", rows=(start, stop))
        for f in local:
            getattr(mine, f).copy_(getattr(whole, f)[start:stop])
        scatter_observations(whole, idx, loss, pa, pc, 3, valid=v)
        scatter_observations(mine, idx, loss, pa, pc, 3, valid=v,
                             offset=start)
        back = gather_state(mine, ctx)
        out.setdefault("scatter", []).append(
            all(_same_bits(getattr(back, f), getattr(whole, f))
                for f in local))
    out["layout"] = row_layout_checks(ctx, idx, loss, pa, pc, valid)
    if fold_case is not None:
        out["fold"] = fold_step(world, **fold_case)
    return out


def row_layout_checks(ctx, idx, loss, pa, pc, valid) -> list[bool]:
    """``RowLayout`` in a rank: its slice is ``ctx.rows``; ``load`` takes
    this rank's rows of a whole state (as a ``SampleState`` and as the dict
    of its fields a checkpoint restores) and of a mask; ``gather`` gives
    them back whole; its ``scatter`` leaves the rows as the global scatter
    does."""
    layout = RowLayout(N, ctx)
    whole = _random_state(np.random.default_rng(8))
    mask = torch.from_numpy(np.random.default_rng(9).random(N) < 0.5)
    fields = {f: getattr(whole, f) for f in whole.__dataclass_fields__}
    out = [(layout.start, layout.stop) == ctx.rows(N)]
    for src in (whole, fields):
        st = layout.init_state("cpu")
        own = torch.zeros(st.num_samples, dtype=torch.bool)
        layout.load({"state": st, "mask": own}, {"state": src, "mask": mask})
        back = layout.gather(st)
        out.append(all(_same_bits(getattr(back, f), v)
                       for f, v in fields.items())
                   and torch.equal(layout.gather(own), mask))
    layout.scatter(st, idx, loss, pa, pc, 3, valid=valid)
    scatter_observations(whole, idx, loss, pa, pc, 3, valid=valid)
    back = layout.gather(st)
    out.append(all(_same_bits(getattr(back, f), getattr(whole, f))
                   for f in fields))
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _random_state(rng):
    st = init_sample_state(N, "cpu")
    st.loss.copy_(torch.from_numpy(rng.exponential(size=N).astype(np.float32)))
    st.pa.copy_(torch.from_numpy(rng.random(N) < 0.5))
    st.pc.copy_(torch.from_numpy(rng.random(N).astype(np.float32)))
    st.hidden.copy_(torch.from_numpy(rng.random(N) < 0.2))
    st.seen.copy_(torch.from_numpy(rng.integers(-1, 3, N).astype(np.int32)))
    st.forget_events.copy_(torch.from_numpy(
        rng.integers(0, 3, N).astype(np.int32)))
    st.prev_correct.copy_(torch.from_numpy(rng.random(N) < 0.5))
    return st


def fold_step(world: int, init: dict, images: np.ndarray, labels: np.ndarray,
              weight: np.ndarray) -> dict:
    """One mesh step's reduced gradients and loss for a batch (the fold),
    from ``init``; SGD at LR 0 so nothing moves."""
    tr = make_trainer(world, init=init)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels),
             "weight": torch.from_numpy(weight)}
    idx = np.arange(BATCH)
    _, scalar, _, _ = tr.train_step(tr.strategy.get_device_state(),
                                    tr.local_rows(batch), idx,
                                    tr.epoch_dev, 0.0)
    return {"loss": float(scalar),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in tr.model.named_parameters()}}


# ---------------------------------------------------------------------------
# The samplers with row-sharded state (test_torch_samplers.py)

SAMPLER_N = 512


def drive_samplers(ctx, observations: list) -> dict:
    """``ISWRSampler``, ``ForgetSampler``, ``InfoBatchSampler`` and
    ``KakurenboSampler`` on ``ctx`` (None: one process), each from its own
    generator, over ``SAMPLER_N`` samples: per epoch ``begin_epoch`` then
    ``observe`` of that epoch's ``(indices, loss, pa, pc)``.  Each
    plan's host arrays (ISWR's unbiasing weights, FORGET's whole prune
    mask, InfoBatch's weights too) and the final ``state_summary``."""
    from repro_torch.core import (ForgetSampler, InfoBatchConfig,
                                  InfoBatchSampler, ISWRConfig, ISWRSampler,
                                  KakurenboSampler, state_summary)
    n, kw = SAMPLER_N, dict(seed=0, device="cpu", ctx=ctx)
    samplers = {
        "iswr": ISWRSampler(n, ISWRConfig(unbiased=True), **kw),
        "forget": ForgetSampler(n, ForgetConfig(0.3, 1), **kw),
        "infobatch": InfoBatchSampler(n, InfoBatchConfig(total_epochs=4),
                                      **kw),
        "kakurenbo": KakurenboSampler(n, KakurenboConfig(
            selection="histogram", drop_top_fraction=0.02), **kw)}
    out = {}
    for name, s in samplers.items():
        plans = []
        for epoch, (idx, loss, pa, pc) in enumerate(observations):
            plan = s.begin_epoch(epoch)
            if name == "iswr":
                plans.append((plan, s.sample_weights(plan)))
            elif name == "forget":
                plans.append((plan, s.rows.gather(s.pruned_mask).numpy(),
                              s.should_restart))
            elif name == "infobatch":
                plans.append((*plan, s.weights.copy()))
            else:
                plans.append((plan.visible_indices, plan.hidden_indices,
                              plan.moveback_indices))
            s.observe(idx, torch.from_numpy(loss), torch.from_numpy(pa),
                      torch.from_numpy(pc), epoch)
        out[name] = {"plans": plans, "summary": state_summary(s.state, ctx)}
    return out


def sampler_world(rank: int, world: int, observations: list) -> dict:
    """``drive_samplers`` on the world's data group, and whether a sampler
    of a count the group does not divide is refused (``rows``: the
    message)."""
    from repro_torch.core import ISWRSampler
    _setup(rank)
    ctx = ParallelCtx(torch.distributed.group.WORLD)
    out = drive_samplers(ctx, observations)
    try:
        ISWRSampler(SAMPLER_N + 1, device="cpu", ctx=ctx)
        out["rows"] = None
    except ValueError as e:
        out["rows"] = str(e)
    return out


def spawn_world(fn, world: int, *args) -> list:
    """``spawn`` a gloo world of ``world`` CPU ranks running ``fn``."""
    from repro_torch.launch.mesh import spawn
    return spawn(fn, world, "gloo", "cpu", args)
