"""Epoch engines: how a planned epoch's batches become train steps.

Port of ``repro/train/engines.py``.  Both engines call the same
``Trainer.train_step`` with the same device scalars (the epoch and the
LR), so they run the same kernels and give the same bits:

- ``HostLoopEngine`` — one train step per batch, batches assembled on the
  host by the ``Pipeline`` and copied to the device each step with the
  strategy's per-sample weights.  Per-step loss scalars and backward counts
  stay on the device and cross to the host once, at epoch end.  The only
  engine that runs per-batch host hooks: with ``fused_observe=False`` it
  calls ``strategy.observe`` after every batch (the legacy host-observe
  path, one sync a batch, counted in ``host_syncs``), filtering the
  non-finite observations out on the host under the numeric guard.

- ``ScanEpochEngine`` — the device-resident epoch, PyTorch's counterpart of
  the reference's unrolled ``lax.scan`` blocks.  The dataset is placed on
  the device once (``Trainer.device_data``); every epoch's batch layout
  crosses as one ``(num_steps, B)`` index plan (and the pre-gathered
  weights as one ``(num_steps, B)`` array), and ``ScanEpochEngine.step``
  gathers each batch on the device.  ``scan_steps`` consecutive steps form
  a block; on a CUDA device each block length is captured once as a
  ``torch.cuda.CUDAGraph`` of ``size`` unrolled steps, and an epoch is a
  few replays with device-to-device copies of the plan's rows into the
  graphs' static buffers between them.  On the CPU (the tests) the same
  block runs eagerly.  The per-step losses and backward counts cross to
  the host once an epoch.

A graph holds the addresses of what it touches: the parameters, the
optimizer's state, the gradient compression's residual, the strategy's
``step_tensors``, the numeric guard's counters, the LR and epoch scalars,
the device data and the static buffers.  Everything that changes
them does so in place (the optimizer's update, the strategy's hooks, the
FORGET restart, ``set_device_state``, checkpoint restore); the engine
checks the addresses before every replay and raises if one moved.  A step
draws no numbers from a ``torch.Generator``, whose state a graph would
hold: the in-step draws (SB's) are counter-based, their counter part of the
strategy's state.  A failed capture or replay
raises: a CUDA device never falls back to eager steps.

Both engines honour the reference's crash contract: the train state is
updated in place, so after an exception between steps (host loop) or
between replays (scanned) it is the last completed step's or block's, and
``state_dict`` works (checkpoint on fault).  An error inside a replay is
not recoverable, as in the reference.

Under a data-parallel group (``TrainConfig.mesh_shape``) each rank takes
its rows of every batch: the host loop slices the host batch, the scanned
engine gathers its columns of the plan's rows (the ``(num_steps, B)`` plan
is the same on every rank).  Under NCCL the step's collectives are stream
work and the graphs capture them (one eager collective before the first
capture makes the communicator); gloo's run on the host, so the trainer
gives a gloo group on CUDA the host loop (``Trainer._make_engine``).  On the
CPU the scanned engine runs its blocks eagerly under gloo, as without a
group.

Kernel launches under replay: ``backend.launch`` counts on the host, and a
replay calls no wrapper.  So a capture takes back the counts its wrappers
added (a capture launches nothing) and keeps them as the graph's own, and
every replay adds them again: ``backend.LAUNCHES`` counts the kernels that
ran on the device.
"""
from __future__ import annotations

import collections
import dataclasses
import gc

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core.strategy import SampleStrategy
from repro_torch.data.pipeline import epoch_index_plan
from repro_torch.kernels import backend
from repro_torch.train import guard


@dataclasses.dataclass
class EpochRunResult:
    """What an engine hands back to ``Trainer.run_epoch``."""

    losses: np.ndarray        # (num_steps,) f64 per-step loss scalars
    fwd_samples: int
    bwd_samples: int
    host_syncs: int = 0       # SampleState round trips spent in the loop
    # The numeric guard's counters (train/guard.py): cumulative run totals,
    # fetched with the losses (no extra sync); 0 with the guard off.  The
    # trainer diffs them into per-epoch stats.
    nonfinite_steps: int = 0
    quarantined: int = 0
    guard_consecutive: int = 0


def _fetch_tail(tr) -> list[torch.Tensor]:
    """The guard's counters as float64, to ride the epoch's one fetch."""
    if tr.guard_state is None:
        return []
    return [torch.stack(tr.guard_state.tensors()).to(torch.float64)]


def _guard_totals(tr, tail: np.ndarray) -> dict:
    """``EpochRunResult``'s guard fields from the fetched counters."""
    if tr.guard_state is None:
        return {}
    nf, consec, q = (int(x) for x in tail)
    return {"nonfinite_steps": nf, "guard_consecutive": consec,
            "quarantined": q + tr._guard_host_q}


class HostLoopEngine:
    """Per-batch dispatch with host-side batch assembly."""

    name = "host"

    def __init__(self, trainer):
        self.tr = trainer

    def run_epoch(self, epoch: int, indices: np.ndarray, plan,
                  lr: float) -> EpochRunResult:
        tr = self.tr
        # The strategy's device state is threaded through the steps and
        # handed back at the epoch boundary (also on a crash).
        state = tr.strategy.get_device_state()
        # Without a fused observe, a strategy that observes does so here,
        # on the host, after every batch (no-op observes are no syncs).
        host_observe = (tr._fuse is None and type(tr.strategy).observe
                        is not SampleStrategy.observe)
        losses, bwds = [], []
        loop_syncs = 0
        try:
            for idx, batch in tr.pipeline.batches(indices):
                weight = tr.strategy.batch_weights(idx)
                if weight is not None:
                    batch = dict(batch, weight=np.asarray(weight, np.float32))
                state, scalar, bwd, metrics = tr.train_step(
                    state, tr.to_device(tr.local_rows(batch)), idx,
                    tr.epoch_dev, tr.lr_dev)
                losses.append(scalar)
                if bwd is not None:
                    bwds.append(bwd)
                if host_observe:
                    self._observe(idx, metrics, epoch)
                    loop_syncs += 1
        finally:
            if state is not None:
                tr.strategy.set_device_state(state)
        if not losses:
            return EpochRunResult(np.zeros(0), 0, 0, host_syncs=loop_syncs)
        # The epoch's one crossing to the host: the losses, the backward
        # count and the guard's counters together.
        parts = [torch.stack(losses).to(torch.float64)]
        if bwds:
            parts.append(torch.stack(bwds).sum().to(torch.float64).reshape(1))
        got = torch.cat(parts + _fetch_tail(tr)).cpu().numpy()
        num_steps = len(losses)
        n = num_steps * tr.cfg.batch_size
        bwd_total = int(got[num_steps]) if bwds else n
        return EpochRunResult(
            losses=got[:num_steps].copy(), fwd_samples=n,
            bwd_samples=bwd_total, host_syncs=loop_syncs,
            **_guard_totals(tr, got[num_steps + bool(bwds):]))

    def _observe(self, idx: np.ndarray, metrics, epoch: int) -> None:
        """The legacy host-observe path's per-batch scatter; under the guard
        the non-finite observations are filtered out on the host first
        (this path waits on every batch anyway)."""
        tr = self.tr
        lv, pa, pc = metrics
        if tr.guard_state is not None:
            valid = guard.observation_valid(lv, pc)
            keep = valid.cpu().numpy()
            if not keep.all():
                tr._guard_host_q += int((~keep).sum())
                idx = np.asarray(idx)[keep]
                lv, pa, pc = lv[valid], pa[valid], pc[valid]
        if len(idx):
            tr.strategy.observe(idx, lv, pa, pc, epoch)


def scan_block_sizes(num_steps: int, scan_steps: int) -> list[int]:
    """Partition an epoch's steps into block lengths: as many full
    ``scan_steps`` blocks as fit, then the remainder as descending powers
    of two, so that a run only ever builds the lengths {scan_steps} and
    {1, 2, 4, ...} below it, whatever each epoch's visible count."""
    sizes = [scan_steps] * (num_steps // scan_steps)
    rem = num_steps % scan_steps
    p = 1 << (scan_steps.bit_length())
    while rem:
        if rem >= p:
            sizes.append(p)
            rem -= p
        else:
            p >>= 1
    return sizes


@dataclasses.dataclass
class _Captured:
    """One block length's CUDA graph and the kernel launches one replay
    runs."""

    graph: torch.cuda.CUDAGraph
    launches: collections.Counter


class ScanEpochEngine:
    """Device-side batch assembly and ``scan_steps``-step blocks, captured
    as CUDA graphs on a CUDA device."""

    name = "scan"
    #: Eager blocks run on the capture stream before the engine's first
    #: capture (of a weighted or an unweighted block), as a whole-network
    #: capture needs (library handles, workspaces, autograd).
    WARMUP_BLOCKS = 2

    def __init__(self, trainer):
        self.tr = trainer
        self.scan_steps = max(int(trainer.cfg.scan_steps), 1)
        self._bufs: dict | None = None    # built lazily: see _setup
        self._data: dict | None = None
        self._graphs: dict[tuple[int, bool], _Captured] = {}
        self._pool = None                 # the graphs' shared memory pool
        self._stream = None
        self._held: tuple | None = None   # addresses of the first block

    # ------------------------------------------------------------ buffers

    def _setup(self) -> dict:
        """The device data and the static buffers of the blocks: row k of
        ``idx`` and ``w`` feed step k, which writes its loss and backward
        count into row k of ``out``.  Built at the first epoch (or
        ``warmup``), never by the constructor."""
        if self._bufs is None:
            tr, k = self.tr, self.scan_steps
            b, dev = tr.cfg.batch_size, tr.device
            self._data = tr.device_data()
            if tr.ctx.group is not None:
                # The communicator exists before any capture needs it.
                tr.ctx.all_reduce(torch.zeros(1, device=dev))
            self._bufs = {
                "idx": torch.zeros((k, b), dtype=torch.int64, device=dev),
                "w": torch.ones((k, b), dtype=torch.float32, device=dev),
                "out": torch.zeros((k, 2), dtype=torch.float64, device=dev)}
        return self._bufs

    def step(self, k: int, weighted: bool) -> None:
        """Train step ``k`` of a block, on row ``k`` of the static buffers:
        the host loop's ``Trainer.train_step`` on a batch gathered on the
        device."""
        tr, buf = self.tr, self._bufs
        idx = buf["idx"][k]
        rows = tr.ctx.shard_rows(idx)           # this rank's (all off-mesh)
        batch = {name: v.index_select(0, rows) for name, v in self._data.items()}
        if weighted:
            batch["weight"] = tr.ctx.shard_rows(buf["w"][k])
        own = tr.strategy.get_device_state()
        state, scalar, bwd, _ = tr.train_step(own, batch, idx, tr.epoch_dev,
                                              tr.lr_dev)
        if state is not own:
            tr.strategy.set_device_state(state)     # copies in place
        out = buf["out"][k]
        out[0].copy_(scalar)
        if bwd is not None:
            out[1].copy_(bwd)

    def _block(self, size: int, weighted: bool) -> None:
        for k in range(size):
            self.step(k, weighted)

    # ------------------------------------------------------------ capture

    def _guard_counters(self) -> list[torch.Tensor]:
        gs = self.tr.guard_state
        return gs.tensors() if gs is not None else []

    def _train_state(self) -> list[torch.Tensor]:
        """Everything a block writes besides its own buffers and scratch."""
        tr = self.tr
        return [*tr.model.parameters(), *tr.model.buffers(),
                *tr.opt.state_tensors(), *(tr.ef_state or ()),
                *(t for _, t in flatten(tr.strategy.get_device_state())),
                *self._guard_counters()]

    @torch.no_grad()
    def _snapshot(self) -> list[torch.Tensor]:
        """A copy of the train state in host memory.  The copy waits for
        the state's last writer, and host memory has room for a model near
        the card's size, whose warm-up blocks need the card's room."""
        return [t.to("cpu", copy=True) for t in self._train_state()]

    @torch.no_grad()
    def _restore(self, saved: list[torch.Tensor]) -> None:
        for t, s in zip(self._train_state(), saved):
            t.copy_(s)

    def _addresses(self) -> tuple:
        tr = self.tr
        held = [*tr.model.parameters(), *tr.model.buffers(),
                *tr.opt.state_tensors(), *(tr.ef_state or ()),
                tr.lr_dev, tr.epoch_dev,
                *tr.strategy.step_tensors(), *self._guard_counters(),
                *self._data.values(), *self._bufs.values()]
        return tuple(t.data_ptr() for t in held)

    def _capture(self, size: int, weighted: bool) -> _Captured:
        """Capture a ``size``-step block: before the engine's first capture
        of its kind, eager warm-up blocks on the capture stream with the
        train state restored after them; then the capture itself.  A later
        capture runs the same step (another number of times) on the same
        stream, whose handles and workspaces that warm-up made: it needs
        none, and a large model's state is not copied again."""
        tr, dev = self.tr, self.tr.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, main = self._stream, torch.cuda.current_stream(dev)
        warm = not any(w == weighted for _, w in self._graphs)
        # The snapshot comes before the side stream joins the main one, so
        # that no warm-up write can overtake it.
        saved = self._snapshot() if warm else None
        side.wait_stream(main)
        if warm:
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP_BLOCKS):
                    self._block(size, weighted)
            main.wait_stream(side)
            self._restore(saved)
            del saved
            side.wait_stream(main)
        tr.opt.zero_grad()
        graph = torch.cuda.CUDAGraph()
        counted = collections.Counter(backend.LAUNCHES)
        # A garbage collection inside the capture may finalize a dead
        # trainer and with it its graphs and memory: a CUDA call the capture
        # does not allow, which invalidates it (torch.cuda.graph no longer
        # collects before capturing).  Hold the collector off until the
        # capture ends; a full collection here would cost ~0.2 s a capture.
        gc_was_enabled = gc.isenabled()
        gc.disable()
        # Under a group another thread (NCCL's watchdog) queries events
        # while the capture runs: only this thread's calls are checked.
        mode = "global" if tr.ctx.group is None else "thread_local"
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode=mode):
                self._block(size, weighted)
        finally:
            if gc_was_enabled:
                gc.enable()
        launches = collections.Counter(backend.LAUNCHES)
        launches.subtract(counted)
        # The capture launched nothing: its counts are each replay's.
        backend.LAUNCHES.clear()
        backend.LAUNCHES.update(counted)
        if self._pool is None:
            self._pool = graph.pool()
        cap = _Captured(graph, +launches)
        self._graphs[size, weighted] = cap
        return cap

    def _dispatch(self, size: int, weighted: bool) -> None:
        """Run one block: a replay of its graph on a CUDA device (captured
        at first use), the steps themselves on the CPU.  Either way the
        tensors a block holds must be the ones the first block held: the
        check the graphs need runs on the CPU too, so that the tests catch
        a rebinding the card would not survive."""
        held = self._addresses()
        if self._held is None:
            self._held = held
        elif held != self._held:
            raise RuntimeError(
                "the scanned engine's blocks no longer hold the trainer's "
                "tensors (a parameter, optimizer state, compression "
                "residual, strategy state, guard counter, LR/epoch scalar or "
                "the device data was rebound instead of updated in place)")
        if self.tr.device.type != "cuda":
            self._block(size, weighted)
            return
        cap = self._graphs.get((size, weighted)) or self._capture(size, weighted)
        cap.graph.replay()
        backend.LAUNCHES.update(cap.launches)

    def warmup(self) -> int:
        """Build every block length ``run_epoch`` can dispatch ({scan_steps}
        and the power-of-two remainders) without changing the train state;
        on the CPU, where nothing is built, run each once and restore the
        state.  Returns the number of lengths."""
        tr = self.tr
        self._setup()
        weighted = (type(tr.strategy).batch_weights
                    is not SampleStrategy.batch_weights)
        sizes = sorted({size for rem in range(self.scan_steps + 1)
                        for size in scan_block_sizes(rem, self.scan_steps)}
                       | {self.scan_steps}, reverse=True)
        for size in sizes:
            if tr.device.type == "cuda":
                if (size, weighted) not in self._graphs:
                    self._capture(size, weighted)
            else:
                saved = self._snapshot()
                self._block(size, weighted)
                self._restore(saved)
        return len(sizes)

    # ------------------------------------------------------------ epoch

    def _place(self, arr: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of an epoch-plan array."""
        return torch.from_numpy(arr).to(self.tr.device)

    @staticmethod
    def _fetch(out: torch.Tensor) -> np.ndarray:
        """The epoch's one crossing to the host: the (num_steps, 2) of (loss,
        backward count), flattened, then the guard's counters."""
        return out.cpu().numpy()

    def run_epoch(self, epoch: int, indices: np.ndarray, plan,
                  lr: float) -> EpochRunResult:
        tr, c = self.tr, self.tr.cfg
        plan_idx = epoch_index_plan(np.asarray(indices), c.batch_size)
        num_steps = plan_idx.shape[0]
        if num_steps == 0:
            return EpochRunResult(np.zeros(0), 0, 0)
        buf = self._setup()
        # Per-sample static weights are plan-time lookups (protocol
        # contract), pre-gathered in the host loop's call order.
        w_rows = [tr.strategy.batch_weights(row) for row in plan_idx]
        weighted = any(w is not None for w in w_rows)
        idx_dev = self._place(plan_idx.astype(np.int64))
        if weighted:
            # None rows mean uniform; weight 1.0 is exact (loss * 1.0).
            w_dev = self._place(np.stack(
                [np.ones(c.batch_size, np.float32) if w is None
                 else np.asarray(w, np.float32) for w in w_rows]))
        out = torch.zeros((num_steps, 2), dtype=torch.float64, device=tr.device)
        start = 0
        for size in scan_block_sizes(num_steps, self.scan_steps):
            buf["idx"][:size].copy_(idx_dev[start:start + size])
            if weighted:
                buf["w"][:size].copy_(w_dev[start:start + size])
            self._dispatch(size, weighted)
            out[start:start + size].copy_(buf["out"][:size])
            start += size
        tail = _fetch_tail(tr)
        flat = out.reshape(-1)
        got = self._fetch(torch.cat([flat, *tail]) if tail else flat)
        rows = got[:2 * num_steps].reshape(num_steps, 2)
        n = num_steps * c.batch_size
        bwd = int(rows[:, 1].sum()) if tr._fsel is not None else n
        return EpochRunResult(losses=rows[:, 0].copy(), fwd_samples=n,
                              bwd_samples=bwd,
                              **_guard_totals(tr, got[2 * num_steps:]))
