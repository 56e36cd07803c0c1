"""Epoch-based trainer over the ``SampleStrategy`` protocol (single device).

Port of ``repro/train/trainer.py``, single device: the paper's experiments
as ``examples/quickstart.py`` and ``benchmarks/table2_accuracy.py`` run them
— SGD-momentum, the strategy's epoch plan, the Eq. 8 LR factor, FORGET's
restart from the initial model (``EpochPlan.reinit_model``), per-sample loss
weights (``batch_weights``: ISWR, InfoBatch), the in-step hooks on the
strategy's device state (``fused_select`` before the backward pass:
Selective-Backprop; ``fused_observe`` after it), the step-D refresh and the
work accounting (forward/backward samples, the quantity the paper's speedup
comes from).

``TrainConfig.fused_scoring`` derives the per-sample (loss, PA, PC) from the
model's logits in one pass (``kernels/ops.fused_loss_metrics``: kernel B1 on
the card) and needs ``logits_fn(model, batch) -> (B, V) logits``; otherwise
``loss_fn(model, batch) -> (scalar, (loss, pa, pc))`` is the caller's.

The objective is the weighted mean ``mean(ce * w)`` when the batch carries
a ``"weight"`` (the fused-scoring loss does this; a caller's ``loss_fn``
must too).

The epoch engine (``train/engines.py``) is chosen as the reference's
``_make_engine`` does: ``engine="auto"`` runs every strategy that
``supports_scan`` through the scanned engine (device-resident data, CUDA
graphs on the card) and the rest through the host loop.  The LR and the
epoch reach the step as 0-dim device tensors (``lr_dev``, ``epoch_dev``),
filled before each epoch, under both engines.  Checkpoints
(``save_checkpoint``/``restore_latest``, every ``checkpoint_every`` epochs)
hold the parameters, the momentum, the initial weights (FORGET's restart
point) and the strategy's arrays with its generators' states, and a
restore copies them into the live tensors in place, so a restart is
bit-exact under both engines.

The resilience layer of the reference: ``guard_policy="skip_update"`` runs
the numeric guard inside the step (``train/guard.py``: non-finite loss or
grads hold the parameters and the optimizer's state at their pre-step
values, non-finite observations are quarantined from the strategy's state,
the counters come back in the epoch's one fetch, ``guard_abort_after``
raises ``NonFiniteError`` at the epoch boundary); ``fused_observe=False``
is the legacy host-observe path (the host loop calls ``strategy.observe``
after every batch); ``straggler_mitigation`` feeds ``fault.StragglerMonitor``
each epoch and re-slices the next plan when a worker is flagged; the
supervisor and the chaos injectors are ``train/fault.py`` and
``train/chaos.py``.  Grad-Match reaches its features through ``feats_fn``
(``prepare`` before each plan).  Each epoch runs with
``torch.backends.cudnn.deterministic`` on and ``benchmark`` off (the
caller's values restored after it), which the engines' and restart's
bit-identity on the card rests on; ``CUDNN_DETERMINISTIC = False`` leaves
the flags alone, for a control run that measures what they buy.

``grad_compression`` quantizes each step's gradients to 8 bits with error
feedback (``dist/compression.py``) between the backward pass and the
optimizer, in the reference's order: under the guard the finiteness check,
then ``guard.zero_if`` (a poisoned gradient never enters the residual),
then the compressor, the update, and the held select, which restores the
residual with the parameters and the optimizer's state.  The residual
(``Trainer.ef_state``, one tensor a parameter) is part of the trajectory:
the scanned engine's graphs hold it, the checkpoint carries it (``"ef"``,
only with compression on), and FORGET's restart keeps it, as the
reference's does.

``mesh_shape`` trains data-parallel over a ``torch.distributed`` group
(``launch/mesh.py``: every rank builds its own Trainer; the reference's
``_jit_steps_mesh``).  The model, the optimizer's state and the
compression residual are replicated, each rank takes the rows ``[r B/D,
(r + 1) B/D)`` of every batch (global chunks ``r C/D .. (r + 1) C/D - 1``
of ``grad_chunks`` C, in order), and the strategies' ``SampleState`` is
row-sharded (``core/*``, ``ctx``).  ``grad_allreduce="fold"`` runs a
forward and backward a chunk, all-gathers the ``(C, P)`` gradients with
the chunk losses and per-sample metrics (one collective a step), and folds
them left to right in chunk order, then divides by C: the gradients and
the loss depend on C alone, never on D, so training is bit-identical
across world sizes.  ``"psum"`` takes one backward over the local rows
and an all-reduce divided by D: reproducible at one world size only.  The
guard and the compressor then act on the reduced gradients in the
single-device order, so ``ok`` is the same on every rank.  The fused
observe gathers the batch's (loss, PA, PC) and each rank writes its own
rows; Selective-Backprop's select runs a forward-only loss over the local
rows (chunk by chunk), gathers it and runs on its replicated state.
Evaluation and the refresh take per-sample metrics over the local rows,
gathered.  The step waits on nothing, and its collectives run on the
calling stream, so that the scanned engine still captures it (NCCL).
Unlike the reference, which row-shards the device-resident dataset and
leans on GSPMD for the gathers across shards, each rank keeps the whole
training set on its device and gathers its own rows of each batch:
torch has no such partitioner, and the bits are the same.  A checkpoint
holds the global arrays (rank 0 writes, every rank waits at a barrier),
so it restores at any world size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import logging
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.core import (ForgetConfig, GradMatchConfig, InfoBatchConfig,
                              ISWRConfig, KakurenboConfig, LRSchedule,
                              SampleStrategy, SBConfig, make_strategy)
from repro_torch.data.pipeline import Pipeline, materialize
from repro_torch.dist.compression import compress_grads, init_error_feedback
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import make_optimizer
from repro_torch.train import fault, guard
from repro_torch.train.engines import HostLoopEngine, ScanEpochEngine

logger = logging.getLogger("repro_torch.train")

#: Run each epoch with cudnn.deterministic on and benchmark off (the
#: caller's values restored after it): the engines' and restart's
#: bit-identity on the card needs deterministic convolution gradients.
CUDNN_DETERMINISTIC = True


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 10
    batch_size: int = 64
    strategy: str = "baseline"
    optimizer: str = "sgd"
    optimizer_hp: dict = dataclasses.field(
        default_factory=lambda: {"momentum": 0.9})
    lr: LRSchedule = dataclasses.field(
        default_factory=lambda: LRSchedule(base_lr=0.05, kind="cosine",
                                           total_epochs=10, warmup_epochs=1))
    kakurenbo: KakurenboConfig = dataclasses.field(default_factory=KakurenboConfig)
    iswr: ISWRConfig = dataclasses.field(default_factory=ISWRConfig)
    forget: ForgetConfig = dataclasses.field(default_factory=ForgetConfig)
    sb: SBConfig = dataclasses.field(default_factory=SBConfig)
    infobatch: InfoBatchConfig = dataclasses.field(default_factory=InfoBatchConfig)
    gradmatch: GradMatchConfig = dataclasses.field(default_factory=GradMatchConfig)
    seed: int = 0
    eval_every: int = 1
    # Per-sample (loss, PA, PC) from the logits in one streaming pass
    # (kernel B1 on the card) instead of the model's separate reductions.
    fused_scoring: bool = False
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0          # epochs; 0 = only on demand
    # Save checkpoints on a background thread; a failed save re-raises at
    # the next checkpoint boundary, and older checkpoints are only GC'd
    # after the newer save is confirmed.
    async_checkpoint: bool = False
    # Epoch engine: "auto" scans every strategy that supports_scan (all
    # seven ported ones), "scan"/"host" force one (forcing "scan" on a
    # strategy that cannot raises).
    engine: str = "auto"
    # Scanned engine: the dataset placed on the device once, batches
    # gathered there (False makes "auto" pick the host loop).
    device_data: bool = True
    # Scanned engine: train steps in one block (one CUDA graph replay).
    scan_steps: int = 8
    # The strategy's bookkeeping scatter inside the train step (one host
    # sync an epoch); False is the legacy per-batch host observe() path
    # (host loop only), bit-identical to it.
    fused_observe: bool = True
    # Numeric guard (train/guard.py): "off" runs the unguarded step's
    # kernels; "skip_update" holds the parameters and the optimizer's state
    # on a non-finite step and quarantines non-finite observations.
    guard_policy: str = "off"
    # With the guard on: raise guard.NonFiniteError at the epoch boundary
    # once this many consecutive steps were non-finite (0: never).
    guard_abort_after: int = 0
    # Feed fault.StragglerMonitor each epoch (latencies measured, or from
    # Trainer.shard_latency_fn) and re-slice the next plan around a flagged
    # worker; off by default (uniform latencies never flag).
    straggler_mitigation: bool = False
    # Workers the straggler monitor models; 0 = the data-parallel degree
    # (1 off-mesh).
    straggler_workers: int = 0
    # 8-bit error-feedback compression of the gradients before the
    # optimizer (dist/compression.py); the residual rides the checkpoint.
    grad_compression: bool = False
    # Data-parallel training over the (D,) mesh of a torch.distributed
    # group (launch/mesh.py): e.g. (4,) in each of 4 ranks.  None = the
    # single-device path, bit for bit the trainer without it.
    mesh_shape: tuple[int, ...] | None = None
    # Gradients are reduced as a fold over this many fixed-size chunks of
    # the batch in chunk order whatever D: bit-identical across world
    # sizes dividing it.  Must divide batch_size.
    grad_chunks: int = 8
    # "fold": the chunk-major fold above (O(grad_chunks x params) gathered
    # a step); "psum": one O(params) all-reduce, reproducible per world
    # size only.
    grad_allreduce: str = "fold"


@dataclasses.dataclass
class EpochStats:
    epoch: int
    train_loss: float
    test_acc: float
    hidden_fraction: float
    fwd_samples: int
    bwd_samples: int
    lr: float
    wall_time: float
    # SampleState host round trips in the epoch's plan and batch loop.
    host_syncs: int = 0
    engine: str = "host"
    # Numeric guard, this epoch (0 with the guard off): steps whose update
    # was held for a non-finite loss or gradient, and observations
    # quarantined from the strategy's state.
    nonfinite_steps: int = 0
    quarantined_observations: int = 0


def _fused_scoring_loss_fn(logits_fn: Callable) -> Callable:
    """The ``loss_fn`` contract from a raw logits function: the (weighted)
    mean CE plus the (ce, pa, pc) triple of ``fused_loss_metrics``."""

    def loss_fn(model, batch):
        logits = logits_fn(model, batch)
        ce, pa, pc = kernel_ops.fused_loss_metrics(logits, batch["labels"])
        w = batch.get("weight")
        scalar = (ce * w).mean() if w is not None else ce.mean()
        return scalar, (ce, pa, pc)

    return loss_fn


class Trainer:
    """Trains ``model`` on ``dataset`` under the configured strategy.

    ``dataset.get(indices)`` yields a dict of host numpy arrays with the
    batch first (the CNN's ``images`` (B, H, W, C) f32 and ``labels`` (B,)
    i32; an LM's ``tokens``/``labels`` (B, S) i32 and ``mask`` (B, S)
    bool); the trainer copies each batch to ``device``, or gathers its
    rows there under the scanned engine.  ``device=None`` means CUDA and raises without a CUDA device.
    ``num_classes`` reaches the strategies that take it (Grad-Match's
    per-class OMP); ``feats_fn(model, batch) -> (B, d)`` gives the
    per-sample features Grad-Match selects from (``p - onehot(y)``).
    """

    def __init__(self, cfg: TrainConfig, model: torch.nn.Module,
                 loss_fn: Callable[[Any, dict], tuple] | None, dataset,
                 test_dataset=None, strategy: SampleStrategy | None = None,
                 logits_fn: Callable[[Any, dict], torch.Tensor] | None = None,
                 device: str | torch.device | None = None,
                 num_classes: int | None = None,
                 feats_fn: Callable[[Any, dict], torch.Tensor] | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dataset = dataset
        self.test_dataset = test_dataset
        if cfg.fused_scoring:
            if logits_fn is None:
                raise ValueError(
                    "TrainConfig.fused_scoring=True requires the Trainer's "
                    "logits_fn argument (model, batch) -> (B, V) logits")
            self.loss_fn = _fused_scoring_loss_fn(logits_fn)
        elif loss_fn is None:
            raise ValueError(
                "loss_fn is required unless fused_scoring=True builds it "
                "from logits_fn")
        else:
            self.loss_fn = loss_fn
        self._validate()
        self.ctx = self._build_ctx()
        self.model = model.to(self.device)
        with torch.no_grad():
            # Under the mesh every rank starts from rank 0's weights.
            for t in [*self.model.parameters(), *self.model.buffers()]:
                self.ctx.replicate(t)
        # FORGET restarts from the initial weights, as the reference re-inits
        # from the same key: keep a copy of them (checkpointed too), in host
        # memory (read only at that restart and by checkpoints; a model
        # near the card's size has no room for a second copy there).
        self._init_weights = {k: v.detach().to("cpu", copy=True)
                              for k, v in self.model.state_dict().items()}
        self.opt = make_optimizer(cfg.optimizer, self.model.parameters(),
                                  **cfg.optimizer_hp)
        # The error-feedback residual, aligned with opt.params (updated in
        # place: a captured step holds it).
        self.ef_state = (init_error_feedback(self.opt.params)
                         if cfg.grad_compression else None)
        # The step reads the LR and the epoch from the device (fill_ before
        # each epoch): a captured step reads them at replay.
        self.lr_dev = torch.zeros((), dtype=torch.float32, device=self.device)
        self.epoch_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        self.pipeline = Pipeline(dataset.get, cfg.batch_size)
        self.num_samples = dataset.num_samples
        # ctx reaches the strategies that declare it: their SampleState is
        # row-sharded and their plans run over every rank's samples.
        self.strategy = strategy or make_strategy(
            cfg.strategy, self.num_samples, cfg=cfg, seed=cfg.seed,
            num_classes=num_classes, total_epochs=cfg.epochs,
            device=self.device, ctx=self.ctx)
        self.feats_fn = feats_fn
        # The strategy's in-step hooks run on its device state, when it has
        # one: selection before the backward pass, bookkeeping after it
        # (unless fused_observe=False asks for the host-observe path).
        has_state = self.strategy.get_device_state() is not None
        self._fuse = (self.strategy.fused_observe
                      if has_state and cfg.fused_observe else None)
        self._fsel = self.strategy.fused_select if has_state else None
        self._init_guard()
        self._straggler = (fault.StragglerMonitor(cfg.straggler_workers
                                                  or self.ctx.dp_size)
                           if cfg.straggler_mitigation else None)
        #: epoch -> per-worker latencies for the straggler monitor (tests and
        #: the chaos harness inject skew here); None measures the epoch.
        self.shard_latency_fn: Callable[[int], list[float]] | None = None
        self._device_data: dict | None = None    # lazy: see device_data()
        self._pending_save = None    # async-checkpoint handle
        self.engine = self._make_engine()
        self.epoch = 0
        self.history: list[EpochStats] = []

    def _validate(self) -> None:
        c = self.cfg
        if c.engine not in ("auto", "scan", "host"):
            raise ValueError(
                f"TrainConfig.engine={c.engine!r}: must be 'auto', 'scan' "
                "or 'host'")
        if c.guard_policy not in guard.GUARD_POLICIES:
            raise ValueError(
                f"TrainConfig.guard_policy={c.guard_policy!r}: must be one "
                f"of {guard.GUARD_POLICIES}")
        if c.guard_abort_after and c.guard_policy == "off":
            raise ValueError(
                "TrainConfig.guard_abort_after requires "
                "guard_policy='skip_update': with the guard off no "
                "non-finite step is ever counted")
        if c.grad_allreduce not in ("fold", "psum"):
            raise ValueError(
                f"TrainConfig.grad_allreduce={c.grad_allreduce!r}: must be "
                "'fold' (deterministic chunk-major fold) or 'psum' (fast "
                "O(params) all-reduce)")

    def _build_ctx(self) -> ParallelCtx:
        """The reference's mesh checks, then the data mesh: the process
        group this rank joined (a world of one joins its own, under the
        device's default backend)."""
        c = self.cfg
        if not c.mesh_shape:
            return ParallelCtx()
        num_devices = math.prod(c.mesh_shape)
        if c.batch_size % c.grad_chunks:
            raise ValueError(
                f"batch_size={c.batch_size} must be a multiple of "
                f"grad_chunks={c.grad_chunks}")
        if c.grad_chunks % num_devices:
            raise ValueError(
                f"grad_chunks={c.grad_chunks} must be a multiple of the mesh "
                f"size {num_devices}: it is the fixed reduction layout that "
                "keeps losses bit-identical across mesh sizes")
        return mesh_lib.data_parallel_ctx(
            num_devices, mesh_lib.default_backend(self.device))

    def _init_guard(self) -> None:
        """The guard's device counters and scratch (``guard_policy`` not
        "off"): the held copies of the parameters, the optimizer's state
        and the compression residual (and of the fused select's state), and
        the detection flag."""
        self.guard_state = None
        self._guard_seen = (0, 0)    # cumulative totals already reported
        self._guard_host_q = 0       # the host-observe path's quarantines
        if self.cfg.guard_policy == "off":
            return
        if (self._fuse is not None
                and "valid" not in inspect.signature(self._fuse).parameters):
            raise ValueError(
                f"guard_policy={self.cfg.guard_policy!r} needs the strategy's "
                "fused_observe to take the quarantine mask (valid=)")
        dev = self.device
        self.guard_state = guard.init_guard_state(dev)
        self._held = guard.HeldState([*self.model.parameters(),
                                      *self.opt.state_tensors(),
                                      *(self.ef_state or ())])
        self._held_sel = (guard.HeldState(
            [t for _, t in flatten(self.strategy.get_device_state())])
            if self._fsel is not None else None)
        self._found = torch.zeros(1, dtype=torch.float32, device=dev)
        self._one = torch.ones(1, dtype=torch.float32, device=dev)

    def _make_engine(self):
        """The reference's engine choice: scanned when the strategy needs
        nothing from the host between steps (``supports_scan`` and, if it
        observes, an active fused observe) and the data may live on the
        device; forcing ``"scan"`` where it cannot raises."""
        s, c = self.strategy, self.cfg
        observes = type(s).observe is not SampleStrategy.observe
        scannable = s.supports_scan and (self._fuse is not None or not observes)
        if c.engine == "scan" and not scannable:
            raise ValueError(
                f"engine='scan' but strategy {s.name!r} cannot run scanned "
                "epochs (host-side observe without an active fused_observe): "
                "use engine='auto' or 'host'")
        if c.engine == "scan" and not c.device_data:
            raise ValueError(
                "engine='scan' requires device_data=True: the scanned engine "
                "gathers its batches from the device-resident dataset")
        # gloo's collectives run on the host: a CUDA graph cannot hold them.
        host_collectives = (self.ctx.backend == "gloo"
                            and self.device.type == "cuda")
        if c.engine == "scan" and host_collectives:
            raise ValueError(
                "engine='scan' under a gloo group on CUDA: gloo's collectives "
                "run on the host and cannot be captured; use an NCCL group "
                "or engine='host'")
        use_scan = c.engine == "scan" or (c.engine == "auto" and scannable
                                          and c.device_data
                                          and c.scan_steps > 0
                                          and not host_collectives)
        return ScanEpochEngine(self) if use_scan else HostLoopEngine(self)

    def device_data(self) -> dict:
        """The whole dataset as device tensors, placed once at first use
        (``dataset.arrays()``, or ``materialize`` of its ``get``): the
        scanned engine's gather source."""
        if self._device_data is None:
            ds = self.dataset
            arrays = (ds.arrays() if hasattr(ds, "arrays")
                      else materialize(ds.get, self.num_samples))
            self._device_data = {k: torch.from_numpy(v).to(self.device)
                                 for k, v in arrays.items()}
        return self._device_data

    def to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (the batch itself off-mesh)."""
        if self.ctx.group is None:
            return batch
        return {k: self.ctx.shard_rows(v) for k, v in batch.items()}

    def _chunks(self, batch: dict):
        """The batch in ``grad_chunks``-sized pieces of B / C rows, in
        order (views)."""
        rows = self.cfg.batch_size // self.cfg.grad_chunks
        n = next(iter(batch.values())).shape[0]
        for start in range(0, n, rows):
            yield {k: v[start:start + rows] for k, v in batch.items()}

    def _gather_metrics(self, lv, pa, pc):
        """The per-sample (loss, PA, PC) of every rank's rows, in batch
        order: one all-gather of the three packed as float32."""
        got = self.ctx.gather_rows(torch.stack(
            [lv.float(), pa.to(torch.float32), pc.float()], dim=1))
        return got[:, 0], got[:, 1] != 0, got[:, 2]

    def _select_loss(self, batch: dict) -> torch.Tensor:
        """The fused select's (B,) forward-only loss: the whole batch's;
        under the mesh chunk by chunk over the local rows (each piece the
        same rows at every world size), gathered."""
        if self.ctx.group is None:
            return self.loss_fn(self.model, batch)[1][0]
        local = torch.cat([self.loss_fn(self.model, cb)[1][0]
                           for cb in self._chunks(batch)])
        return self.ctx.gather_rows(local)

    def _mesh_grads(self, batch: dict):
        """The mesh step's forward and backward over this rank's rows:
        every parameter's ``grad`` set to the reduced gradient; returns the
        reduced loss scalar and the whole batch's per-sample metrics."""
        ctx, c = self.ctx, self.cfg
        params = self.opt.params
        sizes = [p.numel() for p in params]
        width = sum(sizes)

        def flat_grads(scalar, out):
            grads = torch.autograd.grad(scalar, params, allow_unused=True)
            torch.cat([torch.zeros_like(p).reshape(-1) if g is None
                       else g.reshape(-1) for p, g in zip(params, grads)],
                      out=out)

        if c.grad_allreduce == "psum":
            scalar, (lv, pa, pc) = self.loss_fn(self.model, batch)
            buf = torch.empty(width + 1, dtype=torch.float32,
                              device=self.device)
            flat_grads(scalar, buf[:width])
            buf[width].copy_(scalar.detach())
            ctx.all_reduce(buf, "sum")
            reduced = buf / ctx.dp_size
            lv, pa, pc = self._gather_metrics(lv.detach(), pa, pc.detach())
        else:
            chunks = c.grad_chunks
            rows = c.batch_size // chunks
            local = list(self._chunks(batch))
            buf = torch.empty((len(local), width + 1 + 3 * rows),
                              dtype=torch.float32, device=self.device)
            for i, cb in enumerate(local):
                s_i, (lv, pa, pc) = self.loss_fn(self.model, cb)
                flat_grads(s_i, buf[i, :width])
                buf[i, width].copy_(s_i.detach())
                torch.stack([lv.detach().float(), pa.to(torch.float32),
                             pc.detach().float()],
                            out=buf[i, width + 1:].view(3, rows))
            got = ctx.gather_rows(buf)       # (C, ...): chunk-major
            acc = got[0, :width + 1]
            for j in range(1, chunks):
                acc = acc + got[j, :width + 1]
            reduced = acc / chunks
            mets = got[:, width + 1:].reshape(chunks, 3, rows)
            lv, pa, pc = (mets[:, 0].reshape(-1), mets[:, 1].reshape(-1) != 0,
                          mets[:, 2].reshape(-1))
        off = 0
        for p, n in zip(params, sizes):
            p.grad = reduced[off:off + n].view_as(p)
            off += n
        return reduced[width], (lv, pa, pc)

    def train_step(self, state, batch: dict, indices, epoch, lr):
        """One update; returns (strategy state, loss scalar on the device,
        backward samples as a device scalar or None for the whole batch,
        the detached per-sample (loss, PA, PC)).

        ``indices`` are host or device sample ids, ``epoch`` and ``lr`` the
        trainer's device scalars (``epoch_dev``, ``lr_dev``) or numbers.
        Under the mesh ``batch`` is this rank's rows (``local_rows``) and
        ``indices`` the whole batch's ids; the loss, the backward count and
        the metrics returned are the whole batch's.
        Everything it changes it changes in place, so that one call can be
        captured into a CUDA graph (the scanned engine); the guard too
        waits on nothing.  A non-finite step leaves the parameters, the
        optimizer's state and the compression residual bit for bit as they
        were."""
        self.model.train()
        guarded = self.guard_state is not None
        bwd = None
        if self._fsel is not None:
            # A forward-only loss at the current weights drives the in-step
            # selection; its weights mask the backward pass.
            with torch.no_grad():
                lv0 = self._select_loss(batch)
            if guarded:
                # A non-finite selection loss would poison the selection's
                # history: hold its state, train the whole batch.
                ok0 = torch.isfinite(lv0).all()
                self._held_sel.save()
                w_new, state = self._fsel(state, lv0)
                self._held_sel.restore(ok0)
                w_sel = torch.where(ok0, w_new, torch.ones_like(w_new))
            else:
                w_sel, state = self._fsel(state, lv0)
            bwd = torch.count_nonzero(w_sel)
            w_sel = self.ctx.shard_rows(w_sel)
            batch = dict(batch)
            batch["weight"] = (batch["weight"] * w_sel if "weight" in batch
                               else w_sel)
        if self.ctx.group is None:
            scalar, (lv, pa, pc) = self.loss_fn(self.model, batch)
            lv, pc = lv.detach(), pc.detach()
            self.opt.zero_grad()
            scalar.backward()
            self.opt.fill_missing_grads()
        else:
            scalar, (lv, pa, pc) = self._mesh_grads(batch)
        params = self.opt.params
        grads = [p.grad for p in params if p.grad is not None]
        if guarded:
            ok = guard.all_finite(scalar, grads, self._found, self._one)
            self._held.save()
            if self.ef_state is not None:
                guard.zero_if(torch.logical_not(ok), grads)
        if self.ef_state is not None:
            compress_grads(grads, [e for p, e in zip(params, self.ef_state)
                                   if p.grad is not None])
        self.opt.step(lr)
        quarantined = None
        if guarded:
            self._held.restore(ok)
        if self._fuse is not None:
            if guarded:
                valid = guard.observation_valid(lv, pc)
                state = self._fuse(state, indices, lv, pa, pc, epoch,
                                   valid=valid)
                quarantined = torch.logical_not(valid).sum()
            else:
                state = self._fuse(state, indices, lv, pa, pc, epoch)
        if guarded:
            guard.update_counters(self.guard_state, ok, quarantined)
        return state, scalar.detach(), bwd, (lv, pa, pc)

    @torch.no_grad()
    def eval_step(self, batch: dict):
        """Per-sample (loss, PA, PC) of a batch (under the mesh: of this
        rank's rows, chunk by chunk, gathered: the same at every world
        size)."""
        self.model.eval()
        if self.ctx.group is None:
            _, metrics = self.loss_fn(self.model, batch)
            return metrics
        parts = [self.loss_fn(self.model, cb)[1]
                 for cb in self._chunks(self.local_rows(batch))]
        return self._gather_metrics(*(torch.cat(x) for x in zip(*parts)))

    @torch.no_grad()
    def _collect_feats(self) -> tuple[np.ndarray, np.ndarray]:
        """Grad-Match's host (features, labels) over the whole training set,
        in the reference's batches and order; the trailing batch's padding
        (its rows repeat the first samples) is cut off."""
        self.model.eval()
        feats, labels = [], []
        for _, batch in self.pipeline.batches(np.arange(self.num_samples)):
            feats.append(self.feats_fn(self.model, self.to_device(batch))
                         .cpu().numpy())
            labels.append(batch["labels"])
        n = self.num_samples
        return np.concatenate(feats)[:n], np.concatenate(labels)[:n]

    @contextlib.contextmanager
    def _cudnn_flags(self):
        """cuDNN deterministic and not benchmarking inside, the caller's
        flags restored after (unless ``CUDNN_DETERMINISTIC`` is off)."""
        if not CUDNN_DETERMINISTIC:
            yield
            return
        cudnn = torch.backends.cudnn
        saved = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.benchmark = saved

    def _rebalanced_order(self, indices: np.ndarray) -> np.ndarray:
        """The epoch's order re-sliced around flagged stragglers: split into
        per-worker views (``fault.rescale_plan``), a fraction of each
        straggler's rows moved to the fastest workers
        (``StragglerMonitor.rebalance``), flattened again (re-balanced
        workers first, then the trimmed tail), so every visible sample still
        trains once.  Unchanged when no worker is flagged."""
        mon = self._straggler
        if mon.world_size <= 1 or not mon.stragglers().any():
            return indices
        idx = np.asarray(indices)
        chunk = mon.world_size * self.cfg.batch_size
        n_used = (len(idx) // chunk) * chunk
        rp = fault.rescale_plan(idx[:n_used], mon.world_size,
                                self.cfg.batch_size)
        per_worker = mon.rebalance(rp.per_worker)
        logger.warning(
            "straggler mitigation: stragglers %s, re-balanced worker rows %s",
            np.nonzero(mon.stragglers())[0].tolist(),
            [len(w) for w in per_worker])
        return np.concatenate([*per_worker, idx[n_used:]])

    def run_epoch(self, epoch: int) -> EpochStats:
        with self._cudnn_flags():
            return self._run_epoch(epoch)

    def _run_epoch(self, epoch: int) -> EpochStats:
        c = self.cfg
        t0 = time.perf_counter()
        self.strategy.prepare(
            epoch, self._collect_feats if self.feats_fn is not None else None)
        plan = self.strategy.plan(epoch)
        if plan.reinit_model:
            # FORGET: restart from the initial weights with a fresh optimizer
            # state, both copied in place (a captured step holds the tensors);
            # the compression residual is kept, as in the reference.
            self.model.load_state_dict(self._init_weights)
            self.opt.reset()
        lr = float(c.lr(epoch)) * plan.lr_scale
        self.lr_dev.fill_(lr)
        self.epoch_dev.fill_(epoch)
        indices = plan.visible_indices
        if self._straggler is not None:
            indices = self._rebalanced_order(indices)
        res = self.engine.run_epoch(epoch, indices, plan, lr)
        if self._straggler is not None:
            # Measured latencies are uniform across the workers (never
            # flagged), the same decision on every rank; skew comes
            # injected.
            w = self._straggler.world_size
            lat = (self.shard_latency_fn(epoch)
                   if self.shard_latency_fn is not None
                   else [(time.perf_counter() - t0) / w] * w)
            self._straggler.record_epoch(lat)
        nonfinite, quarantined = self._guard_epoch(epoch, res)
        fwd, bwd = res.fwd_samples, res.bwd_samples
        if plan.needs_refresh:
            # KAKURENBO step D: forward-only refresh of the hidden list.
            def fwd_fn(idx):
                return self.eval_step(self.to_device(self.dataset.get(idx)))
            fwd += self.strategy.on_epoch_end(plan, fwd_fn, c.batch_size)
        acc = self.evaluate() if (self.test_dataset is not None
                                  and epoch % c.eval_every == 0) else float("nan")
        stats = EpochStats(
            epoch=epoch,
            train_loss=(float(np.mean(res.losses)) if len(res.losses)
                        else float("nan")),
            test_acc=acc, hidden_fraction=plan.hidden_fraction,
            fwd_samples=fwd, bwd_samples=bwd, lr=lr,
            wall_time=time.perf_counter() - t0,
            host_syncs=plan.host_syncs + res.host_syncs,
            engine=self.engine.name, nonfinite_steps=nonfinite,
            quarantined_observations=quarantined)
        self.history.append(stats)
        self.epoch = epoch + 1
        if (c.checkpoint_dir and c.checkpoint_every
                and (epoch + 1) % c.checkpoint_every == 0):
            self.save_checkpoint()
        return stats

    def _guard_epoch(self, epoch: int, res) -> tuple[int, int]:
        """This epoch's (non-finite steps, quarantined observations) from
        the engine's cumulative totals (fetched with the losses), and the
        abort policy: the epoch boundary is the run's only host sync."""
        if self.guard_state is None:
            return 0, 0
        c = self.cfg
        nonfinite = res.nonfinite_steps - self._guard_seen[0]
        quarantined = res.quarantined - self._guard_seen[1]
        self._guard_seen = (res.nonfinite_steps, res.quarantined)
        if nonfinite:
            logger.warning(
                "numeric guard: epoch %d held %d non-finite step(s), "
                "quarantined %d observation(s) (consecutive=%d)", epoch,
                nonfinite, quarantined, res.guard_consecutive)
        if c.guard_abort_after and res.guard_consecutive >= c.guard_abort_after:
            raise guard.NonFiniteError(
                f"{res.guard_consecutive} consecutive non-finite train steps "
                f"at epoch {epoch} (guard_abort_after={c.guard_abort_after}): "
                "the parameters are held at the last finite update; restart "
                "from the latest checkpoint")
        return nonfinite, quarantined

    def run(self, epochs: int | None = None,
            fail_at_epoch: int | None = None) -> list[EpochStats]:
        """Run the remaining epochs; ``fail_at_epoch`` raises before that
        epoch (a simulated crash, for the restart tests)."""
        total = epochs or self.cfg.epochs
        while self.epoch < total:
            if fail_at_epoch is not None and self.epoch == fail_at_epoch:
                raise RuntimeError(f"injected failure at epoch {self.epoch}")
            self.run_epoch(self.epoch)
        # Surface a failed trailing async save before reporting success.
        self.finish_checkpoints()
        return self.history

    def evaluate(self) -> float:
        """Top-1 accuracy on the test set (the trailing batch is padded from
        the front, as in the reference)."""
        ds = self.test_dataset
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0
        for idx, batch in Pipeline(ds.get, self.cfg.batch_size).batches(
                np.arange(ds.num_samples)):
            _, pa, _ = self.eval_step(self.to_device(batch))
            correct += pa.sum()
            total += len(idx)
        return int(correct) / max(total, 1)

    # ------------------------------------------------------------ checkpoints

    def _ckpt_tree(self, strategy_sd: dict | None = None) -> dict:
        """The checkpoint's leaves: the live tensors themselves (a restore
        copies into them) and the strategy's arrays."""
        sd = strategy_sd or self.strategy.state_dict()
        tree = {"params": self.model.state_dict(),
                "opt_state": self.opt.state_dict(),
                "strategy": sd["arrays"],
                # FORGET's restart point: the same after a restore into a
                # trainer built from other weights (the reference's key).
                "init_params": self._init_weights}
        if self.ef_state is not None:
            # The residual is trajectory: without it a restart quantizes
            # from a zero carry.  Only with compression on, as the reference.
            tree["ef"] = self._ef_tree()
        return tree

    def _ef_tree(self) -> dict:
        """The compression residual by parameter name."""
        return {name: e for (name, _), e in
                zip(self.model.named_parameters(), self.ef_state)}

    def save_checkpoint(self) -> str | None:
        """Checkpoint the epoch boundary: the tree and the host metadata
        (the epoch, the strategy's host state).  Under the mesh every rank
        gathers the row-sharded state, rank 0 writes the global arrays and
        every rank waits for it at a barrier (an async save: for its
        start)."""
        if not self.cfg.checkpoint_dir:
            return None
        sd = self.strategy.state_dict()
        meta = {"epoch": self.epoch, "strategy": sd["host"]}
        path = None
        if self.ctx.rank == 0:
            if self.cfg.async_checkpoint:
                # Join the previous save first (re-raising its failure); GC
                # waits until the newer save is on disk.
                self.finish_checkpoints()
                self._pending_save = ckpt.save_async(
                    self.cfg.checkpoint_dir, self.epoch, self._ckpt_tree(sd),
                    metadata=meta, keep=None)
                path = self._pending_save.path
            else:
                path = ckpt.save(self.cfg.checkpoint_dir, self.epoch,
                                 self._ckpt_tree(sd), metadata=meta)
        self.ctx.barrier()
        return path

    def finish_checkpoints(self) -> None:
        """Join a pending async save (re-raising its failure), then GC the
        superseded checkpoints."""
        if self._pending_save is None:
            return
        self._pending_save.join()
        self._pending_save = None
        ckpt.gc(self.cfg.checkpoint_dir)

    def _restore_agreed(self, like: dict):
        """``ckpt.restore_latest`` under the mesh: rank 0 picks the step
        (quarantining corrupt ones), every rank reads that one."""
        self.ctx.barrier()
        step, err = -1, None
        if self.ctx.rank == 0:
            try:
                res = ckpt.restore_latest(self.cfg.checkpoint_dir, like)
                step = -1 if res is None else res[2]
            except ValueError as e:
                step, err = -2, e
        chosen = torch.tensor([step], dtype=torch.int64, device=self.device)
        step = int(self.ctx.replicate(chosen).item())
        if err is not None:
            raise err
        if step == -2:
            raise ValueError("rank 0 found no compatible checkpoint")
        if step < 0 or self.ctx.rank == 0:
            return None if step < 0 else res
        return (*ckpt.restore(self.cfg.checkpoint_dir, step, like), step)

    def restore_latest(self) -> bool:
        """Restore the newest good checkpoint into this trainer, in place;
        False when there is none.  Under the mesh each rank reads the
        global arrays and takes its rows."""
        if not self.cfg.checkpoint_dir:
            return False
        like = self._ckpt_tree()
        try:
            res = (ckpt.restore_latest(self.cfg.checkpoint_dir, like)
                   if self.ctx.group is None else self._restore_agreed(like))
        except ValueError as e:
            raise ValueError(
                f"incompatible checkpoint in {self.cfg.checkpoint_dir!r}: "
                f"{e}") from e
        if res is None:
            return False
        tree, meta, step = res
        if "strategy" not in meta:
            raise ValueError(f"checkpoint step {step} holds no strategy "
                             "state: cannot restore its generators")
        # Every tensor is copied into, none rebound (a graph holds them).
        self.model.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in tree["params"].items()})
        self.opt.load_state_dict(tree["opt_state"])
        ckpt.copy_into(self._init_weights, tree["init_params"])
        if self.ef_state is not None:
            ckpt.copy_into(self._ef_tree(), tree["ef"])
        self.strategy.load_state_dict(
            {"arrays": tree["strategy"], "host": meta["strategy"]})
        self.epoch = meta["epoch"]
        logger.info("restored checkpoint step %d (epoch %d)", step, self.epoch)
        return True
