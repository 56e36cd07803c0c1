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
must too).  Left for later slices: checkpointing, the numeric guard, the
mesh and straggler code, gradient compression and the scanned engine.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import (ForgetConfig, InfoBatchConfig, ISWRConfig,
                              KakurenboConfig, LRSchedule, SampleStrategy,
                              SBConfig, make_strategy)
from repro_torch.data.pipeline import Pipeline
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import make_optimizer
from repro_torch.train.engines import HostLoopEngine


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
    seed: int = 0
    eval_every: int = 1
    # Per-sample (loss, PA, PC) from the logits in one streaming pass
    # (kernel B1 on the card) instead of the model's separate reductions.
    fused_scoring: bool = False


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
    # SampleState host round trips spent planning the epoch.
    host_syncs: int = 0
    engine: str = "host"


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

    ``dataset.get(indices)`` yields host numpy arrays (``images`` (B, H, W,
    C) f32, ``labels`` (B,) i32); the trainer copies each batch to
    ``device``.  ``device=None`` means CUDA and raises without a CUDA device.
    """

    def __init__(self, cfg: TrainConfig, model: torch.nn.Module,
                 loss_fn: Callable[[Any, dict], tuple] | None, dataset,
                 test_dataset=None, strategy: SampleStrategy | None = None,
                 logits_fn: Callable[[Any, dict], torch.Tensor] | None = None,
                 device: str | torch.device | None = None):
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
        self.model = model.to(self.device)
        # FORGET restarts from the initial weights, as the reference re-inits
        # from the same key: keep a copy of them.
        self._init_weights = copy.deepcopy(self.model.state_dict())
        self.opt = make_optimizer(cfg.optimizer, self.model.parameters(),
                                  **cfg.optimizer_hp)
        self.pipeline = Pipeline(dataset.get, cfg.batch_size)
        self.num_samples = dataset.num_samples
        self.strategy = strategy or make_strategy(
            cfg.strategy, self.num_samples, cfg=cfg, seed=cfg.seed,
            total_epochs=cfg.epochs, device=self.device)
        # The strategy's in-step hooks run on its device state, when it has
        # one: selection before the backward pass, bookkeeping after it.
        has_state = self.strategy.get_device_state() is not None
        self._fuse = self.strategy.fused_observe if has_state else None
        self._fsel = self.strategy.fused_select if has_state else None
        self.engine = HostLoopEngine(self)
        self.epoch = 0
        self.history: list[EpochStats] = []

    def to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_step(self, state, batch: dict, indices: np.ndarray, epoch: int,
                   lr: float):
        """One update; returns (strategy state, loss scalar on the device,
        backward samples as a device scalar, or None for the whole batch)."""
        self.model.train()
        bwd = None
        if self._fsel is not None:
            # A forward-only loss at the current weights drives the in-step
            # selection; its weights mask the backward pass.
            with torch.no_grad():
                _, (lv0, _, _) = self.loss_fn(self.model, batch)
            w_sel, state = self._fsel(state, lv0)
            batch = dict(batch)
            batch["weight"] = (batch["weight"] * w_sel if "weight" in batch
                               else w_sel)
            bwd = torch.count_nonzero(w_sel)
        scalar, (lv, pa, pc) = self.loss_fn(self.model, batch)
        self.opt.zero_grad()
        scalar.backward()
        self.opt.step(lr)
        if self._fuse is not None:
            state = self._fuse(state, indices, lv.detach(), pa, pc.detach(),
                               epoch)
        return state, scalar.detach(), bwd

    @torch.no_grad()
    def eval_step(self, batch: dict):
        self.model.eval()
        _, metrics = self.loss_fn(self.model, batch)
        return metrics

    def run_epoch(self, epoch: int) -> EpochStats:
        c = self.cfg
        t0 = time.perf_counter()
        plan = self.strategy.plan(epoch)
        if plan.reinit_model:
            # FORGET: restart from the initial weights with fresh momentum.
            self.model.load_state_dict(self._init_weights)
            self.opt = make_optimizer(c.optimizer, self.model.parameters(),
                                      **c.optimizer_hp)
        lr = float(c.lr(epoch)) * plan.lr_scale
        res = self.engine.run_epoch(epoch, plan.visible_indices, plan, lr)
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
            host_syncs=plan.host_syncs, engine=self.engine.name)
        self.history.append(stats)
        self.epoch = epoch + 1
        return stats

    def run(self, epochs: int | None = None) -> list[EpochStats]:
        total = epochs or self.cfg.epochs
        while self.epoch < total:
            self.run_epoch(self.epoch)
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
