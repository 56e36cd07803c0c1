"""One run of a cell against the program: set-up, the window, the traced
epoch, and what the correctness check reads from the program.

Set-up builds one ``Trainer`` of ``repro_torch`` from the benchmark's
corpus and weights and runs epochs 0 and 1 through ``Trainer.run_epoch``:
KAKURENBO hides nothing before it has a whole epoch of losses, and these
epochs capture every block length the window replays.  The window then
runs whole epochs through ``Trainer.run_epoch`` until its seconds have
passed.  The check follows the first steps of epoch 0 from the seed, and
the window's first epoch from device copies of the train state taken
before it (``check.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import time

import torch

from h100_bench import corpus as corpus_mod
from h100_bench import seeds, weights
from h100_bench.cells import Cell

#: The sample state's fields that a plan reads and an epoch writes.
FIELDS = ("loss", "seen", "pa", "pc")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Spans:
    """Host clocks around calls into the program's layers (the traced run
    only): seconds a call, by layer, each ended by a synchronise."""

    device: torch.device
    times: dict = dataclasses.field(default_factory=dict)
    results: dict = dataclasses.field(default_factory=dict)

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
                sync(self.device)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            self.results.setdefault(name, []).append(out)
            return out
        return timed

    def clear(self) -> None:
        self.times.clear()
        self.results.clear()


class Recorder:
    """Each epoch's plan with its inputs, and the train steps' losses: the
    sample state before the plan (a device copy, no wait), the permutation
    the plan drew, the ``EpochPlan``, and the per-step losses the engine
    fetched.  ``epochs``: {epoch: record}."""

    def __init__(self, trainer):
        self.epochs: dict = {}
        strategy = trainer.strategy
        sampler = getattr(strategy, "_inner", strategy)
        self._perm = None
        draw = sampler.draw_permutation

        def recorded():
            self._perm = draw()
            return self._perm
        sampler.draw_permutation = recorded
        plan = strategy.plan

        def planned(epoch):
            st = strategy.get_device_state()
            before = None if st is None else {
                k: getattr(st, k).clone() for k in FIELDS}
            out = plan(epoch)
            self.epochs[epoch] = {"epoch": epoch, "before": before,
                                  "perm": self._perm, "plan": out}
            return out
        strategy.plan = planned
        engine_run = trainer.engine.run_epoch

        def ran(epoch, indices, plan, lr):
            res = engine_run(epoch, indices, plan, lr)
            self.epochs[epoch]["losses"] = [float(x) for x in res.losses]
            return res
        trainer.engine.run_epoch = ran


class Session:
    """The program under test for one cell and seed, set up."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda",
                 traced: bool = False):
        t_import = time.perf_counter()
        from repro_torch.configs.base import ArchConfig, SSMConfig
        from repro_torch.core import KakurenboConfig, LRSchedule
        from repro_torch.kernels import backend
        from repro_torch.models import LM
        from repro_torch.train import Trainer, TrainConfig
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            backend.library()          # built once a checkout (build/)
        self.import_s = time.perf_counter() - t_import
        arch, shape, tr_cfg = cell.arch, cell.shape, cell.traffic
        c = tr_cfg["corpus"]
        self.corpus = corpus_mod.make(
            seeds.child(seed, "corpus"), shape["num_samples"],
            shape["seq_len"], c["vocab"], c["easy_fraction"], c["order"])
        fields = {k: v for k, v in arch.items()
                  if k in ArchConfig.__dataclass_fields__ and k != "ssm"}
        fields["name"] = cell.config["name"]
        if arch.get("ssm"):
            fields["ssm"] = SSMConfig(**arch["ssm"])
        model = LM(ArchConfig(**fields), weights.nested(
            weights.make(arch, seed, self.device)))
        opt = dict(tr_cfg["optimizer"])
        lr = opt.pop("lr")
        k = tr_cfg.get("kakurenbo", {})
        tc = TrainConfig(
            epochs=1_000_000, batch_size=shape["batch"],
            strategy=tr_cfg["strategy"], optimizer=opt.pop("name"),
            optimizer_hp=opt,
            lr=LRSchedule(lr, "constant", total_epochs=1_000_000,
                          warmup_epochs=0),
            kakurenbo=KakurenboConfig(**k),
            seed=seeds.int_seed(seeds.child(seed, "program"), 31),
            scan_steps=tr_cfg["scan_steps"])
        self.trainer = Trainer(tc, model, lambda m, b: m.loss_and_metrics(b),
                               self.corpus, None, device=self.device)
        self.names = [n for n, _ in self.trainer.model.named_parameters()]
        self.recorder = Recorder(self.trainer)
        self.spans = Spans(self.device) if traced else None
        if traced:
            tr = self.trainer
            tr.run_epoch = self.spans.wrap("epoch", tr.run_epoch)
            tr.strategy.plan = self.spans.wrap("plan", tr.strategy.plan)
            tr.engine.run_epoch = self.spans.wrap("engine", tr.engine.run_epoch)
            tr.strategy.on_epoch_end = self.spans.wrap(
                "refresh", tr.strategy.on_epoch_end)
        #: Seconds of each set-up stage of the session.
        self.setup_stages = {"import": self.import_s,
                             "build": time.perf_counter() - t_import
                             - self.import_s}
        #: The program's peak of allocated device bytes over set-up and
        #: the window, the benchmark's own copies of the train state left
        #: out (``held`` bytes).
        self.peak_bytes = 0
        self._peak(0)
        # The check's copies of the train state, allocated before the
        # program's first epoch so that the program's own allocations
        # settle around them; ``run_window`` only fills them.
        self.before, held = self._held(self._copy_state)
        self.after, more = self._held(self._copy_after)
        self.held = held + more
        for epoch in (0, 1):
            t = time.perf_counter()
            self.trainer.run_epoch(epoch)
            sync(self.device)
            self.setup_stages[f"epoch{epoch}"] = time.perf_counter() - t
        if self.spans is not None:
            self.spans.clear()
        self.window_epochs: list = []
        self.checked = None            # the window's first epoch

    # ------------------------------------------------------------ window

    def _copy_state(self) -> dict:
        """Device copies of the parameters and AdamW's m, v and step."""
        tr = self.trainer
        opt = tr.opt.state_dict()
        return {"params": {n: p.detach().clone() for n, p in
                           tr.model.named_parameters()},
                "m": {n: t.clone() for n, t in zip(self.names, opt["m"])},
                "v": {n: t.clone() for n, t in zip(self.names, opt["v"])},
                "t": int(opt["t"])}

    def _copy_after(self) -> dict:
        """Device copies of the parameters and the sample state."""
        tr = self.trainer
        st = tr.strategy.get_device_state()
        return {"params": {n: p.detach().clone() for n, p in
                           tr.model.named_parameters()},
                "state": None if st is None else {
                    k: getattr(st, k).clone() for k in FIELDS}}

    def _fill_state(self) -> None:
        """Copy the parameters and AdamW's m and v into the buffers that
        ``_copy_state`` made, and read its step."""
        tr = self.trainer
        opt = tr.opt.state_dict()
        for n, p in tr.model.named_parameters():
            self.before["params"][n].copy_(p.detach())
        for n, m, v in zip(self.names, opt["m"], opt["v"]):
            self.before["m"][n].copy_(m)
            self.before["v"][n].copy_(v)
        self.before["t"] = int(opt["t"])

    def _fill_after(self) -> None:
        """Copy the parameters and the sample state into the buffers that
        ``_copy_after`` made: enqueued on the device, no allocation."""
        tr = self.trainer
        for n, p in tr.model.named_parameters():
            self.after["params"][n].copy_(p.detach())
        st = tr.strategy.get_device_state()
        if st is not None:
            for k in FIELDS:
                self.after["state"][k].copy_(getattr(st, k))

    def _held(self, make) -> tuple[object, int]:
        """``make()`` and the device bytes it allocated."""
        if self.device.type != "cuda":
            return make(), 0
        before = torch.cuda.memory_allocated(self.device)
        out = make()
        return out, torch.cuda.memory_allocated(self.device) - before

    def _peak(self, held: int) -> None:
        """Fold the peak since the last reset, less ``held`` bytes of the
        benchmark's copies, into ``peak_bytes``; reset the peak."""
        if self.device.type != "cuda":
            return
        peak = torch.cuda.max_memory_allocated(self.device) - held
        self.peak_bytes = max(self.peak_bytes, peak)
        torch.cuda.reset_peak_memory_stats(self.device)

    def run_window(self, seconds: float) -> float:
        """Whole epochs until ``seconds`` have passed (one at least);
        returns their wall time, the device's work included.  The train
        state before the first of them and the parameters and sample
        state after it are copied on the device for the check, into
        buffers allocated in set-up: the copy after is only enqueued
        between two epochs (some milliseconds of device time), since an
        allocation of gigabytes there can hold the host for a large and
        varying share of a second.  The copies' bytes are left out of
        ``peak_bytes``."""
        tr = self.trainer
        self._peak(self.held)
        self.checked = tr.epoch
        self._fill_state()
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            self.window_epochs.append(tr.run_epoch(tr.epoch))
            if len(self.window_epochs) == 1:
                self._fill_after()
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self._peak(self.held)
        return elapsed

    def traced_epoch(self):
        """One more epoch under ``torch.profiler``; returns the profile."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        tr = self.trainer
        with profile(activities=acts) as prof:
            sync(self.device)
            tr.run_epoch(tr.epoch)
            sync(self.device)
        return prof

    # ------------------------------------------------------------ outputs

    def outputs(self) -> dict:
        """What the check judges, read off the program once the window has
        closed: epoch 0's record (its plan and first steps' losses), the
        window's first epoch's record, the train state before it (device
        copies), each leaf's change over it, and the sample state after
        it."""
        rec = self.recorder.epochs
        after = self.after["params"]
        change = weights.leaf_norms({n: after[n] - p for n, p in
                                     self.before["params"].items()})
        self.after["params"] = None
        return {"start": rec[0], "epoch": rec[self.checked],
                "before": self.before, "change": change,
                "state": self.after["state"]}

    def close(self) -> None:
        """Drop the program's state (graphs, optimizer, model)."""
        import gc
        self.trainer = self.recorder = self.spans = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
