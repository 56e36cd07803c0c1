"""Fault tolerance and elasticity: the supervisor layer above the Trainer.

The port's own copy of ``repro/train/fault.py`` (numpy only):

1. **Node failure -> checkpoint and restart.** ``run_with_restarts`` is the
   supervisor loop: it (re)builds the trainer, restores the newest good
   checkpoint (``Trainer.restore_latest``: bit-exact, in place) and runs;
   a crash is classified (``classify_failure``: transient device, OS,
   data and checkpoint faults restart, programming bugs do not), backed
   off exponentially while no epoch is gained, and counted against a
   restart budget over an optional sliding window.  In-step numeric faults
   are the trainer's guard's (``train/guard.py``); its ``NonFiniteError``
   is a ``RuntimeError`` so that it lands in the restartable class.
2. **Elastic rescaling.** Sampler state is global (N-sized); workers own
   deterministic slices (``data.pipeline.worker_slice``), and
   ``rescale_plan`` recomputes every worker's view for a new world size
   from the same epoch order.
3. **Stragglers.** ``StragglerMonitor`` keeps each worker's EMA latency,
   flags a worker over ``threshold`` x the median, and ``rebalance`` moves
   a fraction of its rows to the fastest workers.  The trainer feeds it
   each epoch (``TrainConfig.straggler_mitigation``; latencies measured, or
   injected through ``Trainer.shard_latency_fn``) and re-slices the next
   plan when a worker is flagged.  Its world is ``straggler_workers``, or
   else the trainer's data-parallel degree (``ctx.dp_size``, 1 off-mesh,
   where the monitor never flags), as the reference's.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np

from repro_torch.data.pipeline import worker_slice

logger = logging.getLogger("repro_torch.fault")

#: Failure classes a supervisor restart can plausibly cure: I/O and OS
#: faults (disk, network filesystems), runtime faults (torch's CUDA errors
#: and ``torch.cuda.OutOfMemoryError`` subclass RuntimeError, as the chaos
#: injectors and the numeric guard's ``NonFiniteError`` do), data and
#: checkpoint decode errors, and torn streams.
RESTARTABLE_EXCEPTIONS: tuple[type[BaseException], ...] = (
    OSError, RuntimeError, ValueError, EOFError, ConnectionError)

#: Programming bugs: restarting replays the same crash deterministically
#: and burns the restart budget hiding the stack trace.  Checked *before*
#: the restartable classes so e.g. KeyError (a LookupError, not a
#: ValueError) fails fast.
FATAL_EXCEPTIONS: tuple[type[BaseException], ...] = (
    TypeError, AttributeError, LookupError, NameError, AssertionError,
    NotImplementedError, ImportError, SyntaxError)


def classify_failure(exc: BaseException) -> str:
    """``"restartable"`` or ``"fatal"`` for a trainer crash.

    The default policy of ``run_with_restarts``: transient hardware/IO/data
    faults restart, programming bugs propagate immediately.  Unknown
    exception types are fatal — restarting on an unclassified failure is
    how supervisors turn one bug into ``max_restarts`` identical crashes.
    """
    if isinstance(exc, FATAL_EXCEPTIONS):
        return "fatal"
    if isinstance(exc, RESTARTABLE_EXCEPTIONS):
        return "restartable"
    return "fatal"


def run_with_restarts(
    make_trainer: Callable[[], "object"],
    total_epochs: int,
    max_restarts: int = 3,
    *,
    backoff_base: float = 0.5,
    backoff_factor: float = 2.0,
    backoff_max: float = 30.0,
    restart_window: float | None = None,
    classify: Callable[[BaseException], str] = classify_failure,
    sleep_fn: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_restart: Callable[[int, BaseException], None] | None = None,
) -> tuple[object, int]:
    """Supervisor: (re)build the trainer, resume from the latest checkpoint,
    run; on a *restartable* crash, back off and restart.

    Returns ``(trainer, restarts_used)``.

    - ``classify`` decides restartable vs fatal (``classify_failure`` by
      default); fatal failures re-raise immediately.
    - Backoff between attempts is ``backoff_base * backoff_factor**k``
      (capped at ``backoff_max``) where ``k`` counts consecutive restarts
      *without progress* — a crash after the trainer advanced at least one
      epoch resets the backoff, so a long healthy run isn't punished for
      its history.  ``backoff_base=0`` disables sleeping.
    - ``restart_window`` (seconds) makes the budget a sliding window: only
      restarts within the last window count against ``max_restarts``.
      ``None`` counts all restarts ever (the legacy budget).
    - ``sleep_fn``/``clock`` are injectable for tests; ``on_restart(n,
      exc)`` is a hook for external telemetry.
    """
    restarts = 0
    restart_times: list[float] = []
    stagnant = 0   # consecutive restarts without epoch progress
    while True:
        trainer = make_trainer()
        trainer.restore_latest()
        start_epoch = int(getattr(trainer, "epoch", 0))
        try:
            trainer.run(total_epochs)
            if restarts:
                logger.info("run completed after %d restart(s)", restarts)
            return trainer, restarts
        except Exception as e:  # noqa: BLE001 — classified below
            kind = classify(e)
            at_epoch = int(getattr(trainer, "epoch", start_epoch))
            if kind != "restartable":
                logger.error(
                    "fatal failure at epoch %d (%s: %s) — not restarting",
                    at_epoch, type(e).__name__, e)
                raise
            restarts += 1
            now = clock()
            restart_times.append(now)
            if restart_window is not None:
                restart_times = [t for t in restart_times
                                 if now - t <= restart_window]
                budget_used = len(restart_times)
            else:
                budget_used = restarts
            stagnant = 0 if at_epoch > start_epoch else stagnant + 1
            if budget_used > max_restarts:
                logger.error(
                    "restart budget exhausted (%d restart(s)%s) after "
                    "failure at epoch %d (%s: %s)", budget_used,
                    "" if restart_window is None
                    else f" within {restart_window:g}s", at_epoch,
                    type(e).__name__, e)
                raise
            delay = (min(backoff_base * backoff_factor ** (stagnant - 1),
                         backoff_max) if backoff_base > 0 and stagnant
                     else 0.0)
            logger.warning(
                "restartable failure at epoch %d (%s: %s) — restart %d/%d "
                "(window use %d, backoff %.2fs, progress=%s)", at_epoch,
                type(e).__name__, e, restarts, max_restarts, budget_used,
                delay, at_epoch > start_epoch)
            if on_restart is not None:
                on_restart(restarts, e)
            if delay:
                sleep_fn(delay)


@dataclasses.dataclass
class RescalePlan:
    world_size: int
    per_worker: list[np.ndarray]


def rescale_plan(epoch_indices: np.ndarray, new_world_size: int,
                 batch_per_worker: int) -> RescalePlan:
    """Deterministic re-slicing of an epoch's index list for a new world size."""
    views = [worker_slice(epoch_indices, new_world_size, r, batch_per_worker)
             for r in range(new_world_size)]
    return RescalePlan(new_world_size, views)


class StragglerMonitor:
    def __init__(self, world_size: int, ema: float = 0.9,
                 threshold: float = 1.5):
        self.lat = np.zeros(world_size)
        self.ema = ema
        self.threshold = threshold

    @property
    def world_size(self) -> int:
        return len(self.lat)

    def record(self, rank: int, step_time: float) -> None:
        a = self.ema
        self.lat[rank] = (a * self.lat[rank] + (1 - a) * step_time
                          if self.lat[rank] > 0 else step_time)

    def record_epoch(self, latencies) -> None:
        """Record one epoch's per-worker latencies (len == world_size)."""
        if len(latencies) != len(self.lat):
            raise ValueError(
                f"got {len(latencies)} latencies for world_size "
                f"{len(self.lat)}")
        for rank, t in enumerate(latencies):
            self.record(rank, float(t))

    def stragglers(self) -> np.ndarray:
        med = np.median(self.lat[self.lat > 0]) if (self.lat > 0).any() else 0.0
        if med == 0.0:
            return np.zeros(len(self.lat), bool)
        return self.lat > self.threshold * med

    def rebalance(self, per_worker: list[np.ndarray],
                  shed_fraction: float = 0.25) -> list[np.ndarray]:
        """Move a fraction of each straggler's remaining samples to the
        fastest workers (work stealing at epoch granularity)."""
        flags = self.stragglers()
        if not flags.any():
            return per_worker
        out = [w.copy() for w in per_worker]
        order = np.argsort(self.lat)           # fastest first
        fast = [r for r in order if not flags[r]]
        if not fast:
            return per_worker
        fi = 0
        for r in np.nonzero(flags)[0]:
            k = int(len(out[r]) * shed_fraction)
            if k == 0:
                continue
            moved, out[r] = out[r][-k:], out[r][:-k]
            tgt = fast[fi % len(fast)]
            out[tgt] = np.concatenate([out[tgt], moved])
            fi += 1
        return out
