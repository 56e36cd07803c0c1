"""Deterministic fault injection for the training stack (chaos harness).

Port of ``repro/train/chaos.py``.  Every injector is seeded or counted (no
wall clock, no real randomness), so a chaos run is as reproducible as the
trainer it attacks and "recovery is bit-exact" is a meaningful check:

==============================  ===========================================
injector                        fault it models
==============================  ===========================================
:class:`CrashAtStep`            process death mid-epoch (preemption, OOM
                                kill): raises :class:`ChaosError` at a
                                global train-step boundary, under either
                                epoch engine
:func:`poison_samples`          corrupt input records: NaN features for
                                chosen sample ids (the numeric guard and
                                the score quarantine)
:func:`corrupt_checkpoint_leaf` bit-rot on a stored checkpoint: seeded
                                byte flips in a committed leaf (the CRC
                                check and the restore fallback chain)
:func:`failing_leaf_writes`     a failing disk during a save: the
                                checkpoint writer's single-leaf seam raises
                                (save retry, async failure propagation)
:class:`SlowShard`              a straggling worker: a per-epoch latency
                                vector for ``Trainer.shard_latency_fn``
==============================  ===========================================

``ChaosError`` subclasses ``RuntimeError``, so ``fault.classify_failure``
treats an injected crash as it treats a real one: restartable.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Sequence

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt


class ChaosError(RuntimeError):
    """An injected failure.  RuntimeError subclass -> restartable."""


class CrashAtStep:
    """Crash the trainer at global train step ``step`` (0-based, counted
    across epochs; fires once).

    ``install(trainer)`` wraps the dispatch seam of the trainer's engine.
    The host loop: ``Trainer.train_step``, as an instance attribute (the
    crash comes before step ``step`` is dispatched, at a step boundary).
    The scanned engine: ``ScanEpochEngine._dispatch(size, weighted)`` (the
    crash comes before the block that would cover step ``step``: block
    granularity, the engine's own crash contract).  ``train_step`` is not
    the scanned engine's seam: its captures and warm-up blocks call it too.
    """

    def __init__(self, step: int):
        self.step = int(step)
        self.steps_done = 0
        self.fired = False

    def install(self, trainer) -> "CrashAtStep":
        if trainer.engine.name == "scan":
            self._install_scan(trainer.engine)
        else:
            self._install_host(trainer)
        return self

    def _install_host(self, trainer) -> None:
        inner = trainer.train_step

        def bomb(*args, **kwargs):
            if not self.fired and self.steps_done >= self.step:
                self.fired = True
                raise ChaosError(
                    f"injected crash before train step {self.steps_done}")
            self.steps_done += 1
            return inner(*args, **kwargs)

        trainer.train_step = bomb

    def _install_scan(self, engine) -> None:
        inner = engine._dispatch

        def bomb(size: int, weighted: bool):
            if not self.fired and self.steps_done + size > self.step:
                self.fired = True
                raise ChaosError(
                    f"injected crash before the block covering step "
                    f"{self.step} (at step {self.steps_done})")
            self.steps_done += size
            return inner(size, weighted)

        engine._dispatch = bomb


class PoisonedDataset:
    """A dataset whose float features are NaN for the chosen sample ids.

    Both access paths are poisoned, ``get`` (the host loop) and ``arrays``
    (the scanned engine's device-resident copy, ``Trainer.device_data``),
    so either engine sees the same corruption.  Integer arrays (labels) are
    left intact: NaN has no integer form.
    """

    def __init__(self, base, sample_ids: Sequence[int]):
        self.base = base
        self.ids = np.asarray(sorted(int(i) for i in sample_ids))

    @property
    def num_samples(self) -> int:
        return self.base.num_samples

    def __getattr__(self, name: str) -> Any:
        return getattr(self.base, name)

    def _poison(self, batch: dict, mask: np.ndarray) -> dict:
        out = dict(batch)
        for k, v in out.items():
            arr = np.asarray(v)
            if np.issubdtype(arr.dtype, np.floating) and mask.any():
                arr = np.array(arr)
                arr[mask] = np.nan
                out[k] = arr
        return out

    def get(self, indices) -> dict:
        idx = np.asarray(indices)
        return self._poison(self.base.get(indices), np.isin(idx, self.ids))

    def arrays(self) -> dict:
        mask = np.zeros(self.num_samples, bool)
        mask[self.ids] = True
        return self._poison(dict(self.base.arrays()), mask)


def poison_samples(dataset, sample_ids: Sequence[int]) -> PoisonedDataset:
    """NaN the features of ``sample_ids`` in every access path."""
    return PoisonedDataset(dataset, sample_ids)


def corrupt_checkpoint_leaf(directory: str, step: int | None = None,
                            leaf: int = 0, seed: int = 0,
                            num_flips: int = 8) -> str:
    """Flip payload bytes of a committed leaf (seeded, in place); the
    ``COMMITTED`` marker and the manifest stay, so only the CRC can tell.
    ``step=None`` takes the newest committed step.  Returns the path."""
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}",
                        f"leaf_{leaf:05d}.npy")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    rng = np.random.default_rng(seed)
    # Past the ~128-byte .npy header: a garbled header is an unreadable
    # leaf, a garbled payload silent bit-rot, which the CRC must catch.
    lo = min(128, max(len(data) - 1, 0))
    for pos in rng.integers(lo, len(data), size=num_flips):
        data[pos] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


@contextlib.contextmanager
def failing_leaf_writes(fail: int = 1, exc: type[Exception] = OSError,
                        message: str = "injected I/O failure"):
    """Make the checkpoint writer's single-leaf seam (``_write_leaf``) fail:
    the first ``fail`` leaf writes raise ``exc``, later ones go through
    (``fail=-1`` fails forever).  Yields the call counter."""
    inner = ckpt._write_leaf
    calls = {"n": 0}

    def flaky(path, arr):
        calls["n"] += 1
        if fail < 0 or calls["n"] <= fail:
            raise exc(message)
        inner(path, arr)

    ckpt._write_leaf = flaky
    try:
        yield calls
    finally:
        ckpt._write_leaf = inner


class SlowShard:
    """Per-epoch latencies with one straggling worker: every worker reports
    ``base`` except ``rank``, which reports ``base * factor`` from epoch
    ``from_epoch`` on (a ``Trainer.shard_latency_fn``)."""

    def __init__(self, world_size: int, rank: int, factor: float = 4.0,
                 base: float = 1.0, from_epoch: int = 0):
        self.world_size = world_size
        self.rank = rank
        self.factor = factor
        self.base = base
        self.from_epoch = from_epoch

    def __call__(self, epoch: int) -> list[float]:
        lat = [self.base] * self.world_size
        if epoch >= self.from_epoch:
            lat[self.rank] = self.base * self.factor
        return lat
