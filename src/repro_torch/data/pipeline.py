"""Host-side batch assembly.

A copy of ``repro/data/pipeline.py::{epoch_index_plan, Pipeline,
materialize}``: maps an epoch's global sample indices to batches, padding
the trailing partial batch by cycling from the front of the (already
shuffled) epoch, and assembles a whole dataset once for the scanned
engine's device-resident copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np


def epoch_index_plan(indices: np.ndarray, batch_size: int,
                     pad_final: bool = True) -> np.ndarray:
    """The epoch's batch layout as one ``(num_steps, batch_size)`` array.

    Full batches in order, then (with ``pad_final``) the trailing partial
    batch padded by cycling from the front of the epoch — so within a row no
    index repeats.  An index list shorter than one batch yields a
    ``(0, batch_size)`` plan.
    """
    bs = batch_size
    n_full = len(indices) // bs
    rows = [np.asarray(indices[: n_full * bs]).reshape(n_full, bs)]
    rem = len(indices) - n_full * bs
    if rem and pad_final and len(indices) >= bs:
        rows.append(np.concatenate(
            [indices[n_full * bs :], indices[: bs - rem]])[None])
    return np.concatenate(rows, axis=0) if len(rows) > 1 else rows[0]


def materialize(get_fn: Callable[[np.ndarray], dict], num_samples: int,
                chunk: int = 4096) -> dict:
    """The whole dataset as host arrays, assembled in ``chunk``-row pieces
    (which bound the transient memory of a generator-style ``get``).  Every
    dataset whose rows are per-index deterministic (the ``get`` contract)
    can be materialised once and then batched by a gather on the device."""
    parts = []
    for start in range(0, num_samples, chunk):
        parts.append(get_fn(np.arange(start, min(start + chunk, num_samples))))
    if len(parts) == 1:
        return parts[0]
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]}


@dataclasses.dataclass
class Pipeline:
    """Yields ``(indices, dataset.get(indices))`` along ``epoch_index_plan``."""

    get_fn: Callable[[np.ndarray], dict]    # dataset.get
    batch_size: int
    pad_final: bool = True

    def batches(self, indices: np.ndarray) -> Iterator[tuple[np.ndarray, dict]]:
        for idx in epoch_index_plan(np.asarray(indices), self.batch_size,
                                    self.pad_final):
            yield idx, self.get_fn(idx)
