"""Grad-Match baseline [18] (paper Sec. 4, the single-worker comparison).

Port of ``repro/core/gradmatch.py``.  Every R epochs, pick a per-class
subset whose weighted last-layer gradient sum matches the whole set's, by
orthogonal matching pursuit (OMP), and train on that subset with those
weights for the next R epochs.  As in the paper and the reference: last
layer only, classes apart, subset and weights frozen between reselections,
and a single-host method (the per-class gather is what makes Grad-Match
impractical for distributed training).

The OMP runs on the host in numpy, the reference's algorithm operation for
operation (``_omp_select``).  Its cost grows fast with the budget: each of
the ``budget`` picks of a class re-solves a ridge system over the picks so
far, so a class of c samples costs about the sum of k^3 for k up to
0.7 c, quartic in c.  The epoch shuffle of the frozen subset is a device
permutation from the sampler's own ``torch.Generator``
(``draw_permutation``, which the parity tests replace to inject the
reference's).  ``GradMatchSampler`` holds the plan (the reference's
low-level API) and ``GradMatchStrategy`` wraps it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import planops
from repro_torch.core.strategy import (EpochPlan, FeatsFn, SampleStrategy,
                                       inner_attr, register_strategy)
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass
class GradMatchConfig:
    fraction: float = 0.3     # keep 1 - fraction of the data
    interval: int = 5         # R: reselect every R epochs
    lam: float = 0.5          # OMP ridge regularizer


def _omp_select(G: np.ndarray, budget: int,
                lam: float) -> tuple[np.ndarray, np.ndarray]:
    """Greedy OMP: ``budget`` rows of ``G`` whose weighted sum matches
    ``G.sum(0)``.  G: (n, d) per-sample last-layer gradient features.
    Returns (indices, weights)."""
    n = G.shape[0]
    budget = min(budget, n)
    target = G.sum(axis=0)
    residual = target.copy()
    chosen: list[int] = []
    mask = np.zeros(n, bool)
    for _ in range(budget):
        scores = G @ residual
        scores[mask] = -np.inf
        j = int(np.argmax(scores))
        if not np.isfinite(scores[j]):
            break
        chosen.append(j)
        mask[j] = True
        A = G[chosen]  # (k, d)
        # ridge least squares: min ||A^T w - target||^2 + lam ||w||^2
        k = len(chosen)
        w = np.linalg.solve(A @ A.T + lam * np.eye(k), A @ target)
        residual = target - A.T @ w
    return (np.array(chosen, np.int64),
            np.maximum(np.array(w if chosen else []), 0.0))


def reselect(grad_feats: np.ndarray, labels: np.ndarray, num_classes: int,
             config: GradMatchConfig) -> tuple[np.ndarray, np.ndarray]:
    """One reselection over all classes: (subset, (N,) f32 weights).

    ``grad_feats``: (N, d) last-layer gradient proxies (``p - onehot(y)``).
    The subset's weights are scaled to mean 1 (the LR keeps its meaning);
    every other sample weighs 1.
    """
    keep_frac = 1.0 - config.fraction
    idx_all, w_all = [], []
    for c in range(num_classes):
        cls = np.nonzero(labels == c)[0]
        if len(cls) == 0:
            continue
        budget = max(1, int(round(keep_frac * len(cls))))
        sel, w = _omp_select(grad_feats[cls], budget, config.lam)
        idx_all.append(cls[sel])
        w_all.append(w)
    subset = np.concatenate(idx_all)
    w = np.concatenate(w_all).astype(np.float32)
    weights = np.ones(len(labels), np.float32)
    weights[subset] = w * (len(w) / max(w.sum(), 1e-8))
    return subset, weights


class GradMatchSampler:
    """The Grad-Match plan: ``maybe_reselect`` runs the OMP every R epochs
    on the host, ``begin_epoch`` shuffles the frozen subset."""

    def __init__(self, num_samples: int, num_classes: int,
                 config: GradMatchConfig | None = None, seed: int = 0,
                 device: str | torch.device | None = None):
        self.config = config or GradMatchConfig()
        self.n = num_samples
        self.num_classes = num_classes
        self.device = resolve_device(device)
        self._gen = planops.make_generator(seed, "gradmatch", self.device)
        self.subset = np.arange(num_samples)
        self.weights = np.ones(num_samples, np.float32)
        #: Host seconds spent in the OMP over the run (Table 3 reports it).
        self.omp_seconds = 0.0

    def maybe_reselect(self, epoch: int, grad_feats: np.ndarray,
                       labels: np.ndarray) -> bool:
        """Reselect at every R-th epoch from the (N, d) last-layer gradient
        proxies ``grad_feats`` (``p - onehot(y)``); whether it did."""
        if epoch % self.config.interval != 0:
            return False
        t0 = time.perf_counter()
        self.subset, self.weights = reselect(grad_feats, labels,
                                             self.num_classes, self.config)
        self.omp_seconds += time.perf_counter() - t0
        return True

    def draw_permutation(self) -> torch.Tensor:
        """This epoch's shuffle of the subset's positions, on the device."""
        return planops.device_permutation(self._gen, len(self.subset))

    def begin_epoch(self) -> np.ndarray:
        """The subset, shuffled (host)."""
        order = self.draw_permutation().cpu().numpy()   # the epoch's crossing
        return self.subset[order]

    def batches(self, epoch_indices: np.ndarray,
                batch_size: int) -> Iterator[np.ndarray]:
        for start in range(0, len(epoch_indices) - batch_size + 1, batch_size):
            yield epoch_indices[start : start + batch_size]


@register_strategy("gradmatch")
class GradMatchStrategy(SampleStrategy):
    """OMP subset selection over ``GradMatchSampler``; the features arrive
    through ``prepare``."""

    config_cls, config_field = GradMatchConfig, "gradmatch"
    subset = inner_attr()
    weights = inner_attr()
    omp_seconds = inner_attr()
    draw_permutation = inner_attr()

    def __init__(self, num_samples: int, config: GradMatchConfig | None = None,
                 seed: int = 0, num_classes: int | None = None,
                 device: str | torch.device | None = None):
        super().__init__(num_samples, config or GradMatchConfig(), seed)
        # num_classes may be left out while no reselection runs (registry
        # builds, runs without features); prepare() requires it the moment
        # features arrive, since a one-class OMP would change the method.
        self.num_classes = num_classes
        self._inner = GradMatchSampler(num_samples, num_classes or 1,
                                       self.config, seed, device)

    def prepare(self, epoch: int, feats_fn: FeatsFn | None = None) -> None:
        if feats_fn is None or epoch % self.config.interval != 0:
            return
        if self.num_classes is None:
            raise ValueError(
                "gradmatch needs num_classes for its per-class OMP: pass "
                "num_classes to make_strategy or the Trainer")
        feats, labels = feats_fn()
        self._inner.maybe_reselect(epoch, feats, labels)

    def plan(self, epoch: int) -> EpochPlan:
        return EpochPlan(epoch=epoch, visible_indices=self._inner.begin_epoch(),
                         host_syncs=1)

    def batch_weights(self, indices: np.ndarray) -> np.ndarray:
        return self._inner.weights[indices]

    def state_dict(self) -> dict:
        # The subset shrinks at a reselection; a checkpoint's leaves keep
        # their shape, so it is stored padded with -1 to N.
        inner = self._inner
        subset = np.full(self.num_samples, -1, np.int64)
        subset[:len(inner.subset)] = inner.subset
        return {"arrays": {"subset": subset, "weights": inner.weights,
                           "rng_key": planops.generator_state(inner._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        inner, a = self._inner, state["arrays"]
        subset = np.asarray(a["subset"], np.int64)
        inner.subset = subset[subset >= 0]
        inner.weights = np.array(a["weights"], np.float32)
        planops.restore_generator(inner._gen, state, self.seed, "gradmatch")
