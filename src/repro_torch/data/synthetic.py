"""Synthetic datasets with a controlled easy/hard split.

A copy of ``repro/data/synthetic.py`` (the port imports nothing of the JAX
package).  It makes the same numpy RNG calls in the same order, so both
packages see byte-identical samples for a seed.  Each sample has a
difficulty in [0, 1]:

* ``SyntheticClassification`` — class-template images plus noise whose
  magnitude grows with difficulty, so easy samples become confidently
  correct early (candidates for hiding) and hard ones keep a high loss.  A
  small label-noise fraction models an unlearnable tail (paper App. D).
* ``SyntheticLM`` — token sequences mixing a deterministic k-gram source
  with uniform noise tokens; the noise fraction is the difficulty.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.pipeline import materialize


@dataclasses.dataclass
class SyntheticClassification:
    num_samples: int = 4096
    num_classes: int = 10
    image_size: int = 16
    channels: int = 3
    easy_fraction: float = 0.6
    label_noise: float = 0.02
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n, c, hw = self.num_samples, self.num_classes, self.image_size
        self.templates = rng.normal(0, 1, (c, hw, hw, self.channels)).astype(np.float32)
        self.labels = rng.integers(0, c, n).astype(np.int64)
        # difficulty: easy ~ U[0, .3], hard ~ U[.5, 1]
        easy = rng.random(n) < self.easy_fraction
        self.difficulty = np.where(
            easy, rng.uniform(0.0, 0.3, n), rng.uniform(0.5, 1.0, n)
        ).astype(np.float32)
        self.noise_seed = rng.integers(0, 2**31, n)
        flip = rng.random(n) < self.label_noise
        self.true_labels = self.labels.copy()
        self.labels[flip] = rng.integers(0, c, flip.sum())
        self.is_noisy = flip

    def arrays(self, chunk: int = 4096) -> dict:
        """The whole dataset as host arrays (the scanned engine's
        device-resident copy).  Each image depends only on its own
        ``noise_seed``, so gathering rows from these arrays is byte-identical
        to ``get`` of the same indices."""
        return materialize(self.get, self.num_samples, chunk)

    def get(self, indices: np.ndarray) -> dict:
        """Host numpy batch: images (B, H, W, C) f32, labels (B,) i32."""
        imgs = np.empty((len(indices), self.image_size, self.image_size,
                         self.channels), np.float32)
        for i, idx in enumerate(indices):
            r = np.random.default_rng(int(self.noise_seed[idx]))
            d = self.difficulty[idx]
            imgs[i] = (self.templates[self.true_labels[idx]] * (1.0 - 0.5 * d)
                       + r.normal(0, 0.3 + 1.2 * d, imgs[i].shape))
        return {"images": imgs, "labels": self.labels[indices].astype(np.int32)}

    # held-out set: same class templates (same task), fresh samples/noise
    def test_split(self, num: int = 1024) -> "SyntheticClassification":
        ds = SyntheticClassification(
            num, self.num_classes, self.image_size, self.channels,
            self.easy_fraction, 0.0, self.seed + 10_000)
        ds.templates = self.templates
        return ds


@dataclasses.dataclass
class SyntheticLM:
    num_samples: int = 2048
    seq_len: int = 128
    vocab_size: int = 257
    easy_fraction: float = 0.6
    order: int = 3          # k-gram order of the deterministic source
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.num_samples
        # deterministic k-gram transition table
        self.table = rng.integers(
            0, self.vocab_size, (self.vocab_size,) * self.order).astype(np.int32)
        easy = rng.random(n) < self.easy_fraction
        self.difficulty = np.where(
            easy, rng.uniform(0.0, 0.15, n), rng.uniform(0.4, 0.9, n)
        ).astype(np.float32)
        self.sample_seed = rng.integers(0, 2**31, n)

    def _gen_one(self, idx: int) -> np.ndarray:
        r = np.random.default_rng(int(self.sample_seed[idx]))
        s = self.seq_len + 1
        seq = np.empty(s, np.int32)
        seq[: self.order] = r.integers(0, self.vocab_size, self.order)
        noise = r.random(s) < self.difficulty[idx]
        for t in range(self.order, s):
            if noise[t]:
                seq[t] = r.integers(0, self.vocab_size)
            else:
                seq[t] = self.table[tuple(seq[t - self.order : t])]
        return seq

    def arrays(self, chunk: int = 4096) -> dict:
        """The whole dataset as host arrays (see
        ``SyntheticClassification.arrays``); each sequence depends only on
        its own ``sample_seed``."""
        return materialize(self.get, self.num_samples, chunk)

    def get(self, indices: np.ndarray) -> dict:
        """Host numpy batch: tokens (B, S) i32, labels (B, S) i32 (the
        tokens shifted by one), mask (B, S) bool."""
        seqs = np.stack([self._gen_one(int(i)) for i in indices])
        return {
            "tokens": seqs[:, :-1],
            "labels": seqs[:, 1:].astype(np.int32),
            "mask": np.ones((len(indices), self.seq_len), bool),
        }

    def test_split(self, num: int = 512) -> "SyntheticLM":
        ds = SyntheticLM(num, self.seq_len, self.vocab_size,
                         self.easy_fraction, self.order, self.seed + 10_000)
        ds.table = self.table  # same source process, fresh samples
        return ds
