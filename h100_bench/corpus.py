"""The synthetic LM corpus, made from the seed in a few array calls.

The semantics of ``repro_torch/data/synthetic.py::SyntheticLM`` (a
first-order Markov source over ``vocab`` tokens, a per-sample difficulty
that is the share of uniform noise tokens: easy samples U[0, 0.15], hard
ones U[0.4, 0.9]), drawn for all samples at once instead of a sample at a
time, so the same seed gives the same corpus but not SyntheticLM's bytes.
The corpus lives in host memory; ``get`` indexes it, as the program's
datasets do, and ``arrays`` hands the scanned engine the whole of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Corpus:
    tokens: np.ndarray       # (N, S + 1) int32
    difficulty: np.ndarray   # (N,) float32
    vocab: int

    @property
    def num_samples(self) -> int:
        return self.tokens.shape[0]

    def arrays(self) -> dict:
        seq = self.tokens
        return {"tokens": np.ascontiguousarray(seq[:, :-1]),
                "labels": np.ascontiguousarray(seq[:, 1:]),
                "mask": np.ones((seq.shape[0], seq.shape[1] - 1), bool)}

    def get(self, indices) -> dict:
        """Host batch: tokens (B, S) i32, labels (B, S) i32 (the tokens
        shifted by one), mask (B, S) bool."""
        seq = self.tokens[np.asarray(indices)]
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:],
                "mask": np.ones((seq.shape[0], seq.shape[1] - 1), bool)}


def make(seq: np.random.SeedSequence, num_samples: int, seq_len: int,
         vocab: int, easy_fraction: float, order: int = 1) -> Corpus:
    """``num_samples`` sequences of ``seq_len + 1`` tokens from ``seq``."""
    if order != 1:
        raise ValueError(f"corpus order {order}: only a first-order source "
                         "is defined")
    rng = np.random.default_rng(seq)
    n, s = num_samples, seq_len + 1
    table = rng.integers(0, vocab, vocab).astype(np.int32)
    easy = rng.random(n) < easy_fraction
    difficulty = np.where(easy, rng.uniform(0.0, 0.15, n),
                          rng.uniform(0.4, 0.9, n)).astype(np.float32)
    noise = rng.random((n, s)) < difficulty[:, None]
    noise_tok = rng.integers(0, vocab, (n, s)).astype(np.int32)
    tokens = np.empty((n, s), np.int32)
    tokens[:, 0] = noise_tok[:, 0]
    for t in range(1, s):
        tokens[:, t] = np.where(noise[:, t], noise_tok[:, t],
                                table[tokens[:, t - 1]])
    return Corpus(tokens, difficulty, vocab)
