"""Every number a run draws comes from ``--seed`` through here: one
``numpy.random.SeedSequence`` of the seed (any whole number, also past 64
bits), a child stream a use."""
from __future__ import annotations

import numpy as np

#: The uses, in a fixed order: each gets the same child of a seed in
#: every run.
USES = ("corpus", "weights", "program")


def child(seed: int, use: str) -> np.random.SeedSequence:
    """The seed sequence of ``use`` under ``seed``."""
    return np.random.SeedSequence(int(seed)).spawn(len(USES))[USES.index(use)]


def int_seed(seq: np.random.SeedSequence, bits: int = 62) -> int:
    """A non-negative integer of at most ``bits`` bits from ``seq``."""
    words = seq.generate_state(2, np.uint32)
    return ((int(words[0]) << 32) | int(words[1])) & ((1 << bits) - 1)
