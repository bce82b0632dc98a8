"""Sub-seeds of a run's ``--seed``, one per purpose, so that the weights,
the traffic and the sample of checked requests do not share a stream.
Any whole number is taken, seeds past 2**31 too."""
from __future__ import annotations

import numpy as np

PURPOSES = ("weights", "traffic", "sample")


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose``, a function of ``seed`` alone."""
    if purpose not in PURPOSES:
        raise ValueError(f"sub_seed: unknown purpose {purpose!r}")
    seed = int(seed) % 2 ** 64
    words = [seed & 0xFFFFFFFF, seed >> 32, PURPOSES.index(purpose)]
    return int(np.random.SeedSequence(words).generate_state(
        2, dtype=np.uint32).astype(np.uint64) @ np.array(
            [1, 2 ** 32], dtype=np.uint64)) >> 1
