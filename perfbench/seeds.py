"""Seeds derived from a run's ``--seed``: any whole number, more bits than
32 included, gives independent streams, one per purpose."""

from __future__ import annotations

import numpy as np


def derive(seed: int, *tags: int) -> int:
    """A 64-bit seed for the stream named by ``tags`` (small whole numbers)
    of run seed ``seed``."""
    words = [int(seed) & (2**64 - 1), *(int(t) for t in tags)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def derive32(seed: int, *tags: int) -> int:
    """:func:`derive` cut to the 32 bits ``numpy.random.RandomState``
    takes."""
    return derive(seed, *tags) & 0xFFFFFFFF


# Stream tags: one per purpose, so no two purposes share numbers.
CORPUS, QUERIES, SAMPLE = 1, 2, 3
