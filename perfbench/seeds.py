"""Seeds of one run, all derived from ``--seed``: a whole number of any
size, so the driver's large seeds are taken as they come."""

from __future__ import annotations

import numpy as np

WEIGHTS, BATCHES, DROPOUT, REQUESTS, CLIENTS, SAMPLE, NORM = range(7)


def derive(seed: int, *stream: int) -> int:
    """A 63-bit seed for ``stream`` of run ``seed``."""
    key = [int(seed) & (2 ** 64 - 1), int(seed) >> 64] + [int(s) for s in stream]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
               >> np.uint64(1))
