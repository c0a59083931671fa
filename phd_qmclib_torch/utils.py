"""Foundation utilities: RNG seeding.

Counterpart of ``phd_qmclib_tpu.utils`` (``get_random_rng_seed`` only).
"""
import os
import time

import numpy as np

__all__ = ["get_random_rng_seed"]

#: Maximum seed value (uint32 range).
MAX_SEED = 2 ** 32 - 1


def get_random_rng_seed() -> int:
    """Derive a per-process pseudo-random seed.

    Mixes the process id and the current time, hashed through
    ``numpy.random.SeedSequence`` for better avalanche behavior.
    """
    pid = os.getpid()
    time_ns = time.time_ns()
    ss = np.random.SeedSequence([pid, time_ns & MAX_SEED])
    return int(ss.generate_state(1)[0])
