"""Foundation utilities: RNG seeding.

Counterpart of ``phd_qmclib_tpu.utils`` (``get_random_rng_seed`` and
``now``), plus the per-block seeds of the samplers' ``torch.Generator`` streams.
"""
import os
import time
import typing as t
from datetime import datetime, timezone

import numpy as np
import torch

__all__ = ["block_seed", "get_random_rng_seed", "now", "numpy_dtype",
           "shard_key", "torch_dtype"]

#: Maximum seed value (uint32 range).
MAX_SEED = 2 ** 32 - 1


def now() -> datetime:
    """Current date and time, timezone-aware (UTC offset of the host)."""
    return datetime.now(timezone.utc).astimezone()


def get_random_rng_seed() -> int:
    """Derive a per-process pseudo-random seed.

    Mixes the process id and the current time, hashed through
    ``numpy.random.SeedSequence`` for better avalanche behavior.
    """
    pid = os.getpid()
    time_ns = time.time_ns()
    ss = np.random.SeedSequence([pid, time_ns & MAX_SEED])
    return int(ss.generate_state(1)[0])


def block_seed(rng_seed: int, block_index: int,
               shard: t.Optional[int] = None) -> int:
    """Seed of a sampler's random stream in one block: a pure function of
    ``(rng_seed, block_index)``, so that a run continued from block ``b``
    draws what the whole run would have drawn.  A walker shard of a mesh
    draws its own stream, ``(rng_seed, block_index, shard)``."""
    entropy = [rng_seed, block_index] + ([] if shard is None else [shard])
    ss = np.random.SeedSequence(entropy)
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def shard_key(rng_seed: int, shard: int) -> int:
    """The diffusion-noise key of a walker shard of a mesh: a pure
    function of ``(rng_seed, shard)`` (an unsharded run keys its noise by
    ``rng_seed`` itself)."""
    ss = np.random.SeedSequence([rng_seed, shard])
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype
