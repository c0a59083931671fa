"""The random draws of a step, worked out again from the seed.

The samplers draw their uniforms from a ``torch.Generator`` on the
device, one stream per block, seeded from ``(rng_seed, block index)``
through ``numpy.random.SeedSequence`` (the same function as
``phd_qmclib_torch.utils.block_seed``, written out here).  Within a
block every step draws in the same order, so step ``t``'s draws are the
``t + 1``-th of the stream:

* DMC: the comb's uniforms ``(Wm,)`` per step (the noise is Philox,
  :mod:`.philox`);
* VMC with uniform moves: the moves ``(W, N)``, then the acceptance
  uniforms ``(W,)``; with Gaussian moves only the acceptance uniforms
  (the moves are Philox normals).
"""
import numpy as np
import torch

from . import philox

__all__ = ["block_seed", "dmc_comb_uniforms", "vmc_draws"]


def block_seed(rng_seed: int, block_index: int) -> int:
    ss = np.random.SeedSequence([int(rng_seed), int(block_index)])
    return int(ss.generate_state(1, dtype=np.uint64)[0])


def _generator(seed: int, block_index: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, block_index))
    return gen


def dmc_comb_uniforms(seed: int, block_index: int, step: int, slots: int,
                      dtype, device) -> torch.Tensor:
    """The comb's uniforms of step ``step`` of block ``block_index``."""
    gen = _generator(seed, block_index, device)
    for _ in range(step + 1):
        u = torch.rand((slots,), generator=gen, dtype=dtype, device=device)
    return u


def vmc_draws(seed: int, block_index: int, step: int, shape, dtype, device,
              gaussian: bool, steps_per_block: int):
    """``(unit_moves, u)`` of step ``step``: the moves before the move
    spread (``rand - 1/2``, or a standard normal), and the acceptance
    uniforms."""
    gen = _generator(seed, block_index, device)
    for _ in range(step + 1):
        if not gaussian:
            moves = torch.rand(shape, generator=gen, dtype=dtype,
                               device=device)
        u = torch.rand(shape[:1], generator=gen, dtype=dtype, device=device)
    if gaussian:
        unit = philox.normals(seed, block_index * steps_per_block + step,
                              shape, torch.float64, device)
    else:
        unit = moves.double() - 0.5
    return unit, u
