"""Compute ops: PBC geometry, trig polynomials, and the wrappers of the
hand-written CUDA kernels with their plain torch versions."""
from . import pairwise, pbc, prng, trig  # noqa: F401
