"""Periodic-boundary-condition geometry primitives.

Counterpart of ``phd_qmclib_tpu.ops.pbc``.  ``torch.round`` rounds half
to even like ``jnp.round``, and ``torch.remainder`` is the floor modulo
of ``jnp.mod``, so the results agree bit for bit.
"""
import torch

__all__ = ["min_image", "min_image_bounded", "recast_to_supercell", "sign"]


def sign(v: torch.Tensor) -> torch.Tensor:
    """Sign of ``v`` following ``copysign(1, v)`` semantics:
    ``sign(0) = +1``."""
    return torch.where(v >= 0, torch.ones_like(v), -torch.ones_like(v))


def min_image(z_ij: torch.Tensor, sc_size) -> torch.Tensor:
    """Minimum-image displacement for a supercell of size ``sc_size``:
    the representative in ``[-sc_size/2, sc_size/2)``."""
    sc_half = 0.5 * sc_size
    wrapped = -sc_half + torch.remainder(z_ij + sc_half, sc_size)
    return torch.where(z_ij.abs() > sc_half, wrapped, z_ij)


def min_image_bounded(z_ij: torch.Tensor, sc_size) -> torch.Tensor:
    """Minimum image for displacements already bounded to
    ``(-sc_size, sc_size)`` - differences of positions inside the
    supercell.

    At ``|z_ij| == sc_size/2`` exactly, round-half-to-even may pick the
    opposite image - the same physical pair distance.
    """
    return z_ij - sc_size * torch.round(z_ij / sc_size)


def recast_to_supercell(z: torch.Tensor, z_min, z_max) -> torch.Tensor:
    """Wrap a position into the supercell ``[z_min, z_max)``."""
    sc_size = z_max - z_min
    return z_min + torch.remainder(z - z_min, sc_size)
