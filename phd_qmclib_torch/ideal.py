"""Ground-state energy of the ideal Bose gas in a Kronig-Penney lattice.

Solves the transcendental band-structure dispersion relation of the
multi-rod (Kronig-Penney) potential at zero quasi-momentum.  This is a
host-side (CPU) computation executed once when a model spec is built; the
result feeds the one-body Jastrow orbital parameters.

Copy of ``phd_qmclib_tpu.ideal``: a machine-precision root from
``scipy.optimize.brentq`` refined in arbitrary precision with ``mpmath``,
with an ``OverflowError`` fallback to the bracketing Illinois solver.
"""
import math
from functools import partial

from scipy.optimize import brentq

try:  # pragma: no cover - mpmath is expected to be available.
    import mpmath as mp

    _HAVE_MPMATH = True
except ImportError:  # pragma: no cover
    mp = None
    _HAVE_MPMATH = False

__all__ = ["band_energy", "effective_mass_ratio", "energy_relation",
           "eigen_energy"]


def energy_relation(lattice_depth: float,
                    lattice_ratio: float,
                    energy: float,
                    momentum: float,
                    ctx=math) -> float:
    """Dispersion relation of the ideal Bose gas in the KP lattice.

    Evaluates ``f(E; k) = 0``, the equation that relates the energy of the
    ideal Bose gas and the (quasi-)momentum of the bosons.

    :param lattice_depth: The potential magnitude ``v0``.
    :param lattice_ratio: The barrier-width / well-width ratio ``r``.
    :param energy: The energy ``E`` of the bosons.
    :param momentum: The quasimomentum ``k``.
    :param ctx: Math context (``math`` or ``mpmath``) so the same relation
        can be evaluated in machine or arbitrary precision.
    """
    v0 = lattice_depth
    r = lattice_ratio
    ez = energy
    ks = momentum

    sin, cos = ctx.sin, ctx.cos
    sinh, cosh = ctx.sinh, ctx.cosh
    sqrt = ctx.sqrt

    if ez == 0:
        return (1 / (2 * (1 + r)) * sqrt(v0) * sinh(r / (1 + r) * sqrt(v0))
                + cosh(r / (1 + r) * sqrt(v0)) - cos(ks))
    if ez == v0:
        return (-r * sqrt(v0) / (2 * (1 + r)) * sin(sqrt(v0) / (1 + r))
                + cos(sqrt(v0) / (1 + r)) - cos(ks))
    return ((v0 - 2 * ez) / (2 * sqrt(ez * (v0 - ez)))
            * sinh(r / (1 + r) * sqrt(v0 - ez)) * sin(sqrt(ez) / (1 + r))
            + cosh(r / (1 + r) * sqrt(v0 - ez)) * cos(sqrt(ez) / (1 + r))
            - cos(ks))


def eigen_energy(lattice_depth: float, lattice_ratio: float) -> float:
    """Ground-state energy per particle of the ideal KP Bose gas.

    :param lattice_depth: The magnitude ``v0`` of the external potential.
    :param lattice_ratio: The barrier/well width ratio ``r``.
    :return: The ground-state energy per boson (band bottom, ``k = 0``).
    """
    v0 = float(lattice_depth)
    r = float(lattice_ratio)

    upper = min(v0, (1 + r) ** 2 * math.pi ** 2)

    if not _HAVE_MPMATH:  # pragma: no cover - fallback path.
        func = partial(energy_relation, v0, r, momentum=0)
        return float(brentq(func, 0, upper, xtol=1e-15, rtol=1e-15))

    try:
        # First find a root with machine precision.
        func = partial(energy_relation, v0, r, momentum=0)
        root = brentq(func, 0, upper)
        mp_solver = partial(mp.findroot, verify=False)
    except OverflowError:
        # Use an arbitrary precision, root-bracketing method.
        root = (0, min(v0, (1 + r) ** 2 * mp.pi ** 2))
        mp_solver = partial(mp.findroot, solver='illinois', verify=False)

    func = partial(energy_relation, v0, r, momentum=0, ctx=mp)
    root = mp_solver(func, root)
    return float(mp.chop(root))


def band_energy(lattice_depth: float, lattice_ratio: float,
                momentum: float) -> float:
    """First-band energy ``E(k)`` of the KP lattice at quasimomentum
    ``k`` (in ``1/LKP`` units; the band spans ``k in [0, pi]``).

    Same dispersion relation as :func:`eigen_energy` (which is the
    ``k = 0`` band bottom) solved at finite ``k``; the exact
    effective-mass target of the center-of-mass-diffusion estimator.
    """
    import cmath

    v0 = float(lattice_depth)
    r = float(lattice_ratio)
    k = float(momentum)

    def func(ez):
        # cmath continues the relation above the barrier (E > v0),
        # where sqrt(v0 - E) turns imaginary but the relation stays
        # real (sinh(ix)/i = sin(x) etc.).
        return energy_relation(v0, r, ez, k, ctx=cmath).real

    upper = min(v0, (1 + r) ** 2 * math.pi ** 2)
    lo, hi = 1e-12, max(upper - 1e-12, 2e-12)
    # The first band rises from the k=0 bottom; widen the bracket
    # upward if the band crosses ``upper`` (shallow lattices, where
    # the band lives above the barrier).
    while func(lo) * func(hi) > 0:
        hi = lo + 2 * (hi - lo)
        if hi > 4 * (1 + r) ** 2 * math.pi ** 2:  # pragma: no cover
            raise ValueError("failed to bracket the first band")
    return float(brentq(func, lo, hi, xtol=1e-14, rtol=8.9e-16))


def effective_mass_ratio(lattice_depth: float, lattice_ratio: float,
                         dk: float = 1e-3) -> float:
    """Exact ``m/m*`` of the first KP band: half the band curvature at
    ``k = 0`` (free dispersion ``E = k^2`` has curvature 2, so the
    ratio is 1 without a lattice).  Central finite difference of
    :func:`band_energy`."""
    e0 = band_energy(lattice_depth, lattice_ratio, 0.0)
    # E(k) is even in k: E(dk) == E(-dk).
    e1 = band_energy(lattice_depth, lattice_ratio, dk)
    return (e1 - e0) / dk ** 2
