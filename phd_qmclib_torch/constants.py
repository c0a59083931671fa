"""Unit system of the multi-rod QMC framework.

The magnitude of the reference unit of energy is one, and all other
constants derive from it.  Copy of ``phd_qmclib_tpu.constants``.
"""
import math

#: Unit of energy.
UE: float = 1.0

#: Lattice recoil energy (in units of ``UE``).
ER: float = math.pi ** 2 * UE

#: Unit of length: the lattice period.
LKP: float = 1.0

#: The wavevector of the optical lattice.
K_OPT: float = math.pi / LKP
