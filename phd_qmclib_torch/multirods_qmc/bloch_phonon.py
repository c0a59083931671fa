"""Legacy alias: the multi-rod Bloch-phonon model under its old name.

Re-exports the mrbp model API, as ``phd_qmclib_tpu.multirods_qmc.
bloch_phonon`` does.
"""
from ..models.mrbp import (  # noqa: F401
    CFCParams, ModelParams, OBFParams, PhysicalFuncs, Spec, StaticSpec,
    SysConfDistType, SysConfSlot, TBFParams, core_funcs, DIST_RAND,
    DIST_REGULAR,
)
from ..samplers import dmc, vmc  # noqa: F401
