"""Fused parameter sweeps: many samplings advanced as one."""
from .sweep import ParamSweep, VmcSweep

__all__ = ["ParamSweep", "VmcSweep"]
