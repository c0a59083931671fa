"""Several devices and fused sweeps: walker meshes (one process per
device) and many samplings advanced as one."""
from .mesh import MeshSpec, WalkerMesh, launch, make_walker_mesh
from .sweep import ParamSweep, VmcSweep

__all__ = ["MeshSpec", "ParamSweep", "VmcSweep", "WalkerMesh", "launch",
           "make_walker_mesh"]
