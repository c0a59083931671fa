"""phd-qmclib-torch: the VMC and DMC samplers of ``phd_qmclib_tpu`` in
PyTorch.

A port of the JAX package to PyTorch and CUDA on an NVIDIA H100.  The
JAX package stays the reference: every module here has a counterpart
of the same name there, and the tests hold each one against it.

* Plain tensor code is PyTorch, on an explicit ``device``.
* Every Pallas kernel of the JAX package is hand-written CUDA C++
  (``csrc/``), built with ``nvcc`` at first use: the fused pair energy,
  drift and log|psi| and the fused diffusion step (``ops.pairwise``),
  the diffusion normals (``ops.prng``) and the per-walker histogram
  (``ops.histogram``).  On a CPU tensor each wrapper runs its plain
  PyTorch version instead.

The statistics and analysis layers (``stats``, ``analysis``,
``lieb_liniger``) are the port's own copies of the JAX package's NumPy
modules, so a machine without JAX can put error bars on what it
measures.

The execution layer (``qmc_exec``: the DMC and VMC procedures, their
block accumulators and result containers, the HDF5 handlers, the config
loader, the CLI application objects and the report of result files) and
``mrbp_cli`` turn a config file into a run on the GPU and a result file
that both packages read, and report it.  ``parallel`` fuses the rows of
a parameter sweep into one batch on the GPU (``qmc_exec.sweep`` runs
such a sweep's procedures, ``fused_sweep: true`` in a config), and
shards a run's walkers over several devices, one process each over a
``torch.distributed`` group (``num_mesh_devices``, ``fused_sweep_mesh``).

Importing the package needs neither a GPU, nor ``nvcc``, nor ``triton``,
nor ``h5py``, ``yaml``, ``jinja2`` or ``click`` (each is imported by the
function that needs it), and it never imports ``jax`` or
``phd_qmclib_tpu``.
"""
from . import (  # noqa: F401
    analysis, constants, ideal, lieb_liniger, models, ops, parallel,
    qmc_exec, samplers, stats, utils)

__version__ = "0.1.0"
