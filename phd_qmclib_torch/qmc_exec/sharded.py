"""Procedures on a walker mesh: one process per device.

The JAX package runs a sharded procedure as one program over its mesh.
Here :func:`exec_on_mesh` runs the procedure's block loop on every rank
of a :func:`phd_qmclib_torch.parallel.launch`: each rank steps its shard
and folds the same psummed block data into its own accumulator, and only
rank 0 logs, writes files and calls the checkpoint hook.  The input
crosses into the spawned ranks as NumPy arrays; each rank puts it on its
device.  Rank 0, in the caller's process, returns the result.
"""
import dataclasses
import warnings

import numpy as np
import torch

from ..parallel import mesh as mesh_mod
from .logging import exec_logger

__all__ = ["exec_on_mesh", "from_host", "mesh_spec", "silence", "to_host"]


def mesh_spec(num_mesh_devices, device):
    """The walker mesh of a procedure's ``num_mesh_devices`` on
    ``device``'s kind (``None`` unsharded, 0 every device): ranks on
    ``cuda:0..n-1`` over NCCL, or on the CPU over gloo."""
    if num_mesh_devices is None:
        return None
    return mesh_mod.make_walker_mesh(num_mesh_devices or None,
                                     torch.device(device).type)


def _array(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else value


def to_host(proc_io):
    """A procedure's input or result with its state (and a resume
    payload's accumulators) as NumPy arrays: what another process can
    unpickle."""
    state = proc_io.state
    fields = {"state": type(state)(*(_array(x) for x in state))}
    resume = getattr(proc_io, "resume", None)
    if resume is not None and "aux" in resume:
        fields["resume"] = dict(resume, aux={
            name: _array(value) for name, value in resume["aux"].items()})
    return dataclasses.replace(proc_io, **fields)


def from_host(proc_io, device):
    """:func:`to_host`'s input or result with its state on ``device``."""
    state = proc_io.state
    state = type(state)(*(None if x is None else
                          torch.as_tensor(np.asarray(x)).to(device)
                          for x in state))
    return dataclasses.replace(proc_io, state=state)


def silence(mesh) -> None:
    """Rank 0 speaks for the run: the other ranks neither log nor
    warn."""
    if mesh.rank:
        exec_logger.disabled = True
        warnings.simplefilter("ignore")


def _exec_rank(mesh, proc, host_input, hooked: bool, checkpoint_hook=None):
    silence(mesh)
    if hooked and checkpoint_hook is None:
        # Every rank takes part in a checkpoint's gathers; rank 0 holds
        # the hook.
        def checkpoint_hook(_):
            pass
    result = proc._exec(from_host(host_input, mesh.device), checkpoint_hook,
                        mesh)
    return result if mesh.rank == 0 else None


def exec_on_mesh(proc, proc_input, spec: "mesh_mod.MeshSpec",
                 checkpoint_hook=None):
    """``proc._exec(proc_input, checkpoint_hook, mesh)`` on every rank of
    ``spec``; rank 0's result (``checkpoint_hook`` is called there
    only)."""
    exec_logger.info(f"Running on a walker mesh of {spec.size} ranks "
                     f"({spec.backend}: {', '.join(spec.devices)})...")
    return mesh_mod.launch(_exec_rank, spec, proc, to_host(proc_input),
                           checkpoint_hook is not None,
                           rank0_kwargs={"checkpoint_hook": checkpoint_hook})
