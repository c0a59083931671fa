"""Rank functions of the mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_proc.py``).

Spawned ranks import these by module path, so this module holds no
tests and imports only torch, NumPy and the port: a child never imports
JAX.  Each function runs on every rank of a ``parallel.launch``; what
rank 0 returns is what the test sees, so the functions gather what the
test checks of the other ranks to rank 0.
"""
import dataclasses
import os
import types

import numpy as np
import torch

from phd_qmclib_torch.samplers import dmc


def _numpy(x):
    return None if x is None else x.detach().cpu().numpy()


def state_arrays(state) -> types.SimpleNamespace:
    """A state's fields as NumPy arrays, to send to the ranks."""
    return types.SimpleNamespace(**{name: _numpy(value) for name, value
                                    in state._asdict().items()})


def psum_ranks(mesh, values):
    """Rank ``k`` sums ``values[k]``; every rank's result, gathered."""
    mine = torch.as_tensor(values[mesh.rank])
    total = mesh.psum(mine)
    return [p.numpy() for p in mesh.all_gather(total)], \
        [p.numpy() for p in mesh.all_gather(mine)]


def fail_rank(mesh, how):
    """Rank 1 raises (or dies); the others wait in a collective."""
    if mesh.rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        os._exit(3)
    return mesh.psum(torch.ones(2))


def dmc_replay(mesh, sampling, state, comb_u, xi):
    """The sharded DMC step under injected global draws: the per-step
    scalars, the global post-diffusion ensemble (the shards in rank
    order) and the estimators' psummed rows."""
    sampling = dataclasses.replace(sampling, mesh=mesh)
    start = dmc.state_from_numpy(state, device="cpu")
    out = sampling.replay_states(start, comb_u, xi)
    pos = torch.stack([mesh.cat(p) for p in out["pos"]])
    weights = torch.stack([mesh.cat(w) for w in out["weights"]])
    est, _, last = sampling.replay_estimators(start, comb_u, xi)
    return ({name: out[name].numpy() for name in
             ("num_walkers", "energy", "weight", "ref_energy",
              "accum_energy")},
            pos.numpy(), weights.numpy(),
            {name: rows.numpy() for name, rows in est.items()},
            state_arrays(mesh.gather_state(last)))


def dmc_blocks(mesh, sampling, state, nts, num_blocks):
    """``num_blocks`` blocks of the sharded sampler from a global
    state: each block's props and estimator rows, and its last state's
    global view."""
    sampling = dataclasses.replace(sampling, mesh=mesh)
    blocks = sampling.blocks(dmc.state_from_numpy(state, device="cpu"), nts)
    out = []
    for _ in range(num_blocks):
        block = next(blocks)
        rows = {name: _numpy(getattr(block, f"iter_{name}"))
                for name in ("density", "ssf", "obd", "cmd", "g2", "itc",
                             "itc_nw")}
        out.append(({name: _numpy(value) for name, value
                     in block.iter_props._asdict().items()}, rows,
                    state_arrays(mesh.gather_state(block.last_state))))
    return out


def vmc_replay(mesh, sampling, pos, moves, accept):
    """Sharded VMC chains under injected global draws: every shard's
    chains (gathered in rank order), and one measured block's psummed
    estimator rows and acceptance rate from the same start."""
    sampling = dataclasses.replace(sampling, mesh=mesh)
    state = sampling.build_state(pos, device="cpu")
    out = sampling.replay_chain(state, moves, accept)
    chains = [np.stack([mesh.cat(step).numpy() for step in column])
              for column in out]
    block = next(sampling.blocks(4, state))
    rows = {name: _numpy(getattr(block, f"iter_{name}"))
            for name in ("ssf", "obd", "g2")}
    return (chains, rows, block.accept_rate,
            {name: _numpy(value) for name, value
             in block.iter_props._asdict().items()},
            _numpy(mesh.cat(block.last_state.pos)))

