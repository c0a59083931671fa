"""Fused parameter sweeps: R samplings that share their static structure
advance as one R x W-walker batch on one device (or, on a mesh, each on
ranks of its own).

Counterpart of ``phd_qmclib_tpu.parallel.sweep`` without its mesh: each
row runs an independent sampling with its own model parameters (one
coupling per row of an equation-of-state scan, a time step, a
supercell, a seed), and every step of every row goes through one launch
of each kernel:

* the pair kernel (K1, and its log|psi| variant in VMC) reads each
  walker's parameters from a ``(R, 16)`` table, row ``w / Wm``;
* the normals kernel (K2) fills ``(R, Wm, N)``, row ``r`` keyed by its
  own ``(rng_seed_r, step)`` and scaled by its own sigma;
* the histogram kernel (K4) bins each row with its own width, which
  follows its supercell.

Each row reproduces its standalone run (``Sampling.blocks`` with the
same seed), bit for bit: the samplers' steps are written for R rows,
and a standalone sampling is the sweep of one row.  Rows share the
static structure (boson number, defect layout, ideal/free flags, buffer
sizes, estimator specs), enforced at construction.  A sweep that
underfills the card alone (a row of a few thousand walkers) batches
into one wide dispatch per step.

With a ``mesh`` of ``(R, W)`` ranks (``parallel.make_walker_mesh(...,
rows=R)``) the rows spread over the ranks instead, as the JAX package's
``(sweep, walkers)`` mesh does: rank ``(r, w)`` steps row ``r``'s walker
shard ``w``, its collectives over the row's own group, so that each row
is its standalone W-shard run bit for bit (W = 1: its unsharded run).
No rebalancing runs under a sweep.
"""
import typing as t
from dataclasses import dataclass

import numpy as np
import torch

from ..samplers import dmc, vmc
from ..samplers.dmc import SamplingBlock, State

__all__ = ["ParamSweep", "VmcSweep"]

def _stack(states):
    """Per-row states stacked on a leading row axis."""
    return type(states[0])(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*states)))


@dataclass(frozen=True)
class ParamSweep:
    """A stack of DMC samplings advanced as one fused batch.

    ``samplings`` must share static structure; leaf parameters, the
    time step, the control factor, the walker target's value and the
    seed may differ per row.  With ``mesh=None`` the rows fuse on one
    device; a ``MeshSpec`` of one sweep row per sampling is checked here
    as the JAX package checks its mesh, and
    ``phd_qmclib_torch.qmc_exec.sweep.SweepProc`` runs the rows on it.
    """
    samplings: t.Tuple[dmc.Sampling, ...]
    mesh: t.Optional[t.Any] = None

    def __post_init__(self):
        if not self.samplings:
            raise ValueError("need at least one sampling")
        ref = self.samplings[0]
        static = ref.model_spec.static_spec
        for s in self.samplings[1:]:
            if s.model_spec.static_spec != static:
                raise ValueError(
                    "all sweep rows must share the model's static "
                    f"structure; got {s.model_spec.static_spec} vs "
                    f"{static}")
            if (s.max_num_walkers != ref.max_num_walkers
                    or s.target_num_walkers != ref.target_num_walkers):
                raise ValueError("all sweep rows must use the same "
                                 "walker-buffer sizes")
            if (s.density_est_spec != ref.density_est_spec
                    or s.ssf_est_spec != ref.ssf_est_spec
                    or s.obd_est_spec != ref.obd_est_spec
                    or s.pair_corr_est_spec != ref.pair_corr_est_spec
                    or s.itc_est_spec != ref.itc_est_spec
                    or s.est_every != ref.est_every
                    or s.cm_diffusion_est != ref.cm_diffusion_est
                    or s.cm_window_blocks != ref.cm_window_blocks):
                raise ValueError("all sweep rows must use the same "
                                 "estimator specs")
            if s.ref_compat != ref.ref_compat:
                raise ValueError("all sweep rows must use the same "
                                 "ref_compat")
        if self.mesh is None:
            return
        if self.mesh.rows != len(self.samplings):
            raise ValueError(
                f"mesh 'sweep' axis size {self.mesh.rows} != number of "
                f"sweep rows {len(self.samplings)}")
        n_w = self.mesh.size // self.mesh.rows
        if ref.max_num_walkers % n_w or ref.target_num_walkers % n_w:
            raise ValueError("walker buffers must divide the 'walkers' "
                             f"axis size ({n_w})")

    @property
    def num_rows(self) -> int:
        return len(self.samplings)

    def build_states(self, sys_conf_sets: t.Sequence[np.ndarray],
                     dtype=None, device="cuda") -> State:
        """Stack per-row initial states (each row's
        ``Sampling.build_state`` on ``device``) into one state with a
        leading row axis."""
        if len(sys_conf_sets) != self.num_rows:
            raise ValueError("one configuration set per sweep row")
        return _stack([s.build_state(confs, dtype=dtype, device=device)
                       for s, confs in zip(self.samplings, sys_conf_sets)])

    def blocks(self, ini_state: State, num_time_steps_block: int,
               burn_in_blocks: int = 0,
               block_offset: int = 0,
               start_block_idx: int = 0,
               aux_init: t.Optional[dict] = None) \
            -> t.Iterator[SamplingBlock]:
        """Yield stacked :class:`SamplingBlock` objects: the per-step
        properties ``(nts, R)`` (a trailing row axis, as the JAX
        package's), every estimator array, the last state and the
        carried accumulators with a leading row axis.  Every step of
        every row is one batch on the device.

        Each row's random streams derive from its own ``rng_seed``,
        exactly its standalone run's, so a fused row reproduces
        ``Sampling.blocks`` of its sampling bit for bit.  Rows sharing a
        seed share a stream: give the rows distinct seeds to decorrelate
        them.  ``burn_in_blocks``, ``block_offset``, ``start_block_idx``
        and ``aux_init`` (with a leading row axis) are those of
        ``Sampling.blocks``: the burn-in runs the dynamics only, the ITC
        fill restarts after it, and the CM windows and forward-walking
        windows open at the standalone run's blocks.
        """
        if self.mesh is not None:
            raise ValueError("a sweep on a mesh runs through "
                             "qmc_exec.sweep.SweepProc, each row on its "
                             "ranks")
        ref = self.samplings[0]
        consts = dmc._row_consts(self.samplings, ini_state.pos.dtype,
                                 ini_state.pos.device)
        for props, rows, state, carry in ref._row_blocks(
                consts, ini_state, num_time_steps_block, burn_in_blocks,
                block_offset, start_block_idx, aux_init):
            yield SamplingBlock(
                props, rows.get("density"), rows.get("ssf"), state,
                iter_obd=rows.get("obd"), iter_cmd=rows.get("cmd"),
                iter_g2=rows.get("g2"), iter_itc=rows.get("itc"),
                iter_itc_nw=rows.get("itc_nw"), aux_carry=carry)

    def replay_states(self, ini_state: State, comb_u,
                      diffusion_noise) -> t.Dict[str, torch.Tensor]:
        """The fused step under injected draws: the comb uniforms
        ``comb_u (nts, R, Wm)`` and the pre-scaled displacements
        ``diffusion_noise (nts, R, Wm, N)``.  Returns what
        ``Sampling.replay_states`` does, each tensor with a row axis
        after the step axis (``parent`` indexing within its row)."""
        dtype, device = ini_state.pos.dtype, ini_state.pos.device
        return self.samplings[0]._replay(
            dmc._row_consts(self.samplings, dtype, device), ini_state,
            torch.as_tensor(comb_u, dtype=dtype, device=device),
            torch.as_tensor(diffusion_noise, dtype=dtype, device=device))


@dataclass(frozen=True)
class VmcSweep:
    """A stack of VMC samplings advanced as one fused batch on one
    device: R rows whose model specs share static structure (couplings,
    variational cutoffs and move spreads may differ) batch into one R x
    W-chain workload per step."""
    samplings: t.Tuple[vmc.Sampling, ...]

    def __post_init__(self):
        if not self.samplings:
            raise ValueError("need at least one sampling")
        ref = self.samplings[0]
        for s in self.samplings[1:]:
            if s.model_spec.static_spec != ref.model_spec.static_spec:
                raise ValueError(
                    "all sweep rows must share the model's static "
                    "structure")
            if (s.num_walkers != ref.num_walkers
                    or s.gaussian != ref.gaussian
                    or s.ssf_est_spec != ref.ssf_est_spec
                    or s.obd_est_spec != ref.obd_est_spec
                    or s.pair_corr_est_spec != ref.pair_corr_est_spec
                    or s.est_every != ref.est_every):
                raise ValueError("all sweep rows must share chain count "
                                 "and estimator specs")

    @property
    def num_rows(self) -> int:
        return len(self.samplings)

    def build_states(self, sys_conf_sets: t.Sequence[np.ndarray],
                     dtype=None, device="cuda") -> vmc.State:
        """Stack per-row initial states (leading axis = sweep row)."""
        if len(sys_conf_sets) != self.num_rows:
            raise ValueError("one configuration set per sweep row")
        return _stack([s.build_state(confs, dtype=dtype, device=device)
                       for s, confs in zip(self.samplings, sys_conf_sets)])

    def blocks(self, num_steps_block: int, ini_state: vmc.State,
               block_offset: int = 0) -> t.Iterator[vmc.SamplingBlock]:
        """Yield stacked blocks: every array with a leading row axis
        (the properties ``(R, nts, W)``), ``accept_rate`` an ``(R,)``
        array.  Each row's random streams derive from its own
        ``rng_seed``: a fused row reproduces its standalone run bit for
        bit."""
        ref = self.samplings[0]
        consts = vmc._row_consts(self.samplings, ini_state.pos.dtype,
                                 ini_state.pos.device)
        for _, props, rows, rates, state in ref._row_blocks(
                consts, ini_state, num_steps_block, block_offset, 0):
            yield vmc.SamplingBlock(props, rows.get("ssf"), np.asarray(rates),
                                    state, rows.get("obd"), rows.get("g2"))

    def replay_chain(self, ini_state: vmc.State, moves_u, accept_u):
        """The fused step under injected draws: the move uniforms (or,
        with ``gaussian``, the pre-scaled displacements) ``moves_u (nts,
        R, W, N)`` and the Metropolis uniforms ``accept_u (nts, R, W)``.
        Returns what ``Sampling.replay_chain`` does, each tensor with a
        row axis after the step axis."""
        dtype, device = ini_state.pos.dtype, ini_state.pos.device
        return self.samplings[0]._replay(
            vmc._row_consts(self.samplings, dtype, device), ini_state,
            torch.as_tensor(moves_u, dtype=dtype, device=device),
            torch.as_tensor(accept_u, dtype=dtype, device=device))
