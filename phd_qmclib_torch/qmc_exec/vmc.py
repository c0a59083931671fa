"""VMC procedure: the variational run loop.

Counterpart of ``phd_qmclib_tpu.qmc_exec.vmc``, after the upstream
library's procedure (``qmc_exec/vmc/proc.py``) and its
concrete mrbp binding (``mrbp_qmc/vmc_exec/proc.py``), with a
walker-batch axis: ``num_walkers`` independent chains advance together,
and block statistics average over steps and chains.

The configuration is the JAX package's, key for key; the device is a
property of a run, and ``num_mesh_devices`` splits the chains over that
many devices, one process each (see :mod:`phd_qmclib_torch.qmc_exec.dmc`).
"""
import os
import typing as t
import warnings
from dataclasses import dataclass, replace
from functools import cached_property

import numpy as np

from ..models import mrbp
from ..samplers import vmc as vmc_sampler
from . import proc as proc_base, sharded
from .data import vmc as vmc_data
from .logging import exec_logger
from ..constants import ER

__all__ = [
    "ModelSysConfSpec",
    "OBDEstSpec",
    "PairCorrEstSpec",
    "Proc",
    "ProcInput",
    "ProcResult",
    "SSFEstSpec",
]

ModelSysConfSpec = proc_base.ModelSysConfSpec


def _walker_means(wf_abs_log, energy, move_stat):
    """Walker-axis means of the per-step dynamics series, ON DEVICE.

    The accumulator only ever consumes walker means (per-step series or
    block scalars), while the sampler's raw ``iter_props`` tensors are
    ``(nts, W)``, ~100 MB per block at the production shape (512 x
    16k).  Reducing first fetches KBs instead.  The acceptance flags
    average in the energy's dtype.
    """
    return (wf_abs_log.mean(dim=-1), energy.mean(dim=-1),
            move_stat.to(energy.dtype).mean(dim=-1))


@dataclass(frozen=True)
class SSFEstSpec:
    """S(k) estimator config (``mrbp_qmc/vmc_exec/proc.py``)."""
    num_modes: int


@dataclass(frozen=True)
class OBDEstSpec:
    """One-body density matrix estimator config: ``n1(sz)`` on a
    ``num_pos``-point grid over ``[0, L/2]`` (the reference stubs this
    estimator out, ``qmc_base/vmc.py:444-450``).

    ``est_every_mult`` evaluates the grid only every
    ``est_every * est_every_mult``-th step (the grid costs ``num_pos``
    shifted pair passes; chain dynamics and S(k) are bit-identical for
    any value)."""
    num_pos: int
    est_every_mult: int = 1


@dataclass(frozen=True)
class PairCorrEstSpec:
    """Direct pair-correlation ``g2(r)`` estimator config: a histogram
    of unordered-pair minimum-image distances on ``num_bins`` uniform
    bins over ``[0, L/2]`` (beyond the reference — no direct
    pair-correlation estimator there).

    ``est_every_mult`` bins the distances only every
    ``est_every * est_every_mult``-th step (the pass costs about one
    O(N^2) Metropolis evaluation; chain dynamics and the other
    estimators are bit-identical for any value)."""
    num_bins: int
    est_every_mult: int = 1


@dataclass(frozen=True)
class ProcInput(proc_base.ProcInput):
    """Input for the VMC procedure: an initial VMC state.

    ``resume`` carries the measurement state of a mid-run checkpoint
    (completed-block accumulator data + stream position) so
    :meth:`Proc.exec` continues the interrupted run bit-exactly;
    built by :meth:`Proc.restore_checkpoint`, ``None`` for fresh
    runs."""
    state: vmc_sampler.State
    resume: t.Optional[dict] = None

    @classmethod
    def from_model_sys_conf_spec(cls, sys_conf_spec: ModelSysConfSpec,
                                 proc: "Proc", device="cuda"):
        """Fresh input on ``device`` from model-generated
        configurations: the same configurations as the JAX package
        draws from the same ``rng_seed``."""
        model_spec = proc.model_spec
        dist_type = mrbp.SysConfDistType[sys_conf_spec.dist_type]
        rng = np.random.default_rng(proc.rng_seed)
        num = sys_conf_spec.num_sys_conf or proc.num_walkers
        if num != proc.num_walkers:
            warnings.warn(
                f"num_sys_conf={num} differs from the procedure's "
                f"num_walkers={proc.num_walkers}; using num_walkers "
                f"(the VMC ensemble size is fixed by the procedure)",
                UserWarning)
            num = proc.num_walkers
        confs = np.stack([
            model_spec.init_get_sys_conf(dist_type=dist_type, rng=rng)
            for _ in range(num)]).astype(np.dtype(proc.dtype))
        return cls(proc.sampling.build_state(confs, device=device))

    @classmethod
    def from_result(cls, proc_result: "ProcResult", proc: "Proc"):
        return cls(proc_result.state)


@dataclass(frozen=True)
class ProcResult(proc_base.ProcResult):
    """Result of the VMC procedure."""
    state: vmc_sampler.State
    proc: "Proc"
    data: t.Optional[vmc_data.SamplingData] = None


@dataclass(frozen=True)
class Proc(proc_base.Proc):
    """VMC sampling procedure (defaults follow
    ``mrbp_qmc/vmc_exec/proc.py:155-188``)."""

    model_spec: mrbp.Spec
    move_spread: float
    rng_seed: t.Optional[int] = None
    num_blocks: int = 8
    num_steps_block: int = 4096
    burn_in_blocks: t.Optional[int] = None
    keep_iter_data: bool = False
    #: Index of this run's first block in the (rng_seed)-keyed random
    #: stream; continuation runs resume the stream past the blocks the
    #: original run consumed (see ``dmc.Proc.block_offset``).
    block_offset: int = 0
    ssf_spec: t.Optional[SSFEstSpec] = None
    obd_spec: t.Optional[OBDEstSpec] = None
    #: Direct pair-correlation g2(r) histogram; see
    #: :class:`PairCorrEstSpec`.
    pair_corr_spec: t.Optional[PairCorrEstSpec] = None
    #: Independent Markov chains advanced in lockstep (an extension of
    #: the upstream library's single chain).
    num_walkers: int = 1
    dtype: str = "float32"
    #: Several devices: shard chains over this many local devices of
    #: the input state's kind, one process each (None = single device,
    #: 0 = all available devices; on the CPU, gloo ranks).
    num_mesh_devices: t.Optional[int] = None
    #: Mid-procedure checkpointing: dump the chain state to this HDF5
    #: file every ``checkpoint_every`` blocks (DMC parity; the
    #: reference only stubs the hook, ``qmc_exec/proc.py:127-129``).
    checkpoint_file: t.Optional[str] = None
    checkpoint_every: int = 16
    #: Estimator measurement cadence: evaluate the S(k)/OBDM grids only
    #: every K-th step (``samplers.vmc.Sampling.est_every`` — the OBDM
    #: grid is the expensive per-step term).  Estimator series then
    #: carry ``num_steps_block // est_every`` entries per block; chain
    #: dynamics are identical for any K.
    est_every: int = 1
    #: Gaussian proposals of width ``move_spread`` instead of uniform
    #: box moves — the reference's normal-distribution sampling
    #: (``mrbp_qmc/vmc_ndf.py``, ``sigma = sqrt(time_step)``), which it
    #: never surfaced through its config layer; here one config key
    #: switches it.
    gaussian: bool = False
    verbose: bool = False

    # VMC has no density estimator in the reference either.
    density_spec: t.ClassVar[None] = None

    def __post_init__(self):
        _set = object.__setattr__
        _set(self, "move_spread", float(self.move_spread))
        if self.rng_seed is not None:
            _set(self, "rng_seed", int(self.rng_seed))
        _set(self, "num_blocks", int(self.num_blocks))
        _set(self, "num_steps_block", int(self.num_steps_block))
        _set(self, "num_walkers", int(self.num_walkers))
        _set(self, "keep_iter_data", bool(self.keep_iter_data))
        if self.burn_in_blocks is None:
            object.__setattr__(self, "burn_in_blocks",
                               max(1, self.num_blocks // 8))
        else:
            _set(self, "burn_in_blocks", int(self.burn_in_blocks))
        _set(self, "block_offset", int(self.block_offset))
        _set(self, "est_every", int(self.est_every))
        if self.est_every < 1:
            raise ValueError("est_every must be a positive integer")
        if self.pair_corr_spec is not None:
            mult = int(self.pair_corr_spec.est_every_mult)
            if mult < 1:
                raise ValueError("pair_corr_spec: est_every_mult must "
                                 "be a positive integer")
            if self.num_steps_block % (self.est_every * mult):
                raise ValueError(
                    "pair_corr_spec: num_steps_block must be divisible "
                    "by est_every * est_every_mult")
        if self.obd_spec is not None:
            mult = int(self.obd_spec.est_every_mult)
            if mult < 1:
                raise ValueError("obd_spec: est_every_mult must be a "
                                 "positive integer")
            if self.num_steps_block % (self.est_every * mult):
                raise ValueError(
                    "obd_spec: num_steps_block must be divisible by "
                    "est_every * est_every_mult")
        if self.num_steps_block % self.est_every:
            raise ValueError("num_steps_block must be divisible by "
                             "est_every")

    @classmethod
    def from_config(cls, config: t.Mapping) -> "Proc":
        self_config = dict(config)
        for old, new in (("num_batches", "num_blocks"),
                         ("num_steps_batch", "num_steps_block"),
                         ("burn_in_batches", "burn_in_blocks")):
            if old in self_config:
                warnings.warn(f"{old} attribute is deprecated, use {new} "
                              f"instead", DeprecationWarning)
                self_config[new] = self_config.pop(old)
        model_spec = mrbp.Spec(**self_config.pop("model_spec"))
        ssf_config = self_config.pop("ssf_spec", None)
        ssf_spec = SSFEstSpec(**ssf_config) if ssf_config is not None \
            else None
        obd_config = self_config.pop("obd_spec", None)
        obd_spec = OBDEstSpec(**obd_config) if obd_config is not None \
            else None
        g2_config = self_config.pop("pair_corr_spec", None)
        pair_corr_spec = PairCorrEstSpec(**g2_config) \
            if g2_config is not None else None
        return cls(model_spec=model_spec, ssf_spec=ssf_spec,
                   obd_spec=obd_spec, pair_corr_spec=pair_corr_spec,
                   **self_config)

    def as_config(self) -> dict:
        config = {
            "model_spec": {
                "lattice_depth": self.model_spec.lattice_depth,
                "lattice_ratio": self.model_spec.lattice_ratio,
                "interaction_strength":
                    self.model_spec.interaction_strength,
                "boson_number": self.model_spec.boson_number,
                "supercell_size": self.model_spec.supercell_size,
                "tbf_contact_cutoff": self.model_spec.tbf_contact_cutoff,
                "num_defects": self.model_spec.num_defects,
                "defect_magnitude": self.model_spec.defect_magnitude,
            },
            "move_spread": self.move_spread,
            "rng_seed": self.rng_seed,
            "num_blocks": self.num_blocks,
            "num_steps_block": self.num_steps_block,
            "burn_in_blocks": self.burn_in_blocks,
            "keep_iter_data": self.keep_iter_data,
            "block_offset": self.block_offset,
            "num_walkers": self.num_walkers,
            "dtype": self.dtype,
            "num_mesh_devices": self.num_mesh_devices,
            "est_every": self.est_every,
            "gaussian": self.gaussian or None,  # omit the default
        }
        if self.model_spec.obf_lattice_depth is not None:
            config["model_spec"]["obf_lattice_depth"] = \
                self.model_spec.obf_lattice_depth
        if self.ssf_spec is not None:
            config["ssf_spec"] = {"num_modes": self.ssf_spec.num_modes}
        if self.obd_spec is not None:
            config["obd_spec"] = {"num_pos": self.obd_spec.num_pos}
            if self.obd_spec.est_every_mult != 1:
                config["obd_spec"]["est_every_mult"] = \
                    self.obd_spec.est_every_mult
        if self.pair_corr_spec is not None:
            config["pair_corr_spec"] = {
                "num_bins": self.pair_corr_spec.num_bins}
            if self.pair_corr_spec.est_every_mult != 1:
                config["pair_corr_spec"]["est_every_mult"] = \
                    self.pair_corr_spec.est_every_mult
        return {k: v for k, v in config.items() if v is not None}

    def evolve(self, config: t.Mapping) -> "Proc":
        self_config = dict(config)
        model_spec = self.model_spec
        model_spec_config = self_config.pop("model_spec", None)
        if model_spec_config is not None:
            model_spec = model_spec.evolve(**model_spec_config)
        ssf_spec = self.ssf_spec
        ssf_config = self_config.pop("ssf_spec", None)
        if ssf_config is not None:
            ssf_spec = SSFEstSpec(**ssf_config) if ssf_spec is None \
                else replace(ssf_spec, **ssf_config)
        obd_spec = self.obd_spec
        obd_config = self_config.pop("obd_spec", None)
        if obd_config is not None:
            obd_spec = OBDEstSpec(**obd_config) if obd_spec is None \
                else replace(obd_spec, **obd_config)
        pair_corr_spec = self.pair_corr_spec
        g2_config = self_config.pop("pair_corr_spec", None)
        if g2_config is not None:
            pair_corr_spec = PairCorrEstSpec(**g2_config) \
                if pair_corr_spec is None \
                else replace(pair_corr_spec, **g2_config)
        return replace(self, model_spec=model_spec, ssf_spec=ssf_spec,
                       obd_spec=obd_spec, pair_corr_spec=pair_corr_spec,
                       **self_config)

    def mesh_spec(self, device="cuda"):
        """The walker mesh of ``num_mesh_devices`` on ``device``'s kind
        (``None`` unsharded)."""
        return sharded.mesh_spec(self.num_mesh_devices, device)

    @cached_property
    def sampling(self) -> vmc_sampler.Sampling:
        """The bound sampler, unsharded: a run on a mesh gives each rank
        its own with the rank's mesh."""
        ssf_est_spec = vmc_sampler.SSFEstSpec(self.ssf_spec.num_modes) \
            if self.should_eval_ssf else None
        obd_est_spec = vmc_sampler.OBDEstSpec(
            self.obd_spec.num_pos,
            est_every_mult=self.obd_spec.est_every_mult) \
            if self.should_eval_obd else None
        pair_corr_est_spec = vmc_sampler.PairCorrEstSpec(
            self.pair_corr_spec.num_bins,
            est_every_mult=self.pair_corr_spec.est_every_mult) \
            if self.should_eval_pair_corr else None
        return vmc_sampler.Sampling(
            self.model_spec, self.move_spread, self.rng_seed,
            ssf_est_spec=ssf_est_spec, obd_est_spec=obd_est_spec,
            pair_corr_est_spec=pair_corr_est_spec,
            num_walkers=self.num_walkers, gaussian=self.gaussian,
            est_every=self.est_every)

    def describe_model_spec(self):
        spec = self.model_spec
        exec_logger.info("Multi-Rods system parameters:")
        exec_logger.info(f"* Lattice depth: {spec.lattice_depth / ER:.3G} ER")
        exec_logger.info(f"* Lattice ratio: {spec.lattice_ratio:.3G}")
        exec_logger.info(
            f"* Interaction strength: "
            f"{spec.interaction_strength / ER:.3G} ER")
        exec_logger.info(f"* Number of bosons: {spec.boson_number:d}")
        exec_logger.info(f"* Supercell size: {spec.supercell_size:.3G} LKP")
        exec_logger.info(f"* RM: {spec.tbf_contact_cutoff:.3G} LKP")

    def build_result(self, state: vmc_sampler.State,
                     sampling_data: vmc_data.SamplingData) -> ProcResult:
        return ProcResult(state, self, sampling_data)

    def _checkpoint_input(self, state, blocks_completed: int,
                          it_offset: int = 0, it_next: int = 0,
                          accum=None) -> ProcInput:
        """The input that resumes this run after ``blocks_completed``
        blocks: the chain state and, as ``resume``, the completed-block
        accumulator data and the stream position (VMC has no
        forward-walking windows), so ``exec`` on it reproduces the
        uninterrupted run bit-exactly."""
        resume = {
            "blocks_completed": int(blocks_completed),
            "it_offset": int(it_offset),
            "it_next": int(it_next),
        }
        if accum is not None:
            resume["accum"] = accum.snapshot()
        return ProcInput(state, resume=resume)

    def _write_checkpoint(self, resume_input: ProcInput):
        """Atomic full-state checkpoint (DMC parity, ``dmc.Proc``):
        temp file + rename.  Schema v2 stores the ORIGINAL proc_spec
        plus a resume group with the payload of
        :meth:`_checkpoint_input`."""
        import h5py

        from . import io as io_mod

        handler = io_mod.VmcHDF5FileHandler(self.checkpoint_file,
                                            group="checkpoint",
                                            dump_replace=True)
        config = self.as_config()
        resume = resume_input.resume
        tmp_path = f"{self.checkpoint_file}.tmp"
        with h5py.File(tmp_path, "w") as fp:
            handler.save_state(resume_input.state, fp.require_group(
                "checkpoint/vmc/state"))
            handler.save_proc(config, fp.require_group(
                "checkpoint/vmc/proc_spec"))
            rg = fp.require_group("checkpoint/vmc/resume")
            rg.attrs["schema"] = 2
            for name in ("blocks_completed", "it_offset", "it_next"):
                rg.attrs[name] = int(resume[name])
            if "accum" in resume:
                _VmcBlockAccumulator.write_snapshot(
                    resume["accum"], rg.require_group("accum"))
        os.replace(tmp_path, self.checkpoint_file)
        exec_logger.info(f"checkpoint written to {self.checkpoint_file}")

    @classmethod
    def restore_checkpoint(cls, checkpoint_file: str, device="cuda") \
            -> t.Tuple["Proc", ProcInput]:
        """Load a mid-run checkpoint, this package's or the JAX
        package's: ``(proc, proc_input)`` ready for ``proc.exec``, the
        state on ``device``.  Schema-v2 checkpoints resume bit-exactly;
        legacy v1 files fall back to continuation semantics."""
        import h5py

        from . import io as io_mod

        handler = io_mod.VmcHDF5FileHandler(checkpoint_file,
                                            group="checkpoint")
        with h5py.File(checkpoint_file, "r") as fp:
            proc = handler.load_proc(fp.get("checkpoint/vmc/proc_spec"))
            state = handler.load_state(fp.get("checkpoint/vmc/state"),
                                       proc, device=device)
            rg = fp.get("checkpoint/vmc/resume")
            if rg is None:
                return proc, ProcInput(state)
            resume = {
                "blocks_completed": int(rg.attrs["blocks_completed"]),
                "it_offset": int(rg.attrs["it_offset"]),
                "it_next": int(rg.attrs["it_next"]),
            }
            acg = rg.get("accum")
            if acg is not None:
                resume["accum"] = \
                    _VmcBlockAccumulator.load_snapshot(acg)
        return proc, ProcInput(state, resume=resume)

    def exec(self, proc_input: ProcInput,
             checkpoint_hook: t.Optional[t.Callable[[ProcInput], None]]
             = None, mesh=None) -> ProcResult:
        """Run the VMC sampling on the device of ``proc_input.state``
        (the upstream library's loop: ``qmc_exec/vmc/proc.py:87-250``).
        ``checkpoint_hook`` receives every checkpoint's resume input,
        and ``num_mesh_devices`` (or ``mesh``) splits the chains, as in
        :meth:`phd_qmclib_torch.qmc_exec.dmc.Proc.exec`."""
        if not isinstance(proc_input, ProcInput):
            raise proc_base.ProcInputError(
                "VMC procedure input must be a vmc ProcInput instance")
        if mesh is None:
            mesh = self.mesh_spec(proc_input.state.pos.device)
        if mesh is None:
            return self._exec(proc_input, checkpoint_hook)
        return sharded.exec_on_mesh(self, proc_input, mesh, checkpoint_hook)

    def _exec(self, proc_input: ProcInput,
              checkpoint_hook: t.Optional[t.Callable[[ProcInput], None]]
              = None, mesh=None) -> ProcResult:
        """:meth:`exec` on one device, or on the rank ``mesh`` (a
        ``WalkerMesh``) of a walker mesh."""
        num_blocks = self.num_blocks
        ns_block = self.num_steps_block
        burn_in_blocks = self.burn_in_blocks
        keep_iter_data = self.keep_iter_data
        should_eval_ssf = self.should_eval_ssf
        should_eval_obd = self.should_eval_obd
        should_eval_g2 = self.should_eval_pair_corr
        num_walkers = self.num_walkers

        exec_logger.info("Starting VMC sampling...")
        self.describe_model_spec()

        sampling = self.sampling
        if mesh is not None:
            sampling = replace(sampling, mesh=mesh)
        writer = mesh is None or mesh.rank == 0
        resume = proc_input.resume
        start_block = 0
        it_offset = self.block_offset
        it_next = 0
        if resume is not None:
            start_block = int(resume["blocks_completed"])
            it_offset = int(resume["it_offset"])
            it_next = int(resume["it_next"])
            # Same per-position block keys as the uninterrupted run:
            # shift the offset by the consumed count (VMC has no
            # window phases, so offset arithmetic is the whole state).
            blocks_iter = sampling.blocks(
                ns_block, proc_input.state,
                block_offset=it_offset + it_next)
            exec_logger.info(
                f"resuming from a mid-run checkpoint at block "
                f"{start_block}/{num_blocks}")
        else:
            blocks_iter = sampling.blocks(ns_block, proc_input.state,
                                          block_offset=self.block_offset)

        if burn_in_blocks and resume is None:
            exec_logger.info(
                f"Computing VMC burn-in stage ({burn_in_blocks} blocks)...")
            for _ in range(burn_in_blocks):
                next(blocks_iter)
                it_next += 1
            exec_logger.info("Burn-in stage completed.")

        accumulator = _VmcBlockAccumulator(self)
        if resume is not None and "accum" in resume:
            accumulator.restore(resume["accum"])

        block_data = None
        checkpointing = self.checkpoint_file is not None \
            or checkpoint_hook is not None
        for block_idx in range(start_block, num_blocks):
            block_data = next(blocks_iter)
            it_next += 1
            bp = block_data.iter_props
            wfl_m, en_m, mv_m = _walker_means(bp.wf_abs_log, bp.energy,
                                              bp.move_stat)
            accumulator.add(
                block_idx,
                np.asarray(wfl_m.cpu(), dtype=np.float64),
                np.asarray(en_m.cpu(), dtype=np.float64),
                np.asarray(mv_m.cpu(), dtype=np.float64),
                block_data.accept_rate,
                iter_ssf=(np.asarray(block_data.iter_ssf.cpu(),
                                     dtype=np.float64)
                          if should_eval_ssf else None),
                iter_obd=(np.asarray(block_data.iter_obd.cpu(),
                                     dtype=np.float64)
                          if should_eval_obd else None),
                iter_g2=(np.asarray(block_data.iter_g2.cpu(),
                                    dtype=np.float64)
                         if should_eval_g2 else None))
            if checkpointing and \
                    (block_idx + 1) % self.checkpoint_every == 0:
                # AFTER the accumulator folds this block, so the
                # snapshot carries the checkpointed block's statistics.
                resume_input = self._checkpoint_input(
                    _global_state(mesh, block_data.last_state),
                    blocks_completed=block_idx + 1,
                    it_offset=it_offset, it_next=it_next,
                    accum=accumulator)
                if writer and self.checkpoint_file is not None:
                    self._write_checkpoint(resume_input)
                if writer and checkpoint_hook is not None:
                    checkpoint_hook(resume_input)

        exec_logger.info("VMC sampling completed.")
        exec_logger.info(
            f"Mean acceptance rate: {accumulator.mean_accept_rate:.4f}")

        sampling_data = accumulator.package()
        last_state = _global_state(mesh, block_data.last_state) \
            if block_data is not None else proc_input.state
        return self.build_result(last_state, sampling_data)


def _global_state(mesh, state: vmc_sampler.State) -> vmc_sampler.State:
    """All the chains of a mesh, whose rank holds ``state`` (every rank
    takes part); the state itself unsharded."""
    if mesh is None:
        return state
    return type(state)(*(None if x is None else mesh.cat(x) for x in state))


class _VmcBlockAccumulator:
    """Per-block reductions + result packaging of one VMC procedure
    (reference ``qmc_exec/vmc/proc.py:187-250``), factored out of
    :meth:`Proc.exec` so that a fused parameter sweep can run one
    accumulator per sweep row over a single fused block stream.  Pure
    NumPy, a copy of the JAX package's accumulator."""

    def __init__(self, proc: "Proc"):
        self.proc = proc
        num_blocks = proc.num_blocks
        ns_block = proc.num_steps_block
        keep = proc.keep_iter_data
        shape = (num_blocks, ns_block) if keep else (num_blocks,)
        num_measured = ns_block // proc.est_every
        est_shape = (num_blocks, num_measured) if keep \
            else (num_blocks,)
        self.wf_abs_log = np.zeros(shape)
        self.energy = np.zeros(shape)
        self.move_stat = np.zeros(shape)
        self.ssf_data = None
        if proc.should_eval_ssf:
            self.ssf_data = np.zeros(
                est_shape + (proc.ssf_spec.num_modes, 3))
        self.obd_data = None
        if proc.should_eval_obd:
            # The OBDM carries its own (sparser) cadence.
            num_measured_obd = ns_block // (proc.est_every
                                            * proc.obd_spec.est_every_mult)
            obd_shape = (num_blocks, num_measured_obd) if keep \
                else (num_blocks,)
            self.obd_data = np.zeros(
                obd_shape + (proc.obd_spec.num_pos,))
        self.g2_data = None
        if proc.should_eval_pair_corr:
            num_measured_g2 = ns_block // (
                proc.est_every * proc.pair_corr_spec.est_every_mult)
            g2_shape = (num_blocks, num_measured_g2) if keep \
                else (num_blocks,)
            self.g2_data = np.zeros(
                g2_shape + (proc.pair_corr_spec.num_bins,))
        self.accept_rates = []

    def add(self, block_idx: int, wf_abs_log, energy, move_stat,
            accept_rate: float, iter_ssf=None, iter_obd=None,
            iter_g2=None):
        """Fold one block's per-step walker MEANS (``(nts,)``, reduced
        on device by :func:`_walker_means`) and walker-summed estimator
        arrays (``(nts_measured, ...)``)."""
        proc = self.proc
        num_walkers = proc.num_walkers
        self.accept_rates.append(accept_rate)
        if proc.keep_iter_data:
            # Per-step chain means (already reduced over walkers).
            self.energy[block_idx] = energy
            self.wf_abs_log[block_idx] = wf_abs_log
            self.move_stat[block_idx] = move_stat
            if iter_ssf is not None:
                self.ssf_data[block_idx] = iter_ssf / num_walkers
            if iter_obd is not None:
                self.obd_data[block_idx] = iter_obd / num_walkers
            if iter_g2 is not None:
                self.g2_data[block_idx] = iter_g2 / num_walkers
        else:
            # Equal walker counts per step: the mean of per-step means
            # equals the full per-entry mean.
            self.energy[block_idx] = energy.mean()
            self.wf_abs_log[block_idx] = wf_abs_log.mean()
            self.move_stat[block_idx] = move_stat.mean()
            if iter_ssf is not None:
                self.ssf_data[block_idx] = \
                    iter_ssf.mean(axis=0) / num_walkers
            if iter_obd is not None:
                self.obd_data[block_idx] = \
                    iter_obd.mean(axis=0) / num_walkers
            if iter_g2 is not None:
                self.g2_data[block_idx] = \
                    iter_g2.mean(axis=0) / num_walkers

    #: Optional estimator arrays captured by checkpoints (None entries
    #: are skipped; shapes are fixed by the proc config).
    _SNAPSHOT_ARRAYS = ("wf_abs_log", "energy", "move_stat",
                        "ssf_data", "obd_data", "g2_data")

    def snapshot(self) -> dict:
        """The complete accumulator state as the payload of
        :meth:`restore` (what :meth:`load_snapshot` reads back from a
        file): copies, since the accumulator goes on folding blocks."""
        return {
            "accept_rates": np.asarray(self.accept_rates,
                                       dtype=np.float64),
            "arrays": {name: getattr(self, name).copy()
                       for name in self._SNAPSHOT_ARRAYS
                       if getattr(self, name) is not None},
        }

    @staticmethod
    def write_snapshot(payload: dict, group):
        """Write a :meth:`snapshot` payload to an HDF5 group."""
        group.create_dataset("accept_rates", data=payload["accept_rates"])
        ag = group.require_group("arrays")
        for name, arr in payload["arrays"].items():
            ag.create_dataset(name, data=arr)

    def save_snapshot(self, group):
        """Write the complete accumulator state to an HDF5 group —
        the measurement half of a mid-run checkpoint (schema v2)."""
        self.write_snapshot(self.snapshot(), group)

    @staticmethod
    def load_snapshot(group) -> dict:
        """Inverse of :meth:`save_snapshot`: a payload for
        :meth:`restore`."""
        return {
            "accept_rates": group["accept_rates"][()],
            "arrays": {name: ds[()]
                       for name, ds in group["arrays"].items()},
        }

    def restore(self, payload: dict):
        """Refill this (freshly-constructed) accumulator from a
        checkpoint payload; shapes must match the proc config the
        checkpoint was written under."""
        self.accept_rates = [float(a)
                             for a in payload["accept_rates"]]
        for name, arr in payload["arrays"].items():
            dest = getattr(self, name)
            if dest is None:
                raise ValueError(
                    f"checkpoint carries accumulator array {name!r} "
                    f"but the current proc config does not allocate "
                    f"it — restore into the original configuration")
            np.copyto(dest, arr)

    @property
    def mean_accept_rate(self) -> float:
        return float(np.mean(self.accept_rates))

    def package(self) -> vmc_data.SamplingData:
        proc = self.proc
        props_data = vmc_data.PropsData(self.wf_abs_log, self.energy,
                                        self.move_stat)
        reduce_data = bool(proc.keep_iter_data)
        energy_blocks = vmc_data.EnergyBlocks.from_data(props_data,
                                                        reduce_data)
        ssf_blocks = vmc_data.SSFBlocks.from_data(self.ssf_data,
                                                  reduce_data) \
            if proc.should_eval_ssf else None
        obd_blocks = vmc_data.OBDBlocks.from_data(self.obd_data,
                                                  reduce_data) \
            if proc.should_eval_obd else None
        g2_blocks = vmc_data.PairCorrBlocks.from_data(self.g2_data,
                                                      reduce_data) \
            if proc.should_eval_pair_corr else None
        data_blocks = vmc_data.PropsDataBlocks(energy_blocks,
                                               ssf_blocks, obd_blocks,
                                               g2_blocks)
        data_series = vmc_data.PropsDataSeries(
            props_data, self.ssf_data, self.obd_data, self.g2_data) \
            if proc.keep_iter_data else None
        return vmc_data.SamplingData(data_blocks, data_series)
