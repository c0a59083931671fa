"""DMC procedure: the production run loop.

Counterpart of ``phd_qmclib_tpu.qmc_exec.dmc``, after the upstream
library's model-agnostic procedure (``qmc_exec/dmc/proc.py``)
and its concrete mrbp binding (``mrbp_qmc/dmc_exec/proc.py``): burn-in
stage, per-block accumulation (full series or reduced totals),
pure-estimator reduction factors, and packaging into the
block-statistics data model.

The configuration is the JAX package's, key for key, so that config
files and stored ``proc_spec`` groups load in both.  The device is a
property of a run and never of the configuration: :meth:`Proc.exec`
runs where its input's state lives, and the functions that build a
state (:meth:`ProcInput.from_model_sys_conf_spec`,
:meth:`Proc.restore_checkpoint`) take a ``device``.  ``num_mesh_devices``
shards the walkers over that many devices of the input's kind, one
process each (:mod:`phd_qmclib_torch.qmc_exec.sharded`): the result,
its files and its checkpoints hold the global view, as the JAX
package's do.  The block accumulator is NumPy on the host: a block's
per-step scalars and estimator rows arrive there in one fetch
(:meth:`phd_qmclib_torch.samplers.dmc.Sampling.blocks`).
"""
import os
import time
import typing as t
import warnings
from dataclasses import dataclass, replace
from functools import cached_property

import numpy as np
import torch

from ..models import mrbp
from ..samplers import dmc as dmc_sampler
from . import proc as proc_base, sharded
from .data import dmc as dmc_data
from .logging import exec_logger
from ..constants import ER

__all__ = [
    "CMDiffusionEstSpec",
    "DensityEstSpec",
    "ITCEstSpec",
    "ModelSysConfSpec",
    "OBDEstSpec",
    "PairCorrEstSpec",
    "Proc",
    "ProcInput",
    "ProcResult",
    "SSFEstSpec",
]

DensityEstSpec = proc_base.DensityEstSpec
SSFEstSpec = proc_base.SSFEstSpec
OBDEstSpec = proc_base.OBDEstSpec
PairCorrEstSpec = proc_base.PairCorrEstSpec
CMDiffusionEstSpec = proc_base.CMDiffusionEstSpec
ITCEstSpec = proc_base.ITCEstSpec
ModelSysConfSpec = proc_base.ModelSysConfSpec


@dataclass(frozen=True)
class ProcInput(proc_base.ProcInput):
    """Input for the DMC procedure: an initial DMC state.

    ``resume`` carries the full measurement state of a mid-run
    checkpoint (completed-block accumulator data, pure-estimator
    forward-walking aux carry, window phases, iterator stream
    position) so :meth:`Proc.exec` continues the interrupted run
    bit-exactly instead of opening fresh windows; built by
    :meth:`Proc.restore_checkpoint`, ``None`` for fresh runs."""
    state: dmc_sampler.State
    resume: t.Optional[dict] = None

    @classmethod
    def from_model_sys_conf_spec(cls, sys_conf_spec: ModelSysConfSpec,
                                 proc: "Proc", device="cuda"):
        """Fresh input on ``device`` from model-generated configurations
        (``mrbp_qmc/dmc_exec/proc.py:107-129``): the same configurations
        as the JAX package draws from the same ``rng_seed``."""
        model_spec = proc.model_spec
        dist_type = mrbp.SysConfDistType[sys_conf_spec.dist_type]
        num_sys_conf = sys_conf_spec.num_sys_conf or proc.target_num_walkers
        rng = np.random.default_rng(proc.rng_seed)
        sys_conf_set = np.stack([
            model_spec.init_get_sys_conf(dist_type=dist_type, rng=rng)
            for _ in range(num_sys_conf)])
        spec = proc.mesh_spec(device)
        state = proc.sampling.build_state(
            sys_conf_set, dtype=np.dtype(proc.dtype), device=device,
            num_shards=1 if spec is None else spec.size)
        return cls(state)

    @classmethod
    def from_result(cls, proc_result: "ProcResult", proc: "Proc"):
        return cls(proc_result.state)


@dataclass(frozen=True)
class ProcResult(proc_base.ProcResult):
    """Result of the DMC procedure."""
    state: dmc_sampler.State
    proc: "Proc"
    data: t.Optional[dmc_data.SamplingData] = None


@dataclass(frozen=True)
class Proc(proc_base.Proc):
    """DMC sampling procedure (defaults follow
    ``mrbp_qmc/dmc_exec/proc.py:161-217``)."""

    model_spec: mrbp.Spec
    time_step: float
    max_num_walkers: int = 512
    target_num_walkers: int = 480
    num_walkers_control_factor: t.Optional[float] = 0.5
    rng_seed: t.Optional[int] = None
    num_blocks: int = 512
    num_time_steps_block: int = 512
    burn_in_blocks: t.Optional[int] = None
    keep_iter_data: bool = False
    #: Index of this run's first block in the (rng_seed)-keyed random
    #: stream.  Continuation runs resume the stream at the number of
    #: blocks already consumed instead of replaying it; checkpoints
    #: persist the advanced value (absent in the reference, whose
    #: restarts silently replay the original stream when the seed is
    #: reused).
    block_offset: int = 0
    density_spec: t.Optional[DensityEstSpec] = None
    ssf_spec: t.Optional[SSFEstSpec] = None
    obd_spec: t.Optional[OBDEstSpec] = None
    #: Direct pair-correlation g2(r) histogram; see
    #: :class:`PairCorrEstSpec`.
    pair_corr_spec: t.Optional[PairCorrEstSpec] = None
    #: Center-of-mass imaginary-time diffusion (superfluid fraction /
    #: effective mass); see :class:`CMDiffusionEstSpec`.
    cm_diffusion_spec: t.Optional[CMDiffusionEstSpec] = None
    #: Imaginary-time density-density correlation F(k, tau)
    #: (intermediate scattering function); see :class:`ITCEstSpec`.
    itc_spec: t.Optional[ITCEstSpec] = None
    #: Compute dtype on the device ("float32" or "float64").
    dtype: str = "float32"
    #: Several devices: shard walkers over this many local devices of
    #: the input state's kind, one process each (None = single device,
    #: 0 = all available devices; on the CPU, gloo ranks).
    num_mesh_devices: t.Optional[int] = None
    #: Several devices: rebalance the walker population across shards
    #: every K blocks.  It has no effect on one device, here as in the
    #: JAX package.
    rebalance_every: t.Optional[int] = None
    #: Write a ``torch.profiler`` trace of the first measured block to
    #: this directory (a Chrome trace: open with Perfetto).
    profile_dir: t.Optional[str] = None
    #: Mid-procedure checkpointing: dump the walker state to this HDF5
    #: file every ``checkpoint_every`` blocks (the reference only stubs
    #: this hook, ``qmc_exec/proc.py:127-129``).
    checkpoint_file: t.Optional[str] = None
    checkpoint_every: int = 16
    #: Light checkpoints: skip the imaginary-time-correlation ring
    #: buffer and its pure-estimator accumulators — at the shipped
    #: production config these dominate the checkpoint (285 MB of
    #: buffer vs ~20 MB of everything else).  A resume then restarts the ITC lag fill (the lag
    #: counts discount refills BY CONSTRUCTION, and the pure sums and
    #: counts zero together so the ratio-of-means stays unbiased —
    #: only pre-checkpoint in-buffer statistics are lost).  Everything
    #: else resumes bit-exactly.
    checkpoint_light: bool = False
    #: Estimator measurement cadence: evaluate density/S(k)/OBDM only
    #: every K-th time step (see ``Sampling.est_every`` — the dynamics
    #: and pure-estimator ancestry transport advance every step, so K
    #: of 4-8 buys back most of the estimator overhead at negligible
    #: statistical cost).  Estimator series then carry
    #: ``num_time_steps_block // est_every`` entries per block and
    #: mixed estimators normalize by the measured steps' weights.
    est_every: int = 1
    verbose: bool = False

    def __post_init__(self):
        # Field converters (the reference uses attrs converters,
        # ``mrbp_qmc/dmc_exec/proc.py:164-196``; they also absorb YAML
        # 1.1 scalars like "1e-3" parsed as strings).
        _set = object.__setattr__
        _set(self, "time_step", float(self.time_step))
        _set(self, "max_num_walkers", int(self.max_num_walkers))
        _set(self, "target_num_walkers", int(self.target_num_walkers))
        if self.num_walkers_control_factor is not None:
            _set(self, "num_walkers_control_factor",
                 float(self.num_walkers_control_factor))
        if self.rng_seed is not None:
            _set(self, "rng_seed", int(self.rng_seed))
        _set(self, "num_blocks", int(self.num_blocks))
        _set(self, "num_time_steps_block", int(self.num_time_steps_block))
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
        if self.num_time_steps_block % self.est_every:
            raise ValueError("num_time_steps_block must be divisible "
                             "by est_every")
        if self.itc_spec is not None:
            if int(self.itc_spec.num_modes) < 1 \
                    or int(self.itc_spec.num_lags) < 1 \
                    or int(self.itc_spec.est_every_mult) < 1:
                raise ValueError(
                    "itc_spec: num_modes, num_lags and est_every_mult "
                    "must be positive integers")
            if self.num_time_steps_block % (
                    self.est_every * self.itc_spec.est_every_mult):
                raise ValueError(
                    "itc_spec: num_time_steps_block must be divisible "
                    "by est_every * est_every_mult")
            measured = (self.num_blocks * self.num_time_steps_block
                        // (self.est_every
                            * self.itc_spec.est_every_mult))
            if int(self.itc_spec.num_lags) >= measured:
                warnings.warn(
                    f"itc_spec: num_lags={self.itc_spec.num_lags} "
                    f"meets or exceeds the run's "
                    f"{measured} ITC-measured steps; the deepest lag "
                    f"rows will never fill (their F(k, tau) comes out "
                    f"NaN)", UserWarning)
        if self.cm_diffusion_spec is not None:
            wb = self.cm_diffusion_spec.window_blocks
            if wb is not None:
                wb = int(wb)
                measured = self.num_blocks
                if wb < 1 or measured % wb:
                    raise ValueError(
                        "cm_diffusion_spec.window_blocks must divide "
                        "num_blocks")
        for name, spec in (("density_spec", self.density_spec),
                           ("ssf_spec", self.ssf_spec),
                           ("obd_spec", self.obd_spec),
                           ("pair_corr_spec", self.pair_corr_spec),
                           ("itc_spec", self.itc_spec)):
            every = self.est_every
            if name in ("obd_spec", "pair_corr_spec", "itc_spec") \
                    and spec is not None:
                mult = int(spec.est_every_mult)
                if mult < 1:
                    raise ValueError(
                        f"{name}: est_every_mult must be a positive "
                        f"integer")
                every *= mult
                if self.num_time_steps_block % every:
                    raise ValueError(
                        f"{name}: num_time_steps_block must be "
                        f"divisible by est_every * est_every_mult")
            pfw = getattr(spec, "pfw_num_time_steps", None)
            if pfw is None:
                continue
            pfw = int(pfw)
            if not spec.as_pure_est:
                raise ValueError(
                    f"{name}: pfw_num_time_steps only applies to pure "
                    f"(forward-walking) estimators")
            if pfw > self.num_time_steps_block:
                # Multi-block forward-walking windows: supported when
                # the window tiles the run (pfw a multiple of the block
                # length, the window count dividing num_blocks) — the
                # pure accumulators then persist across blocks and only
                # window-final blocks contribute statistics samples.
                # Non-conforming values clamp to one block with a
                # warning (the reference SILENTLY pins the window to
                # one block, ``mrbp_qmc/dmc_exec/proc.py:337``, and its
                # own committed configs carry such values).
                w_blocks = pfw // self.num_time_steps_block
                if pfw % self.num_time_steps_block \
                        or self.num_blocks % w_blocks:
                    warnings.warn(
                        f"{name}: pfw_num_time_steps={pfw} does not "
                        f"tile the run ({self.num_blocks} x "
                        f"{self.num_time_steps_block}); clamping to "
                        f"one block (the reference's only behavior)",
                        UserWarning)
                    pfw = self.num_time_steps_block
                    object.__setattr__(
                        self, name,
                        replace(spec, pfw_num_time_steps=pfw))
                    spec = getattr(self, name)
            if pfw <= 0:
                raise ValueError(
                    f"{name}: pfw_num_time_steps must be in "
                    f"(0, num_blocks * num_time_steps_block]")
            if pfw % every:
                raise ValueError(
                    f"{name}: pfw_num_time_steps must be divisible by "
                    f"est_every (x est_every_mult for the OBDM)")
        # All pure estimators share ONE forward-walking window (the
        # longest): estimators with shorter pfw freeze at their own
        # horizon and keep ancestry-transporting to the shared window
        # end (extra projection — valid forward walking), but they then
        # contribute one statistics sample per SHARED window.  Make
        # that audible when windows mix.
        windows = set()
        nts = self.num_time_steps_block
        for spec in (self.density_spec, self.ssf_spec, self.obd_spec,
                     self.pair_corr_spec, self.itc_spec):
            if spec is None or not spec.as_pure_est:
                continue
            pfw = spec.pfw_num_time_steps
            pfw = int(pfw) if pfw else nts
            windows.add(max(1, pfw // nts) if pfw % nts == 0 else 1)
        if len(windows) > 1:
            warnings.warn(
                f"pure estimators request different forward-walking "
                f"windows ({sorted(windows)} blocks); all share the "
                f"longest ({max(windows)} blocks) and contribute one "
                f"statistics sample per shared window", UserWarning)

    # -- config plumbing -----------------------------------------------------

    @classmethod
    def from_config(cls, config: t.Mapping) -> "Proc":
        """Build from a config mapping, honoring the reference's
        deprecated aliases (``mrbp_qmc/dmc_exec/proc.py:223-293``)."""
        self_config = dict(config)
        for old, new in (("num_batches", "num_blocks"),
                         ("num_time_steps_batch", "num_time_steps_block"),
                         ("burn_in_batches", "burn_in_blocks")):
            if old in self_config:
                warnings.warn(f"{old} attribute is deprecated, use {new} "
                              f"instead", DeprecationWarning)
                self_config[new] = self_config.pop(old)
        # numba-specific knobs accepted and ignored for config compat.
        for numba_only in ("jit_parallel", "jit_fastmath", "parallel",
                           "fastmath"):
            self_config.pop(numba_only, None)

        model_spec = mrbp.Spec(**self_config.pop("model_spec"))
        density_config = self_config.pop("density_spec", None)
        density_spec = DensityEstSpec(**density_config) \
            if density_config is not None else None
        ssf_config = self_config.pop("ssf_spec", None)
        ssf_spec = SSFEstSpec(**ssf_config) \
            if ssf_config is not None else None
        obd_config = self_config.pop("obd_spec", None)
        obd_spec = OBDEstSpec(**obd_config) \
            if obd_config is not None else None
        g2_config = self_config.pop("pair_corr_spec", None)
        pair_corr_spec = PairCorrEstSpec(**g2_config) \
            if g2_config is not None else None
        cmd_config = self_config.pop("cm_diffusion_spec", None)
        cm_diffusion_spec = CMDiffusionEstSpec(**cmd_config) \
            if cmd_config is not None else None
        itc_config = self_config.pop("itc_spec", None)
        itc_spec = ITCEstSpec(**itc_config) \
            if itc_config is not None else None
        return cls(model_spec=model_spec, density_spec=density_spec,
                   ssf_spec=ssf_spec, obd_spec=obd_spec,
                   pair_corr_spec=pair_corr_spec,
                   cm_diffusion_spec=cm_diffusion_spec,
                   itc_spec=itc_spec, **self_config)

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
            "time_step": self.time_step,
            "max_num_walkers": self.max_num_walkers,
            "target_num_walkers": self.target_num_walkers,
            "num_walkers_control_factor": self.num_walkers_control_factor,
            "rng_seed": self.rng_seed,
            "num_blocks": self.num_blocks,
            "num_time_steps_block": self.num_time_steps_block,
            "burn_in_blocks": self.burn_in_blocks,
            "keep_iter_data": self.keep_iter_data,
            "block_offset": self.block_offset,
            "dtype": self.dtype,
            "num_mesh_devices": self.num_mesh_devices,
            "rebalance_every": self.rebalance_every,
            "est_every": self.est_every,
        }
        if self.model_spec.obf_lattice_depth is not None:
            config["model_spec"]["obf_lattice_depth"] = \
                self.model_spec.obf_lattice_depth
        def _est_config(spec, size_key, size_val):
            est = {size_key: size_val, "as_pure_est": spec.as_pure_est}
            if spec.pfw_num_time_steps is not None:
                est["pfw_num_time_steps"] = spec.pfw_num_time_steps
            return est

        if self.density_spec is not None:
            config["density_spec"] = _est_config(
                self.density_spec, "num_bins", self.density_spec.num_bins)
        if self.ssf_spec is not None:
            config["ssf_spec"] = _est_config(
                self.ssf_spec, "num_modes", self.ssf_spec.num_modes)
        if self.obd_spec is not None:
            config["obd_spec"] = _est_config(
                self.obd_spec, "num_pos", self.obd_spec.num_pos)
            if self.obd_spec.est_every_mult != 1:
                config["obd_spec"]["est_every_mult"] = \
                    self.obd_spec.est_every_mult
        if self.pair_corr_spec is not None:
            config["pair_corr_spec"] = _est_config(
                self.pair_corr_spec, "num_bins",
                self.pair_corr_spec.num_bins)
            if self.pair_corr_spec.est_every_mult != 1:
                config["pair_corr_spec"]["est_every_mult"] = \
                    self.pair_corr_spec.est_every_mult
        if self.cm_diffusion_spec is not None:
            config["cm_diffusion_spec"] = {
                # 0 encodes "whole run" (None is not an HDF5 attr).
                "window_blocks":
                    self.cm_diffusion_spec.window_blocks or 0,
            }
        if self.itc_spec is not None:
            config["itc_spec"] = {
                "num_modes": self.itc_spec.num_modes,
                "num_lags": self.itc_spec.num_lags,
            }
            if self.itc_spec.est_every_mult != 1:
                config["itc_spec"]["est_every_mult"] = \
                    self.itc_spec.est_every_mult
            if self.itc_spec.as_pure_est:
                config["itc_spec"]["as_pure_est"] = True
                if self.itc_spec.pfw_num_time_steps:
                    config["itc_spec"]["pfw_num_time_steps"] = \
                        self.itc_spec.pfw_num_time_steps
        return {k: v for k, v in config.items() if v is not None}

    def evolve(self, config: t.Mapping) -> "Proc":
        """A new Proc with updated fields - for continuation runs
        (``mrbp_qmc/dmc_exec/proc.py:302-329``)."""
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
        itc_spec = self.itc_spec
        itc_config = self_config.pop("itc_spec", None)
        if itc_config is not None:
            itc_spec = ITCEstSpec(**itc_config) if itc_spec is None \
                else replace(itc_spec, **itc_config)
        return replace(self, model_spec=model_spec, ssf_spec=ssf_spec,
                       obd_spec=obd_spec, pair_corr_spec=pair_corr_spec,
                       itc_spec=itc_spec, **self_config)

    # -- sampling ------------------------------------------------------------

    @property
    def should_eval_cm_diffusion(self) -> bool:
        return self.cm_diffusion_spec is not None

    def _pfw(self, spec) -> int:
        """Pure-estimator forward-walking window: the configured
        ``pfw_num_time_steps``, default one block (the reference's only
        behavior, ``mrbp_qmc/dmc_exec/proc.py:331-365``)."""
        return int(spec.pfw_num_time_steps
                   or self.num_time_steps_block)

    def mesh_spec(self, device="cuda"):
        """The walker mesh of ``num_mesh_devices`` on ``device``'s kind
        (``None`` unsharded): ranks on ``cuda:0..n-1`` over NCCL, or on
        the CPU over gloo."""
        return sharded.mesh_spec(self.num_mesh_devices, device)

    @cached_property
    def sampling(self) -> dmc_sampler.Sampling:
        """The bound sampler (``mrbp_qmc/dmc_exec/proc.py:331-365``),
        unsharded: a run on a mesh gives each rank its own with the
        rank's mesh."""
        density_est_spec = dmc_sampler.DensityEstSpec(
            self.density_spec.num_bins, self.density_spec.as_pure_est,
            self._pfw(self.density_spec)) \
            if self.should_eval_density else None
        ssf_est_spec = dmc_sampler.SSFEstSpec(
            self.ssf_spec.num_modes, self.ssf_spec.as_pure_est,
            self._pfw(self.ssf_spec)) if self.should_eval_ssf else None
        obd_est_spec = dmc_sampler.OBDEstSpec(
            self.obd_spec.num_pos, self.obd_spec.as_pure_est,
            self._pfw(self.obd_spec),
            est_every_mult=self.obd_spec.est_every_mult) \
            if self.should_eval_obd else None
        pair_corr_est_spec = dmc_sampler.PairCorrEstSpec(
            self.pair_corr_spec.num_bins,
            self.pair_corr_spec.as_pure_est,
            self._pfw(self.pair_corr_spec),
            est_every_mult=self.pair_corr_spec.est_every_mult) \
            if self.should_eval_pair_corr else None
        itc_est_spec = dmc_sampler.ITCEstSpec(
            self.itc_spec.num_modes, self.itc_spec.num_lags,
            est_every_mult=self.itc_spec.est_every_mult,
            as_pure_est=self.itc_spec.as_pure_est,
            pfw_num_time_steps=(self._pfw(self.itc_spec)
                                if self.itc_spec.as_pure_est
                                else None)) \
            if self.should_eval_itc else None
        cmd = self.cm_diffusion_spec
        return dmc_sampler.Sampling(
            self.model_spec, self.time_step, self.max_num_walkers,
            self.target_num_walkers, self.num_walkers_control_factor,
            self.rng_seed, density_est_spec=density_est_spec,
            ssf_est_spec=ssf_est_spec, obd_est_spec=obd_est_spec,
            pair_corr_est_spec=pair_corr_est_spec,
            itc_est_spec=itc_est_spec,
            est_every=self.est_every,
            cm_diffusion_est=cmd is not None,
            cm_window_blocks=(cmd.window_blocks
                              if cmd is not None else 1),
            rebalance_every=self.rebalance_every)

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
        exec_logger.info("* Variational parameters:")
        exec_logger.info(f"  * RM: {spec.tbf_contact_cutoff:.3G} LKP")

    def describe_sampling(self):
        exec_logger.info(
            f"Using an imaginary time step of {self.time_step}...")
        exec_logger.info(f"Sampling {self.num_blocks} blocks of steps...")
        exec_logger.info(
            f"Sampling {self.num_time_steps_block} steps per block...")
        exec_logger.info(
            f"The first {self.burn_in_blocks} blocks of the sampling "
            f"will be discarded for statistics...")
        exec_logger.info(
            f"Targeting an average of {self.target_num_walkers} random "
            f"walkers, with a maximum number of "
            f"{self.max_num_walkers} walkers...")

    def build_result(self, state: dmc_sampler.State,
                     sampling_data: dmc_data.SamplingData) -> ProcResult:
        return ProcResult(state, self, sampling_data)

    def _checkpoint_input(self, state, blocks_completed: int,
                          it_offset: int, it_burn: int, it_next: int,
                          aux: t.Optional[dict] = None,
                          accum: "t.Optional[_BlockAccumulator]" = None,
                          sampling: t.Optional[dmc_sampler.Sampling] = None
                          ) -> ProcInput:
        """The input that resumes this run after ``blocks_completed``
        blocks: the walker state and, as ``resume``, the COMPLETE
        measurement state — the accumulator's completed-block data
        (props series, mixed estimator reductions, pure window samples,
        window weights, window-phase origin), the pure-estimator
        forward-walking carry of a window straddling the cut (tensors on
        the state's device), and the block-stream position of the
        sampler iterator.  The CM-diffusion accumulator and the ITC ring
        buffer ride the state.  ``exec`` on it reproduces the
        uninterrupted run bit-exactly: the block streams are functions
        of ``(rng_seed, offset + idx)`` alone.

        With ``checkpoint_light`` the ITC ring buffer and its
        forward-walking pair are dropped: the resume restarts the lag
        fill (discounted by the counts, bias-free).  The paired
        sums/counts carry must drop TOGETHER so the window sample's
        ratio stays unbiased.  A cadence rebalance that the sampler
        (``sampling``, this procedure's by default) holds until its
        window's start is recorded as ``rebalance_pending``."""
        if self.checkpoint_light and state.itc_buf is not None:
            state = state._replace(itc_buf=None, itc_filled=None)
            if aux is not None:
                aux = {name: arr for name, arr in aux.items()
                       if name not in ("aux_itc", "aux_itc_cnt")}
        resume = {
            "blocks_completed": int(blocks_completed),
            "it_offset": int(it_offset),
            "it_burn": int(it_burn),
            "it_next": int(it_next),
            "rebalance_pending": _outstanding_rebalance(
                sampling or self.sampling, it_burn, it_next,
                self.num_time_steps_block),
        }
        if aux is not None:
            resume["aux"] = dict(aux)
        if accum is not None:
            resume["accum"] = accum.snapshot()
        return ProcInput(state, resume=resume)

    def _write_checkpoint(self, resume_input: ProcInput):
        """Atomic full-state checkpoint: write to a temp file, rename.

        Schema v2 (see docs/PARITY.md), the JAX package's own: the
        walker state, the ORIGINAL proc_spec and the resume payload of
        :meth:`_checkpoint_input`, so ``restore_checkpoint`` + ``exec``
        reproduces the uninterrupted run bit-exactly; exec resumes at
        block ``blocks_completed``.  Exceeds the upstream library's
        resume (walker state only, ``qmc_exec/dmc/io.py:35-80``).
        """
        import h5py

        from . import io as io_mod

        handler = io_mod.DmcHDF5FileHandler(self.checkpoint_file,
                                            group="checkpoint",
                                            dump_replace=True)
        config = self.as_config()
        resume = resume_input.resume
        tmp_path = f"{self.checkpoint_file}.tmp"
        with h5py.File(tmp_path, "w") as fp:
            handler.save_state(resume_input.state, fp.require_group(
                "checkpoint/dmc/state"))
            handler.save_proc(config, fp.require_group(
                "checkpoint/dmc/proc_spec"))
            rg = fp.require_group("checkpoint/dmc/resume")
            rg.attrs["schema"] = 2
            for name in ("blocks_completed", "it_offset", "it_burn",
                         "it_next"):
                rg.attrs[name] = int(resume[name])
            rg.attrs["rebalance_pending"] = bool(
                resume["rebalance_pending"])
            if "aux" in resume:
                ag = rg.require_group("aux")
                for name, arr in resume["aux"].items():
                    ag.create_dataset(name, data=arr.cpu().numpy())
            if "accum" in resume:
                _BlockAccumulator.write_snapshot(
                    resume["accum"], rg.require_group("accum"))
        os.replace(tmp_path, self.checkpoint_file)
        exec_logger.info(f"checkpoint written to {self.checkpoint_file}")

    @classmethod
    def restore_checkpoint(cls, checkpoint_file: str, device="cuda") \
            -> t.Tuple["Proc", ProcInput]:
        """Load a mid-run checkpoint, this package's or the JAX
        package's: ``(proc, proc_input)`` ready for ``proc.exec``, the
        state on ``device``.

        Schema-v2 checkpoints resume the interrupted run bit-exactly
        (full measurement state; see :meth:`_checkpoint_input`).
        Legacy v1 checkpoints stored a continuation proc_spec and only
        the walker state — they still load, but estimator windows
        reopen fresh at the resume point (logged)."""
        import h5py

        from . import io as io_mod

        handler = io_mod.DmcHDF5FileHandler(checkpoint_file,
                                            group="checkpoint")
        with h5py.File(checkpoint_file, "r") as fp:
            state = handler.load_state(fp.get("checkpoint/dmc/state"),
                                       device=device)
            proc = handler.load_proc(fp.get("checkpoint/dmc/proc_spec"))
            rg = fp.get("checkpoint/dmc/resume")
            if rg is None:
                # Legacy (v1) checkpoint: continuation semantics.
                if proc.sampling.pfw_window_blocks(
                        proc.num_time_steps_block) > 1 \
                        or proc.should_eval_cm_diffusion:
                    exec_logger.warning(
                        "legacy checkpoint (walker state only): "
                        "estimator windows reopen FRESH at the resume "
                        "point — the interrupted window contributes "
                        "no sample and window phase restarts; "
                        "re-checkpoint with this version for seamless "
                        "mid-window resume")
                return proc, ProcInput(state)
            resume = {
                "blocks_completed": int(rg.attrs["blocks_completed"]),
                "it_offset": int(rg.attrs["it_offset"]),
                "it_burn": int(rg.attrs["it_burn"]),
                "it_next": int(rg.attrs["it_next"]),
                "rebalance_pending": bool(
                    rg.attrs.get("rebalance_pending", False)),
            }
            ag = rg.get("aux")
            if ag is not None:
                resume["aux"] = {name: ag[name][()] for name in ag}
            acg = rg.get("accum")
            if acg is not None:
                resume["accum"] = _BlockAccumulator.load_snapshot(acg)
        return proc, ProcInput(state, resume=resume)

    # -- the run loop -----------------------------------------------------------

    def exec(self, proc_input: ProcInput,
             checkpoint_hook: t.Optional[t.Callable[[ProcInput], None]]
             = None, mesh=None) -> ProcResult:
        """Run the DMC sampling on the device of ``proc_input.state``
        (the upstream library's loop: ``qmc_exec/dmc/proc.py:136-415``).

        Every ``checkpoint_every`` blocks the resume input of
        :meth:`_checkpoint_input` is written to ``checkpoint_file``,
        when one is set, and handed to ``checkpoint_hook``, when one is
        given: an in-memory checkpoint for a caller without a file.

        With ``num_mesh_devices`` the walkers shard over
        :meth:`mesh_spec` of the state's device, or over ``mesh`` (a
        ``phd_qmclib_torch.parallel.MeshSpec``, e.g. S gloo ranks on
        one card), one process per rank: the state given is the global
        view (any shard count: it is re-laid out), and so are the
        result's state, the checkpoints and the files.  A shard whose
        population collapses restarts the stream from a rebalanced
        state, with the JAX package's warning."""
        if not isinstance(proc_input, ProcInput):
            raise proc_base.ProcInputError(
                "DMC procedure input must be a dmc ProcInput instance")
        if mesh is None:
            mesh = self.mesh_spec(proc_input.state.pos.device)
        if mesh is None:
            return self._exec(proc_input, checkpoint_hook)
        return sharded.exec_on_mesh(self, proc_input, mesh, checkpoint_hook)

    def _exec(self, proc_input: ProcInput,
              checkpoint_hook: t.Optional[t.Callable[[ProcInput], None]]
              = None, mesh=None, on_checkpoint=None) -> ProcResult:
        """:meth:`exec` on one device, or on the rank ``mesh`` (a
        ``WalkerMesh``) of a walker mesh, where rank 0 writes the
        checkpoint file and calls ``checkpoint_hook``.  ``on_checkpoint``
        (a fused sweep's, on every rank) takes each checkpoint's resume
        input instead."""
        num_blocks = self.num_blocks
        nts_block = self.num_time_steps_block
        burn_in_blocks = self.burn_in_blocks
        keep_iter_data = self.keep_iter_data
        should_eval_density = self.should_eval_density
        should_eval_ssf = self.should_eval_ssf
        should_eval_obd = self.should_eval_obd
        should_eval_cmd = self.should_eval_cm_diffusion
        should_eval_g2 = self.should_eval_pair_corr
        should_eval_itc = self.should_eval_itc

        exec_logger.info("Starting DMC sampling...")
        self.describe_model_spec()
        self.describe_sampling()

        sampling = self.sampling
        if mesh is not None:
            sampling = replace(sampling, mesh=mesh)
        # The sampler-iterator stream position, tracked so mid-run
        # checkpoints can record it and a shard-collapse restart can
        # advance it: block streams are keyed by ``(seed, it_offset +
        # internal_idx)`` and ``it_offset + it_next`` always points at
        # the next unconsumed stream position.
        resume = proc_input.resume
        start_block = 0
        if resume is not None:
            start_block = int(resume["blocks_completed"])
            it_offset = int(resume["it_offset"])
            it_burn = int(resume["it_burn"])
            it_next = int(resume["it_next"])
            blocks_iter = sampling.blocks(
                proc_input.state, nts_block, burn_in_blocks=it_burn,
                block_offset=it_offset, start_block_idx=it_next,
                aux_init=resume.get("aux"),
                rebalance_pending0=resume.get("rebalance_pending", False))
            exec_logger.info(
                f"resuming from a mid-run checkpoint at block "
                f"{start_block}/{num_blocks} (full measurement state: "
                f"window phases, pure-estimator carries and the "
                f"random stream continue seamlessly)")
        else:
            it_offset = self.block_offset
            it_burn = burn_in_blocks
            it_next = 0
            blocks_iter = sampling.blocks(proc_input.state, nts_block,
                                          burn_in_blocks,
                                          block_offset=self.block_offset)

        if burn_in_blocks and resume is None:
            exec_logger.info("Computing DMC burn-in stage...")
            burn_iter = range(burn_in_blocks)
            if self.verbose:
                import tqdm
                burn_iter = tqdm.tqdm(burn_iter, dynamic_ncols=True)
            for _ in burn_iter:
                next(blocks_iter)
                it_next += 1
            exec_logger.info("Burn-in stage completed.")
        elif resume is None:
            exec_logger.info("No burn-in blocks requested.")

        # Accumulators shaped by keep_iter_data
        # (``qmc_exec/dmc/proc.py:202-255``).
        accumulator = _BlockAccumulator(self)
        if resume is not None and "accum" in resume:
            accumulator.restore(resume["accum"])

        exec_logger.info("Starting the evaluation of estimators...")
        log_every = max(1, num_blocks // 8)
        t_start = time.perf_counter()
        total_walker_steps = 0.0
        block_data = None
        checkpointing = self.checkpoint_file is not None \
            or checkpoint_hook is not None or on_checkpoint is not None
        writer = mesh is None or mesh.rank == 0
        num_rebalances = 0
        for block_idx in range(start_block, num_blocks):
            if block_idx == 0 and self.profile_dir is not None:
                block_data = self._profiled_block(blocks_iter)
            else:
                block_data = next(blocks_iter)
            it_next += 1
            shard_nw = None if mesh is None or mesh.size == 1 \
                else _shard_counts(mesh, block_data.last_state)
            if shard_nw is not None and shard_nw.min() <= 0:
                # Per-shard combs cannot repopulate an empty shard; a
                # collapsed shard silently biases the global ensemble
                # while the controller only sees the global weight.
                # Remediate immediately: redistribute the surviving
                # walkers evenly across the shards and continue the run
                # from the rebalanced state (same RNG stream position).
                # Every rank decides from the same gathered counts.
                balanced = sampling.rebalance(
                    mesh.gather_state(block_data.last_state))
                it_offset = it_offset + it_next
                it_burn = 0
                it_next = 0
                blocks_iter = sampling.blocks(
                    balanced, nts_block, burn_in_blocks=0,
                    block_offset=it_offset)
                block_data = block_data._replace(
                    last_state=sampling._shard_of(balanced)[0])
                # The restarted iterator opens a fresh forward-walking
                # window at the next block; realign the accumulator's
                # window phase so partial windows are DROPPED instead
                # of being stored as under-projected samples.
                accumulator.restart_window(block_idx + 1)
                num_rebalances += 1
                if num_rebalances <= 3:
                    exec_logger.warning(
                        f"walker population collapsed on a shard "
                        f"(per-shard counts {shard_nw.tolist()}); "
                        f"rebalanced the surviving walkers evenly "
                        f"across shards and resumed"
                        + (" (forward-walking window restarted; the "
                           "interrupted window contributes no sample)"
                           if accumulator.window > 1 else "")
                        + ". Consider rebalance_every or a larger "
                        f"target_num_walkers.")
            bp = block_data.iter_props
            energy = np.asarray(bp.energy, dtype=np.float64)
            weight = np.asarray(bp.weight, dtype=np.float64)
            num_walkers = np.asarray(bp.num_walkers, dtype=np.float64)
            ref_energy = np.asarray(bp.ref_energy, dtype=np.float64)
            accum_energy = np.asarray(bp.accum_energy, dtype=np.float64)
            accumulator.add(
                block_idx, energy, weight, num_walkers, ref_energy,
                accum_energy,
                iter_density=(np.asarray(block_data.iter_density,
                                         dtype=np.float64)
                              if should_eval_density else None),
                iter_ssf=(np.asarray(block_data.iter_ssf,
                                     dtype=np.float64)
                          if should_eval_ssf else None),
                iter_obd=(np.asarray(block_data.iter_obd,
                                     dtype=np.float64)
                          if should_eval_obd else None),
                iter_cmd=(np.asarray(block_data.iter_cmd,
                                     dtype=np.float64)
                          if should_eval_cmd else None),
                iter_g2=(np.asarray(block_data.iter_g2,
                                    dtype=np.float64)
                         if should_eval_g2 else None),
                iter_itc=(np.asarray(block_data.iter_itc,
                                     dtype=np.float64)
                          if should_eval_itc else None),
                iter_itc_nw=(np.asarray(block_data.iter_itc_nw,
                                        dtype=np.float64)
                             if should_eval_itc else None))

            if checkpointing and \
                    (block_idx + 1) % self.checkpoint_every == 0:
                state, aux = block_data.last_state, block_data.aux_carry
                if mesh is not None:
                    # The global view: every rank takes part.
                    state = mesh.gather_state(state)
                    aux = None if aux is None else {
                        name: mesh.cat(value) for name, value in aux.items()}
                resume_input = self._checkpoint_input(
                    state, blocks_completed=block_idx + 1,
                    it_offset=it_offset, it_burn=it_burn,
                    it_next=it_next, aux=aux, accum=accumulator,
                    sampling=sampling)
                if on_checkpoint is not None:
                    on_checkpoint(resume_input)
                elif writer:
                    if self.checkpoint_file is not None:
                        self._write_checkpoint(resume_input)
                    if checkpoint_hook is not None:
                        checkpoint_hook(resume_input)

            # Throughput observability (absent in the upstream
            # library).
            total_walker_steps += float(num_walkers.sum())
            if (block_idx + 1) % log_every == 0 or \
                    block_idx + 1 == num_blocks:
                elapsed = time.perf_counter() - t_start
                exec_logger.info(
                    f"block {block_idx + 1}/{num_blocks}: "
                    f"E/N = {accum_energy[-1] / self.model_spec.boson_number:.6G}, "
                    f"<walkers> = {num_walkers.mean():.0f}, "
                    f"{total_walker_steps / elapsed:,.0f} walker-steps/s")

        exec_logger.info("Evaluation of estimators completed.")
        exec_logger.info("DMC sampling completed.")

        if block_data is None:
            last_state = proc_input.state
        elif mesh is None:
            last_state = block_data.last_state
        else:
            last_state = mesh.gather_state(block_data.last_state)
        return self.build_result(last_state, accumulator.package())

    def _profiled_block(self, blocks_iter):
        """The next block under a ``torch.profiler`` trace exported to
        ``profile_dir`` — traced in place (not as a discarded probe) so
        it still contributes statistics and the forward-walking window
        phase stays aligned."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            block_data = next(blocks_iter)
            device = block_data.last_state.pos.device
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, "dmc_block0.trace.json"))
        exec_logger.info(f"profiler trace written to "
                         f"{self.profile_dir}")
        return block_data


def _shard_counts(mesh, state) -> np.ndarray:
    """The walker count of every shard of ``mesh`` after a block, whose
    last ``state`` is the rank's shard: every rank gets every count."""
    return torch.stack(mesh.all_gather(
        state.num_walkers.reshape(()))).cpu().numpy()


def _outstanding_rebalance(sampling, it_burn: int, it_next: int,
                           nts_block: int) -> bool:
    """Whether the block generator holds a cadence rebalance deferred
    to the next forward-walking window boundary, reconstructed from
    the iterator position alone (mirrors the pending/clear logic of
    :meth:`phd_qmclib_torch.samplers.dmc.Sampling.blocks`): pending is
    set at internal blocks ``j > 0`` with ``j % rebalance_every == 0``
    and cleared (executed) at every block ``b <= it_burn`` or ``(b -
    it_burn) % pfw_window == 0``.  Needed so a checkpoint cut between a
    cadence point and its window boundary re-arms the rebalance on
    resume.  The JAX package's function."""
    re_every = sampling.rebalance_every if sampling.num_shards > 1 \
        else None
    if not re_every:
        return False
    p = it_next - 1  # last internal block already processed
    if p < 1:
        return False
    window = sampling.pfw_window_blocks(nts_block)
    if p <= it_burn:
        b_star = p
    else:
        b_star = it_burn + ((p - it_burn) // window) * window
    j_max = (p // re_every) * re_every
    return j_max > 0 and j_max > b_star


class _BlockAccumulator:
    """Per-block reductions + result packaging of one DMC procedure
    (``qmc_exec/dmc/proc.py:202-255, 273-356``), factored out of
    :meth:`Proc.exec` so that a fused parameter sweep can run one
    accumulator per sweep row over a single fused block stream.  Pure
    NumPy, a copy of the JAX package's accumulator."""

    def __init__(self, proc: "Proc"):
        self.proc = proc
        num_blocks = proc.num_blocks
        nts_block = proc.num_time_steps_block
        keep = proc.keep_iter_data
        # Forward-walking windows may span several blocks; pure
        # estimators then contribute ONE statistics sample per window
        # (the end-of-window value; interior blocks are partial sums).
        # Samples collect in lists keyed by estimator name so the
        # window phase can RESTART mid-run (a restarted block stream
        # reopens the window; the interrupted window contributes no
        # sample).
        self.window = proc.sampling.pfw_window_blocks(nts_block)
        self.win_origin = 0
        self.pure_samples = {}
        self.win_weights = []
        shape = (num_blocks, nts_block) if keep else (num_blocks,)
        # Estimator series carry one entry per MEASURED step.
        num_measured = nts_block // proc.est_every

        def _est_rows(as_pure):
            if keep:
                return (num_blocks, num_measured)
            return None if as_pure else (num_blocks,)

        def _alloc(rows, tail, as_pure, name):
            if as_pure:
                self.pure_samples[name] = []
            if rows is None:
                return None
            return np.zeros(rows + tail)

        self.props = {name: np.zeros(shape) for name in
                      ("energy", "weight", "num_walkers", "ref_energy",
                       "accum_energy")}
        self.density_blocks_data = None
        self.ssf_blocks_data = None
        self.obd_blocks_data = None
        if proc.should_eval_density:
            self.density_blocks_data = _alloc(
                _est_rows(proc.density_spec.as_pure_est),
                (proc.density_spec.num_bins,),
                proc.density_spec.as_pure_est, "density")
        if proc.should_eval_ssf:
            self.ssf_blocks_data = _alloc(
                _est_rows(proc.ssf_spec.as_pure_est),
                (proc.ssf_spec.num_modes, 3),
                proc.ssf_spec.as_pure_est, "ssf")
        if proc.should_eval_obd:
            # The OBDM carries its own (sparser) cadence.
            num_measured_obd = nts_block // (proc.est_every
                                             * proc.obd_spec.est_every_mult)
            obd_rows = (num_blocks, num_measured_obd) if keep \
                else _est_rows(proc.obd_spec.as_pure_est)
            self.obd_blocks_data = _alloc(
                obd_rows, (proc.obd_spec.num_pos,),
                proc.obd_spec.as_pure_est, "obd")
        self.g2_blocks_data = None
        if proc.should_eval_pair_corr:
            num_measured_g2 = nts_block // (
                proc.est_every * proc.pair_corr_spec.est_every_mult)
            g2_rows = (num_blocks, num_measured_g2) if keep \
                else _est_rows(proc.pair_corr_spec.as_pure_est)
            self.g2_blocks_data = _alloc(
                g2_rows, (proc.pair_corr_spec.num_bins,),
                proc.pair_corr_spec.as_pure_est, "g2")
        self.itc_sums_data = None
        self.itc_counts_data = None
        self.itc_series_data = None
        self.itc_nw_series_data = None
        if proc.should_eval_itc:
            if proc.itc_spec.as_pure_est:
                # Forward-walked ITC: one (lag-sums, lag-counts)
                # statistics sample per pure-estimator window, like
                # the other pure estimators (the counts sample rides
                # along — it is the descendant-weighted denominator,
                # so no ``win_weights`` weighting applies here).
                self.pure_samples["itc"] = []
                self.pure_samples["itc_nw"] = []
            else:
                # Per-block lag-sum/count totals (blocks are the
                # decorrelation unit; the ring buffer itself rides the
                # sampler State).
                self.itc_sums_data = np.zeros(
                    (num_blocks, proc.itc_spec.num_lags + 1,
                     proc.itc_spec.num_modes))
                self.itc_counts_data = np.zeros(
                    (num_blocks, proc.itc_spec.num_lags + 1))
                if keep:
                    # Full per-measured-step series (keep_iter_data),
                    # like every other mixed estimator.
                    nts_itc = nts_block // (proc.est_every
                                            * proc.itc_spec
                                            .est_every_mult)
                    self.itc_series_data = np.zeros(
                        (num_blocks, nts_itc,
                         proc.itc_spec.num_lags + 1,
                         proc.itc_spec.num_modes))
                    self.itc_nw_series_data = np.zeros(
                        (num_blocks, nts_itc,
                         proc.itc_spec.num_lags + 1))
        self.cmd_w2_data = None
        self.cmd_raw_data = None
        if proc.should_eval_cm_diffusion:
            # Ensemble <W_cm^2> per measured step, per block; windows
            # are stitched from consecutive blocks in package().
            self.cmd_w2_data = np.zeros((num_blocks, num_measured))
            if keep:
                self.cmd_raw_data = np.zeros(
                    (num_blocks, num_measured, 2))
        self.pure_est_reduce_factor = np.ones(num_blocks)
        # Mixed-estimator normalization under a measurement cadence:
        # the sum of the measured steps\' weights per block.
        self.est_weight_totals = np.zeros(num_blocks) \
            if proc.est_every > 1 and not keep else None
        self.obd_weight_totals = np.zeros(num_blocks) \
            if (proc.should_eval_obd and not keep
                and proc.est_every * proc.obd_spec.est_every_mult > 1) \
            else None
        self.g2_weight_totals = np.zeros(num_blocks) \
            if (proc.should_eval_pair_corr and not keep
                and proc.est_every
                * proc.pair_corr_spec.est_every_mult > 1) \
            else None

    def restart_window(self, next_block_idx: int):
        """Realign the forward-walking window phase after the sampler
        stream was restarted: the next
        block opens a fresh window; the interrupted window contributes
        no statistics sample."""
        self.win_origin = next_block_idx

    #: Optional per-estimator arrays captured by checkpoints (None
    #: entries are skipped; shapes are fixed by the proc config so a
    #: restore into the same config round-trips exactly).
    _SNAPSHOT_ARRAYS = ("density_blocks_data", "ssf_blocks_data",
                        "obd_blocks_data", "g2_blocks_data",
                        "cmd_w2_data", "cmd_raw_data",
                        "itc_sums_data", "itc_counts_data",
                        "itc_series_data", "itc_nw_series_data",
                        "pure_est_reduce_factor", "est_weight_totals",
                        "obd_weight_totals", "g2_weight_totals")

    def save_snapshot(self, group):
        """Write the complete accumulator state (completed-block data,
        window samples/weights/phase) to an HDF5 group — the
        measurement half of a mid-run checkpoint (schema v2)."""
        self.write_snapshot(self.snapshot(), group)

    def snapshot(self) -> dict:
        """The complete accumulator state as the payload of
        :meth:`restore` (what :meth:`load_snapshot` reads back from a
        file): copies, since the accumulator goes on folding blocks."""
        pure = {name: (np.stack(samples) if samples else np.zeros(0))
                for name, samples in self.pure_samples.items()}
        return {
            "win_origin": int(self.win_origin),
            "win_weights": np.asarray(self.win_weights, dtype=np.float64),
            "props": {name: arr.copy()
                      for name, arr in self.props.items()},
            "arrays": {name: getattr(self, name).copy()
                       for name in self._SNAPSHOT_ARRAYS
                       if getattr(self, name) is not None},
            "pure_samples": pure,
        }

    @staticmethod
    def write_snapshot(payload: dict, group):
        """Write a :meth:`snapshot` payload in :meth:`save_snapshot`'s
        layout."""
        group.attrs["win_origin"] = int(payload["win_origin"])
        group.create_dataset("win_weights", data=payload["win_weights"])
        for key in ("props", "arrays", "pure_samples"):
            sub = group.require_group(key)
            for name, arr in payload[key].items():
                sub.create_dataset(name, data=arr)

    @staticmethod
    def load_snapshot(group) -> dict:
        """Inverse of :meth:`save_snapshot`: a payload dict for
        :meth:`restore`."""
        payload = {
            "win_origin": int(group.attrs["win_origin"]),
            "win_weights": group["win_weights"][()],
            "props": {name: ds[()]
                      for name, ds in group["props"].items()},
            "arrays": {name: ds[()]
                       for name, ds in group["arrays"].items()},
            "pure_samples": {name: ds[()]
                             for name, ds in
                             group["pure_samples"].items()},
        }
        return payload

    def restore(self, payload: dict):
        """Refill this (freshly-constructed) accumulator from a
        checkpoint payload; shapes must match the proc config the
        checkpoint was written under."""
        self.win_origin = int(payload["win_origin"])
        self.win_weights = [float(w) for w in payload["win_weights"]]
        for name, arr in payload["props"].items():
            np.copyto(self.props[name], arr)
        for name, arr in payload["arrays"].items():
            dest = getattr(self, name)
            if dest is None:
                raise ValueError(
                    f"checkpoint carries accumulator array {name!r} "
                    f"but the current proc config does not allocate "
                    f"it — restore into the original configuration")
            np.copyto(dest, arr)
        for name, samples in payload["pure_samples"].items():
            if name not in self.pure_samples:
                raise ValueError(
                    f"checkpoint carries pure-estimator samples "
                    f"{name!r} but the current proc config does not "
                    f"enable that pure estimator")
            self.pure_samples[name] = \
                [np.asarray(s) for s in samples] if samples.size else []

    def add(self, block_idx: int, energy, weight, num_walkers,
            ref_energy, accum_energy, iter_density=None, iter_ssf=None,
            iter_obd=None, iter_cmd=None, iter_g2=None, iter_itc=None,
            iter_itc_nw=None):
        """Fold one block's per-step arrays (shape ``(nts, ...)``)."""
        proc = self.proc
        props = self.props
        nts_block = proc.num_time_steps_block
        if iter_itc is not None and not proc.itc_spec.as_pure_est:
            self.itc_sums_data[block_idx] = iter_itc.sum(axis=0)
            self.itc_counts_data[block_idx] = iter_itc_nw.sum(axis=0)
            if self.itc_series_data is not None:
                self.itc_series_data[block_idx] = iter_itc
                self.itc_nw_series_data[block_idx] = iter_itc_nw
        if iter_cmd is not None:
            # Normalize per measured step: <W_cm^2> = sum W^2 / nw.
            nw_meas = np.asarray(num_walkers, dtype=np.float64)[
                proc.est_every - 1::proc.est_every]
            self.cmd_w2_data[block_idx] = iter_cmd[:, 0] / nw_meas
            if self.cmd_raw_data is not None:
                self.cmd_raw_data[block_idx] = iter_cmd
        # One statistics sample per forward-walking window: the
        # end-of-window value, weighted by the window-final step's
        # walker count (interior blocks hold partial, under-projected
        # accumulations — not samples).  The phase counts from
        # ``win_origin`` so a stream restart drops the interrupted
        # window.
        # Guard against blocks preceding the realigned origin: when
        # ``restart_window(block_idx + 1)`` runs BEFORE this
        # ``add(block_idx)`` for the interrupted block, without the
        # guard the modulo wraps to 0 and the
        # under-projected partial accumulator would be recorded as a
        # window sample.
        win_final = block_idx >= self.win_origin and \
            (block_idx - self.win_origin + 1) % self.window == 0
        if win_final and self.pure_samples:
            self.win_weights.append(float(num_walkers[nts_block - 1]))

        def _sample(name, data, as_pure):
            if as_pure and win_final:
                self.pure_samples[name].append(np.asarray(data[-1]))

        _sample("density", iter_density,
                proc.should_eval_density
                and proc.density_spec.as_pure_est
                and iter_density is not None)
        _sample("ssf", iter_ssf,
                proc.should_eval_ssf and proc.ssf_spec.as_pure_est
                and iter_ssf is not None)
        _sample("obd", iter_obd,
                proc.should_eval_obd and proc.obd_spec.as_pure_est
                and iter_obd is not None)
        _sample("g2", iter_g2,
                proc.should_eval_pair_corr
                and proc.pair_corr_spec.as_pure_est
                and iter_g2 is not None)
        if iter_itc is not None and proc.itc_spec.as_pure_est \
                and win_final:
            # The counts are the estimator's own descendant-weighted
            # denominator — they form the paired window sample.
            self.pure_samples["itc"].append(np.asarray(iter_itc[-1]))
            self.pure_samples["itc_nw"].append(
                np.asarray(iter_itc_nw[-1]))

        if proc.keep_iter_data:
            props["energy"][block_idx] = energy
            props["weight"][block_idx] = weight
            props["num_walkers"][block_idx] = num_walkers
            props["ref_energy"][block_idx] = ref_energy
            props["accum_energy"][block_idx] = accum_energy
            if iter_density is not None:
                self.density_blocks_data[block_idx] = iter_density
            if iter_ssf is not None:
                self.ssf_blocks_data[block_idx] = iter_ssf
            if iter_obd is not None:
                self.obd_blocks_data[block_idx] = iter_obd
            if iter_g2 is not None:
                self.g2_blocks_data[block_idx] = iter_g2
            return
        weight_sum = weight.sum()
        props["energy"][block_idx] = energy.sum()
        props["weight"][block_idx] = weight_sum
        props["num_walkers"][block_idx] = num_walkers.sum()
        props["ref_energy"][block_idx] = ref_energy[-1]
        props["accum_energy"][block_idx] = accum_energy[-1]
        self.pure_est_reduce_factor[block_idx] = \
            num_walkers[nts_block - 1] / weight_sum
        if self.est_weight_totals is not None:
            k = proc.est_every
            self.est_weight_totals[block_idx] = \
                weight[k - 1::k].sum()
        if self.obd_weight_totals is not None:
            k = proc.est_every * proc.obd_spec.est_every_mult
            self.obd_weight_totals[block_idx] = \
                weight[k - 1::k].sum()
        if self.g2_weight_totals is not None:
            k = proc.est_every * proc.pair_corr_spec.est_every_mult
            self.g2_weight_totals[block_idx] = \
                weight[k - 1::k].sum()

        def _store_mixed(dest, data, as_pure):
            if not as_pure:
                dest[block_idx] = data.sum(axis=0)

        if iter_density is not None:
            _store_mixed(self.density_blocks_data, iter_density,
                         proc.density_spec.as_pure_est)
        if iter_ssf is not None:
            _store_mixed(self.ssf_blocks_data, iter_ssf,
                         proc.ssf_spec.as_pure_est)
        if iter_obd is not None:
            _store_mixed(self.obd_blocks_data, iter_obd,
                         proc.obd_spec.as_pure_est)
        if iter_g2 is not None:
            _store_mixed(self.g2_blocks_data, iter_g2,
                         proc.pair_corr_spec.as_pure_est)

    def package(self) -> "dmc_data.SamplingData":
        """Block statistics + optional series, reference packaging
        (``qmc_exec/dmc/proc.py:358-415``)."""
        proc = self.proc
        nts_block = proc.num_time_steps_block
        props_data = dmc_data.PropsData(**self.props)
        reduce_data = bool(proc.keep_iter_data)
        factor = self.pure_est_reduce_factor

        energy_blocks = dmc_data.EnergyBlocks.from_data(props_data,
                                                        reduce_data)
        weight_blocks = dmc_data.WeightBlocks.from_data(props_data,
                                                        reduce_data)
        num_walkers_blocks = dmc_data.NumWalkersBlocks.from_data(
            props_data, reduce_data)
        est_kw = dict(est_every=proc.est_every,
                      est_weight_totals=self.est_weight_totals)
        win_w = np.asarray(self.win_weights, dtype=np.float64)

        def _pure(cls, name):
            totals = np.stack(self.pure_samples[name])
            return cls(totals, win_w[:, np.newaxis])

        if proc.should_eval_density:
            if proc.density_spec.as_pure_est:
                density_blocks = _pure(dmc_data.DensityBlocks,
                                       "density")
            else:
                density_blocks = dmc_data.DensityBlocks.from_data(
                    nts_block, self.density_blocks_data, props_data,
                    reduce_data, False, factor, **est_kw)
        else:
            density_blocks = None
        if proc.should_eval_ssf:
            if proc.ssf_spec.as_pure_est:
                totals = np.stack(self.pure_samples["ssf"])
                w = win_w[:, np.newaxis]
                ssf_blocks = dmc_data.SSFBlocks(
                    dmc_data.SSFPartBlocks(
                        totals[..., dmc_data.FDK_SQR_ABS], w),
                    dmc_data.SSFPartBlocks(
                        totals[..., dmc_data.FDK_REAL], w),
                    dmc_data.SSFPartBlocks(
                        totals[..., dmc_data.FDK_IMAG], w))
            else:
                ssf_blocks = dmc_data.SSFBlocks.from_data(
                    nts_block, self.ssf_blocks_data, props_data,
                    reduce_data, False, factor, **est_kw)
        else:
            ssf_blocks = None
        if proc.should_eval_obd:
            if proc.obd_spec.as_pure_est:
                obd_blocks = _pure(dmc_data.OBDBlocks, "obd")
            else:
                obd_blocks = dmc_data.OBDBlocks.from_data(
                    nts_block, self.obd_blocks_data, props_data,
                    reduce_data, False, factor,
                    est_every=(proc.est_every
                               * proc.obd_spec.est_every_mult),
                    est_weight_totals=self.obd_weight_totals)
        else:
            obd_blocks = None
        if proc.should_eval_pair_corr:
            if proc.pair_corr_spec.as_pure_est:
                g2_blocks = _pure(dmc_data.PairCorrBlocks, "g2")
            else:
                g2_blocks = dmc_data.PairCorrBlocks.from_data(
                    nts_block, self.g2_blocks_data, props_data,
                    reduce_data, False, factor,
                    est_every=(proc.est_every
                               * proc.pair_corr_spec.est_every_mult),
                    est_weight_totals=self.g2_weight_totals)
        else:
            g2_blocks = None

        cmd_blocks = None
        if proc.should_eval_cm_diffusion:
            wb = proc.cm_diffusion_spec.window_blocks or proc.num_blocks
            num_windows = proc.num_blocks // wb
            w2 = self.cmd_w2_data.reshape(num_windows, -1)
            cmd_blocks = dmc_data.CMDiffusionBlocks(
                w2, tau_step=proc.est_every * proc.time_step,
                boson_number=proc.model_spec.boson_number)

        itc_blocks = None
        if proc.should_eval_itc:
            if proc.itc_spec.as_pure_est:
                itc_sums = np.stack(self.pure_samples["itc"])
                itc_counts = np.stack(self.pure_samples["itc_nw"])
            else:
                itc_sums = self.itc_sums_data
                itc_counts = self.itc_counts_data
            itc_blocks = dmc_data.ITCBlocks(
                itc_sums, itc_counts,
                tau_step=(proc.est_every
                          * proc.itc_spec.est_every_mult
                          * proc.time_step),
                boson_number=proc.model_spec.boson_number,
                supercell_size=proc.model_spec.supercell_size)

        data_blocks = dmc_data.PropsDataBlocks(
            energy_blocks, weight_blocks, num_walkers_blocks,
            density_blocks, ssf_blocks, obd_blocks, cmd_blocks,
            g2_blocks, itc_blocks)
        data_series = dmc_data.PropsDataSeries(
            props_data, self.ssf_blocks_data, self.density_blocks_data,
            self.obd_blocks_data, self.cmd_raw_data,
            self.g2_blocks_data, itc=self.itc_series_data,
            itc_nw=self.itc_nw_series_data) \
            if proc.keep_iter_data else None
        return dmc_data.SamplingData(data_blocks, data_series)
