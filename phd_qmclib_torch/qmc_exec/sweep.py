"""Fused parameter-sweep execution: many procedures, one batch.

Counterpart of ``phd_qmclib_tpu.qmc_exec.sweep``: R DMC (or VMC)
procedures whose model specs differ only in continuous parameters
(coupling, lattice depth, supercell, time step, seed) advance as one
fused batch per step through :class:`phd_qmclib_torch.parallel.ParamSweep`
(:class:`VmcSweep`), then split into R independent ``ProcResult``
objects, each what its procedure's standalone ``exec`` gives, bit for
bit.  A DMC sweep on a mesh of R x W ranks (``fused_sweep_mesh``) runs
each row on W ranks instead, each row its standalone W-shard run.

Mid-run checkpoints are per row: all rows or none, into distinct files,
at one cadence; each row's checkpoint is its standalone checkpoint, so
it resumes unfused with ``Proc.restore_checkpoint`` or, with the other
rows' from the same block, as a fused continuation.
"""
import typing as t
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh as mesh_mod
from ..parallel.sweep import ParamSweep, VmcSweep, _stack
from ..samplers.dmc import _row
from . import sharded
from . import vmc as vmc_exec
from .dmc import Proc, ProcInput, ProcResult, _BlockAccumulator
from .logging import exec_logger

__all__ = ["SweepProc", "VmcSweepProc"]


def _validate_sweep_checkpoints(procs):
    """Mid-run checkpointing across fused rows: all rows or none, into
    DISTINCT files, at one shared cadence (the rows advance in
    lockstep, so a shared ``checkpoint_every`` is structural)."""
    files = [p.checkpoint_file for p in procs]
    with_ckpt = [f for f in files if f is not None]
    if not with_ckpt:
        return
    if len(with_ckpt) != len(files):
        raise ValueError(
            "fused sweep checkpointing is all-or-none: give every row "
            "a checkpoint_file or none")
    if len(set(with_ckpt)) != len(with_ckpt):
        raise ValueError(
            "fused sweep rows must checkpoint into distinct files")
    everies = {p.checkpoint_every for p in procs}
    if len(everies) != 1:
        raise ValueError(
            "fused sweep rows must share checkpoint_every")


def _check_resumes(resumes) -> int:
    """The block the rows resume from (0 for a fresh run); all rows or
    none, all from the same block."""
    if all(r is None for r in resumes):
        return 0
    if any(r is None for r in resumes):
        raise ValueError(
            "fused sweep resume is all-or-none: every row "
            "must restore from a checkpoint or none")
    completed = {r["blocks_completed"] for r in resumes}
    if len(completed) != 1:
        raise ValueError(
            "fused sweep rows must resume from the same "
            "block (synchronized checkpoints)")
    return completed.pop()


def _checkpoint(procs, row_inputs, checkpoint_hook):
    """Each row's standalone checkpoint: written to the row's file, and
    the list handed to ``checkpoint_hook``."""
    for proc, row_input in zip(procs, row_inputs):
        if proc.checkpoint_file is not None:
            proc._write_checkpoint(row_input)
    if checkpoint_hook is not None:
        checkpoint_hook(row_inputs)


@dataclass(frozen=True)
class SweepProc:
    """Run R DMC procedures as one fused sweep: on one device, or on a
    mesh of R x W ranks.

    All procs must share the sampling *shape*: block counts, walker
    buffers, estimator specs, ``keep_iter_data``: anything that sets
    static structure.  Row-varying knobs are the continuous model
    parameters, ``time_step`` and ``rng_seed``.

    With ``mesh`` (a ``phd_qmclib_torch.parallel.MeshSpec`` of R rows,
    ``make_walker_mesh(R * W, device, rows=R)``) row ``r`` runs on the
    ranks ``r W .. r W + W - 1``, its walkers sharded over them, and is
    bit for bit its standalone run on a W-shard mesh (same seed, same
    per-shard streams): estimators, pure windows, cadence, per-row
    checkpoints and all.  Rows' own ``num_mesh_devices`` stays refused:
    the mesh belongs to the sweep.  Shard rebalancing does not run under
    a fused sweep.
    """

    procs: t.Tuple[Proc, ...]
    mesh: t.Optional[t.Any] = None

    def __post_init__(self):
        if not self.procs:
            raise ValueError("need at least one procedure")
        ref = self.procs[0]
        for p in self.procs[1:]:
            same = (
                p.num_blocks == ref.num_blocks
                and p.num_time_steps_block == ref.num_time_steps_block
                and p.burn_in_blocks == ref.burn_in_blocks
                and p.keep_iter_data == ref.keep_iter_data
                and p.block_offset == ref.block_offset
                and p.density_spec == ref.density_spec
                and p.ssf_spec == ref.ssf_spec
                and p.obd_spec == ref.obd_spec
                and p.pair_corr_spec == ref.pair_corr_spec
                and p.est_every == ref.est_every
                and p.cm_diffusion_spec == ref.cm_diffusion_spec)
            if not same:
                raise ValueError(
                    "all sweep procedures must share block structure "
                    "and estimator specs")
        for p in self.procs:
            if p.num_mesh_devices is not None:
                raise ValueError(
                    "fused sweep rows are single-device; drop "
                    "num_mesh_devices (use the sampler-level ParamSweep "
                    "for multi-device sweeps)")
        _validate_sweep_checkpoints(self.procs)

    @property
    def sweep(self) -> ParamSweep:
        return ParamSweep(tuple(p.sampling for p in self.procs), self.mesh)

    def exec(self, proc_inputs: t.Sequence[ProcInput],
             checkpoint_hook: t.Optional[
                 t.Callable[[t.List[ProcInput]], None]] = None) \
            -> t.List[ProcResult]:
        """Advance every row through its full procedure, all rows in one
        batch per step, on the device of the inputs' states (on a mesh:
        each row on its ranks).

        Every ``checkpoint_every`` blocks each row's resume input (its
        standalone ``Proc._checkpoint_input``) is written to the row's
        ``checkpoint_file``, when set, and the list of them handed to
        ``checkpoint_hook``, when given."""
        procs = self.procs
        if len(proc_inputs) != len(procs):
            raise ValueError("one ProcInput per procedure")
        if self.mesh is not None:
            self.sweep  # raises on a mesh of another shape than the rows'
            return self._exec_mesh(proc_inputs, checkpoint_hook)
        ref = procs[0]
        num_blocks = ref.num_blocks
        nts_block = ref.num_time_steps_block
        burn_in_blocks = ref.burn_in_blocks

        exec_logger.info(
            f"Starting fused DMC sweep ({len(procs)} rows)...")
        sweep = self.sweep
        state = _stack([pi.state for pi in proc_inputs])
        resumes = [pi.resume for pi in proc_inputs]
        start_block = _check_resumes(resumes)
        aux_init = None
        if start_block:
            for r, p in zip(resumes, procs):
                if r["it_offset"] != p.block_offset or \
                        r["it_burn"] != burn_in_blocks:
                    raise ValueError(
                        "a row's checkpoint stream position diverged "
                        "from the sweep stream (it was written by a "
                        "rebalanced standalone run?) — resume that "
                        "row unfused")
            if all("aux" in r for r in resumes):
                names = resumes[0]["aux"].keys()
                aux_init = {name: torch.stack([
                    torch.as_tensor(r["aux"][name]) for r in resumes])
                    for name in names}
            blocks_iter = sweep.blocks(
                state, nts_block, burn_in_blocks,
                block_offset=ref.block_offset,
                start_block_idx=burn_in_blocks + start_block,
                aux_init=aux_init)
            exec_logger.info(
                f"resuming fused sweep from synchronized checkpoints "
                f"at block {start_block}/{num_blocks}")
        else:
            blocks_iter = sweep.blocks(state, nts_block, burn_in_blocks,
                                       block_offset=ref.block_offset)
            for _ in range(burn_in_blocks):
                next(blocks_iter)
            if burn_in_blocks:
                exec_logger.info("Burn-in stage completed.")

        accumulators = [_BlockAccumulator(p) for p in procs]
        for r, acc in zip(resumes, accumulators):
            if r is not None and "accum" in r:
                acc.restore(r["accum"])
        checkpointing = ref.checkpoint_file is not None \
            or checkpoint_hook is not None
        names = ("density", "ssf", "obd", "cmd", "g2", "itc", "itc_nw")
        block_data = None
        for block_idx in range(start_block, num_blocks):
            block_data = next(blocks_iter)
            bp = block_data.iter_props
            # Fused props have a trailing row axis (nts, R); estimator
            # rows a leading one (R, n, ...).
            props = [np.asarray(column, dtype=np.float64) for column in bp]
            rows = {name: getattr(block_data, f"iter_{name}")
                    for name in names}
            rows = {name: None if value is None
                    else np.asarray(value, dtype=np.float64)
                    for name, value in rows.items()}
            for r, acc in enumerate(accumulators):
                acc.add(block_idx, *(column[:, r] for column in props),
                        **{f"iter_{name}": None if value is None
                           else value[r] for name, value in rows.items()})
            if checkpointing and (block_idx + 1) % ref.checkpoint_every == 0:
                carry = block_data.aux_carry
                _checkpoint(procs, [
                    p._checkpoint_input(
                        _row(block_data.last_state, r),
                        blocks_completed=block_idx + 1,
                        it_offset=p.block_offset, it_burn=burn_in_blocks,
                        it_next=burn_in_blocks + block_idx + 1,
                        aux=(None if carry is None else
                             {name: acc[r] for name, acc in carry.items()}),
                        accum=accumulators[r])
                    for r, p in enumerate(procs)], checkpoint_hook)
        exec_logger.info("Fused DMC sweep completed.")
        return [proc.build_result(
            _row(block_data.last_state, r) if block_data is not None
            else proc_inputs[r].state, acc.package())
            for r, (proc, acc) in enumerate(zip(procs, accumulators))]

    def _exec_mesh(self, proc_inputs, checkpoint_hook):
        """:meth:`exec` on ``mesh``: one launch, each row on its ranks;
        rank 0 writes the rows' files and calls the hook."""
        procs = self.procs
        walkers = self.mesh.walkers
        resumes = [pi.resume for pi in proc_inputs]
        if _check_resumes(resumes) == 0:
            # Fresh inputs hold a one-shard layout: each row starts from
            # its valid walkers laid out over its W shards, as its
            # standalone W-shard run builds them.
            proc_inputs = [replace(pi, state=p.sampling.build_state(
                pi.state.pos[~pi.state.masks].cpu().numpy(),
                dtype=pi.state.pos.dtype, device=pi.state.pos.device,
                num_shards=walkers))
                for p, pi in zip(procs, proc_inputs)]
        exec_logger.info(
            f"Starting fused DMC sweep ({len(procs)} rows on a "
            f"{self.mesh.rows}x{walkers} mesh)...")
        hooked = checkpoint_hook is not None
        return mesh_mod.launch(
            _sweep_rank, self.mesh, self,
            [sharded.to_host(pi) for pi in proc_inputs], hooked,
            rank0_kwargs={"checkpoint_hook": checkpoint_hook})


def _gather_rows(world, obj, device):
    """The objects of the sweep's rows (each row's first rank sends its
    own, the others nothing), on world rank 0 in row order, with their
    states on ``device``; ``None`` on the other ranks."""
    walkers = world.size // world.rows
    host = sharded.to_host(obj) if world.rank % walkers == 0 else None
    gathered = [None] * world.size if world.rank == 0 else None
    dist.gather_object(host, gathered, dst=0)
    if world.rank:
        return None
    return [sharded.from_host(gathered[r * walkers], device)
            for r in range(world.rows)]


def _sweep_rank(world, sweep_proc, host_inputs, hooked,
                checkpoint_hook=None):
    """Rank ``(r, w)`` of a mesh sweep: row ``r``'s procedure on the
    row's walker mesh; rank 0 returns every row's result."""
    sharded.silence(world)
    procs = sweep_proc.procs
    r = world.row
    proc = replace(procs[r], rebalance_every=None)
    on_checkpoint = None
    if hooked or proc.checkpoint_file is not None:
        def on_checkpoint(resume_input):
            inputs = _gather_rows(world, resume_input, world.device)
            if inputs is not None:
                _checkpoint(procs, inputs, checkpoint_hook)
    result = proc._exec(sharded.from_host(host_inputs[r], world.device),
                        mesh=world.row_mesh(), on_checkpoint=on_checkpoint)
    return _gather_rows(world, replace(result, proc=procs[r]),
                        world.device)


@dataclass(frozen=True)
class VmcSweepProc:
    """Run R VMC procedures as one fused sweep on one device.

    The VMC analog of :class:`SweepProc`, built on
    :class:`~phd_qmclib_torch.parallel.VmcSweep`: rows share block
    structure, chain count and estimator specs; continuous model
    parameters, ``move_spread`` and ``rng_seed`` vary per row.
    """

    procs: t.Tuple[vmc_exec.Proc, ...]

    def __post_init__(self):
        if not self.procs:
            raise ValueError("need at least one procedure")
        ref = self.procs[0]
        for p in self.procs[1:]:
            same = (
                p.num_blocks == ref.num_blocks
                and p.num_steps_block == ref.num_steps_block
                and p.burn_in_blocks == ref.burn_in_blocks
                and p.keep_iter_data == ref.keep_iter_data
                and p.block_offset == ref.block_offset
                and p.num_walkers == ref.num_walkers
                and p.est_every == ref.est_every
                and p.ssf_spec == ref.ssf_spec
                and p.obd_spec == ref.obd_spec
                and p.pair_corr_spec == ref.pair_corr_spec)
            if not same:
                raise ValueError(
                    "all sweep procedures must share block structure, "
                    "chain count and estimator specs")
        for p in self.procs:
            if p.num_mesh_devices is not None:
                raise ValueError(
                    "fused sweep rows are single-device; drop "
                    "num_mesh_devices")
        _validate_sweep_checkpoints(self.procs)

    @property
    def sweep(self) -> VmcSweep:
        return VmcSweep(tuple(p.sampling for p in self.procs))

    def exec(self, proc_inputs: t.Sequence[vmc_exec.ProcInput],
             checkpoint_hook: t.Optional[
                 t.Callable[[t.List[vmc_exec.ProcInput]], None]] = None) \
            -> t.List[vmc_exec.ProcResult]:
        """Advance every row through its full procedure, all rows in one
        batch per step; checkpoints as in :meth:`SweepProc.exec`."""
        procs = self.procs
        if len(proc_inputs) != len(procs):
            raise ValueError("one ProcInput per procedure")
        ref = procs[0]
        num_blocks = ref.num_blocks
        ns_block = ref.num_steps_block
        burn_in_blocks = ref.burn_in_blocks

        exec_logger.info(
            f"Starting fused VMC sweep ({len(procs)} rows)...")
        sweep = self.sweep
        state = _stack([pi.state for pi in proc_inputs])
        resumes = [pi.resume for pi in proc_inputs]
        start_block = _check_resumes(resumes)
        if start_block:
            # VMC has no window phases; an offset shift by the
            # consumed count reproduces the per-position block keys.
            blocks_iter = sweep.blocks(
                ns_block, state,
                block_offset=(ref.block_offset + burn_in_blocks
                              + start_block))
            exec_logger.info(
                f"resuming fused VMC sweep from synchronized "
                f"checkpoints at block {start_block}/{num_blocks}")
        else:
            blocks_iter = sweep.blocks(ns_block, state,
                                       block_offset=ref.block_offset)
            for _ in range(burn_in_blocks):
                next(blocks_iter)
            if burn_in_blocks:
                exec_logger.info("Burn-in stage completed.")

        accumulators = [vmc_exec._VmcBlockAccumulator(p) for p in procs]
        for r, acc in zip(resumes, accumulators):
            if r is not None and "accum" in r:
                acc.restore(r["accum"])
        checkpointing = ref.checkpoint_file is not None \
            or checkpoint_hook is not None
        block_data = None
        for block_idx in range(start_block, num_blocks):
            block_data = next(blocks_iter)
            bp = block_data.iter_props
            for r, acc in enumerate(accumulators):
                # Each row's walker means as its standalone run takes
                # them, on its own (nts, W) rows.
                means = vmc_exec._walker_means(bp.wf_abs_log[r],
                                               bp.energy[r], bp.move_stat[r])
                rows = {name: getattr(block_data, f"iter_{name}")
                        for name in ("ssf", "obd", "g2")}
                acc.add(block_idx,
                        *(np.asarray(m.cpu(), dtype=np.float64)
                          for m in means),
                        float(block_data.accept_rate[r]),
                        **{f"iter_{name}": None if value is None else
                           np.asarray(value[r].cpu(), dtype=np.float64)
                           for name, value in rows.items()})
            if checkpointing and (block_idx + 1) % ref.checkpoint_every == 0:
                _checkpoint(procs, [
                    p._checkpoint_input(
                        _row(block_data.last_state, r),
                        blocks_completed=block_idx + 1,
                        it_offset=p.block_offset,
                        it_next=burn_in_blocks + block_idx + 1,
                        accum=accumulators[r])
                    for r, p in enumerate(procs)], checkpoint_hook)
        exec_logger.info("Fused VMC sweep completed.")
        return [proc.build_result(
            _row(block_data.last_state, r) if block_data is not None
            else proc_inputs[r].state, acc.package())
            for r, (proc, acc) in enumerate(zip(procs, accumulators))]
