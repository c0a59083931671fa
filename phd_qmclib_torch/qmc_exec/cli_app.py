"""Application layer: app specs, IO-handler dispatch, multi-procedure
CLI runner.

Counterpart of ``phd_qmclib_tpu.qmc_exec.cli_app``, after the upstream
library's ``mrbp_qmc/dmc_exec/cli_app.py`` and ``qmc_exec/cli_app.py``.
One config file holds ``meta`` plus one or
more ``app_spec`` stanzas executed serially; each stanza wires a ``proc``
to an input handler (fresh model configurations or an HDF5 restart) and
an HDF5 output handler.  A ``proc_type: wf_opt`` stanza
(:class:`WFOptAppSpec`) runs or loads a VMC sampling and optimizes the
trial function by correlated sampling; the optimized parameters flow
into every later stanza.  With ``fused_sweep: true`` the procedures of
one config advance as a single fused sweep
(:class:`~phd_qmclib_torch.qmc_exec.sweep.SweepProc`,
:class:`~phd_qmclib_torch.qmc_exec.sweep.VmcSweepProc`), each still
dumping to its own output file, and ``fused_sweep_mesh: [R, W]``
spreads such a DMC sweep over R x W ranks.  The procedures run on the
``device`` given to :meth:`CLIApp.exec`; a config never names one.
"""
import typing as t
from dataclasses import dataclass, replace

import torch

from . import dmc as dmc_proc, io as io_mod, vmc as vmc_proc
from .logging import exec_logger
from .proc import MODEL_SYS_CONF_TYPE, ModelSysConfSpec

__all__ = ["AppMeta", "AppSpec", "CLIApp", "WFOptAppSpec",
           "get_io_handler"]


def proc_cli_tags_converter(tag_or_tags) -> str:
    """(``mrbp_qmc/dmc_exec/cli_app.py:124-134``)."""
    if isinstance(tag_or_tags, str):
        return tag_or_tags
    return " - ".join("#" + str(tag) for tag in tag_or_tags)


@dataclass(frozen=True)
class AppMeta:
    """Metadata of the application
    (``mrbp_qmc/dmc_exec/cli_app.py:140-164``)."""
    name: str = ""
    description: str = ""
    author: str = ""
    author_email: str = ""
    institution: str = ""
    category: str = ""
    tags: str = ""

    @classmethod
    def from_config(cls, config: t.Mapping):
        config = dict(config)
        if "tags" in config:
            config["tags"] = proc_cli_tags_converter(config["tags"])
        return cls(**config)


def get_io_handler(config: t.Mapping, sampling_type: str):
    """Dispatch an IO handler on the ``type`` tag
    (``mrbp_qmc/dmc_exec/cli_app.py:233-249``)."""
    handler_config = dict(config)
    handler_type = handler_config["type"]
    if handler_type == MODEL_SYS_CONF_TYPE:
        handler_config.pop("type", None)
        return ModelSysConfSpec(**handler_config)
    if handler_type == io_mod.HDF5_FILE_TYPE:
        cls = (io_mod.DmcHDF5FileHandler if sampling_type == "dmc"
               else io_mod.VmcHDF5FileHandler)
        return cls.from_config(handler_config)
    raise TypeError(f"unknown handler type {handler_type}")


@dataclass(frozen=True)
class AppSpec:
    """One procedure + its input and output handlers
    (``mrbp_qmc/dmc_exec/cli_app.py:33-121``)."""
    proc: t.Any
    proc_input: t.Any
    proc_output: io_mod.HDF5FileHandler
    proc_id: t.Optional[int] = None
    sampling_type: str = "dmc"

    @classmethod
    def from_config(cls, config: t.Mapping, sampling_type: str):
        self_config = dict(config)
        if "input" in self_config:
            self_config["proc_input"] = self_config.pop("input")
        if "output" in self_config:
            self_config["proc_output"] = self_config.pop("output")

        proc_cls = dmc_proc.Proc if sampling_type == "dmc" \
            else vmc_proc.Proc
        proc = proc_cls.from_config(self_config["proc"])
        proc_id = self_config.get("proc_id", 0)
        input_handler = get_io_handler(self_config["proc_input"],
                                       sampling_type)
        output_handler = get_io_handler(self_config["proc_output"],
                                        sampling_type)
        if not isinstance(output_handler, io_mod.HDF5FileHandler):
            raise TypeError("HDF5_FILE is the single accepted output "
                            "handler")
        return cls(proc=proc, proc_input=input_handler,
                   proc_output=output_handler, proc_id=proc_id,
                   sampling_type=sampling_type)

    def _continuation_proc(self, prev_proc):
        """RNG hygiene on restarts: when the continuation run reuses
        the previous run's seed without advancing ``block_offset``, its
        block keys would replay the blocks the previous run already
        consumed, correlating the merged statistics.  Advance the
        offset past the previous run's stream automatically."""
        proc = self.proc
        prev_seed = getattr(prev_proc, "rng_seed", None)
        prev_offset = getattr(prev_proc, "block_offset", 0)
        if (proc.rng_seed is not None and proc.rng_seed == prev_seed
                and proc.block_offset <= prev_offset):
            consumed = (prev_offset + prev_proc.burn_in_blocks
                        + prev_proc.num_blocks)
            exec_logger.info(
                f"restart reuses rng_seed={proc.rng_seed}: advancing "
                f"block_offset to {consumed} for an independent "
                f"continuation stream")
            proc = replace(proc, block_offset=consumed)
        return proc

    def build_input(self, device="cuda"):
        """(proc, proc_input) ready for execution, the state on
        ``device``; restarts from HDF5 get a stream-independent proc
        (see ``_continuation_proc``)."""
        proc_input_cls = dmc_proc.ProcInput \
            if self.sampling_type == "dmc" else vmc_proc.ProcInput
        if isinstance(self.proc_input, ModelSysConfSpec):
            return self.proc, proc_input_cls.from_model_sys_conf_spec(
                self.proc_input, self.proc, device=device)
        if isinstance(self.proc_input, io_mod.HDF5FileHandler):
            proc_result = self.proc_input.load(device=device)
            proc = self._continuation_proc(proc_result.proc)
            return proc, proc_input_cls.from_result(proc_result, proc)
        raise TypeError(f"invalid proc_input {self.proc_input!r}")

    def exec(self, dump_output: bool = True, device="cuda"):
        proc, proc_input = self.build_input(device=device)
        proc_result = proc.exec(proc_input)
        if dump_output:
            self.proc_output.dump(proc_result)
        return proc_result


@dataclass(frozen=True)
class WFOptAppSpec:
    """A ``proc_type: wf_opt`` stanza: obtain equilibrated VMC
    configurations (by running a VMC procedure or by loading a stored
    VMC result), then optimize ``tbf_contact_cutoff`` (and with
    ``opt_obf_lattice_depth`` the trial orbital's depth) by correlated
    sampling (:class:`phd_qmclib_torch.wf_opt.WFOptProc`).  The optimal
    values flow into every later stanza of the same config, so one file
    runs VMC -> optimize -> DMC at the optimum.

    Config shape::

        app_spec:
          - proc_type: wf_opt
            proc: { ...VMC proc config... }     # or omit and use an
            input: { type: MODEL_SYS_CONF }     # HDF5_FILE input of a
            num_sys_confs: 128                  # stored VMC result
            method: de | grad
          - proc: { ...DMC proc config... }     # runs at the optimum
            ...
    """
    vmc_proc: t.Optional[t.Any]
    proc_input: t.Any
    num_sys_confs: int = 128
    method: str = "de"
    ref_energy: t.Optional[float] = None
    verbose: bool = False
    proc_id: t.Optional[int] = None
    #: Jointly optimize the trial-orbital lattice depth alongside ``rm``.
    opt_obf_lattice_depth: bool = False

    @classmethod
    def from_config(cls, config: t.Mapping):
        self_config = dict(config)
        self_config.pop("proc_type", None)
        proc_config = self_config.pop("proc", None)
        proc = vmc_proc.Proc.from_config(proc_config) \
            if proc_config is not None else None
        # The config loader renames "input" to "proc_input"; both are
        # accepted, so that hand-built dicts and loaded files agree.
        input_config = self_config.pop(
            "proc_input",
            self_config.pop("input", {"type": MODEL_SYS_CONF_TYPE}))
        input_handler = get_io_handler(input_config, "vmc")
        if proc is None and not isinstance(input_handler,
                                           io_mod.HDF5FileHandler):
            raise TypeError(
                "a wf_opt stanza needs either a VMC proc to run or an "
                "HDF5_FILE input holding a stored VMC result")
        return cls(vmc_proc=proc, proc_input=input_handler,
                   num_sys_confs=int(self_config.pop("num_sys_confs",
                                                     128)),
                   method=str(self_config.pop("method", "de")),
                   ref_energy=self_config.pop("ref_energy", None),
                   verbose=bool(self_config.pop("verbose", False)),
                   proc_id=self_config.pop("proc_id", None),
                   opt_obf_lattice_depth=bool(self_config.pop(
                       "opt_obf_lattice_depth", False)))

    def exec(self, device="cuda"):
        """Run (or load) the VMC stage on ``device`` and optimize there;
        returns the optimized model spec."""
        from ..wf_opt import WFOptProc

        if isinstance(self.proc_input, io_mod.HDF5FileHandler):
            result = self.proc_input.load(device=device)
            if self.vmc_proc is not None:
                exec_logger.info(
                    "wf_opt stanza: using the stored VMC result "
                    "(the inline VMC proc is ignored)")
            state, model_spec = result.state, result.proc.model_spec
        else:
            proc = self.vmc_proc
            proc_input = vmc_proc.ProcInput.from_model_sys_conf_spec(
                self.proc_input, proc, device=device)
            result = proc.exec(proc_input)
            state, model_spec = result.state, proc.model_spec
        opt = WFOptProc(num_sys_confs=self.num_sys_confs,
                        ref_energy=self.ref_energy,
                        verbose=self.verbose, method=self.method,
                        opt_obf_lattice_depth=self.opt_obf_lattice_depth)
        opt_spec = opt.exec(model_spec, state.pos, state.wf_abs_log,
                            device=device)
        orbital = (f", orbital v0 = {opt_spec.obf_lattice_depth:.6G} "
                   f"(physical {opt_spec.lattice_depth:.6G})"
                   if opt_spec.obf_lattice_depth is not None else "")
        exec_logger.info(
            f"wf_opt: optimal rm = {opt_spec.tbf_contact_cutoff:.6G} "
            f"(was {model_spec.tbf_contact_cutoff:.6G}){orbital}; "
            f"subsequent procedures run at the optimized value")
        return opt_spec


@dataclass(frozen=True)
class CLIApp:
    """Entry point executing a sequence of procedures
    (``mrbp_qmc/dmc_exec/cli_app.py:167-230``).

    With ``fused_sweep: true`` at the top level of the config, the
    procedures (DMC or VMC) advance as ONE fused batch per step on the
    device (:class:`~phd_qmclib_torch.qmc_exec.sweep.SweepProc`) instead
    of one after the other; each still dumps to its own output file,
    bit-identical to its sequential result.  A single procedure runs
    unfused.  ``fused_sweep_mesh: [R, W]`` (DMC only) spreads the fused
    sweep over R x W ranks instead, R rows with walkers sharded over W
    devices each (on the CPU, gloo ranks); every row stays bit-identical
    to its standalone run on a W-shard mesh."""
    meta: AppMeta
    app_spec: t.Sequence[AppSpec]
    sampling_type: str = "dmc"
    fused_sweep: bool = False
    #: Optional (rows, walker-devices) shape of a meshed fused sweep;
    #: ``None`` = the rows fused on one device.
    fused_sweep_mesh: t.Optional[t.Tuple[int, int]] = None

    @classmethod
    def from_config(cls, config: t.Mapping, sampling_type: str):
        self_config = dict(config.items())
        app_meta = AppMeta.from_config(self_config.get("meta", {}))
        fused_sweep = bool(self_config.pop("fused_sweep", False))
        if fused_sweep and sampling_type not in ("dmc", "vmc"):
            raise ValueError("fused_sweep supports DMC and VMC "
                             "procedures only")
        mesh_shape = self_config.pop("fused_sweep_mesh", None)
        if mesh_shape is not None:
            # The JAX package's checks.
            if not fused_sweep:
                raise ValueError(
                    "fused_sweep_mesh needs fused_sweep: true")
            if sampling_type != "dmc":
                raise ValueError(
                    "fused_sweep_mesh supports DMC procedures only")
            try:
                rows, walker_devs = (int(mesh_shape[0]),
                                     int(mesh_shape[1]))
            except (TypeError, KeyError, IndexError, ValueError):
                raise ValueError(
                    "fused_sweep_mesh must be a [rows, "
                    "walker_devices] pair") from None
            if rows < 1 or walker_devs < 1:
                raise ValueError(
                    "fused_sweep_mesh entries must be positive")
            mesh_shape = (rows, walker_devs)
        app_spec_data = self_config.pop("app_spec")
        app_spec_set = []
        for proc_num, app_spec_config in enumerate(app_spec_data):
            app_spec_config = dict(app_spec_config)
            if app_spec_config.get("proc_id") is None:
                app_spec_config["proc_id"] = proc_num
            if app_spec_config.get("proc_type") == "wf_opt":
                if fused_sweep:
                    raise ValueError(
                        "wf_opt stanzas cannot ride a fused sweep "
                        "(the optimized rm must flow serially into "
                        "the following procedures)")
                app_spec_set.append(
                    WFOptAppSpec.from_config(app_spec_config))
                continue
            app_spec_set.append(
                AppSpec.from_config(app_spec_config, sampling_type))
        return cls(meta=app_meta, app_spec=app_spec_set,
                   sampling_type=sampling_type, fused_sweep=fused_sweep,
                   fused_sweep_mesh=mesh_shape)

    def _exec_fused(self, device="cuda"):
        """The procedures as one fused sweep on ``device``, each result
        dumped to its own output file."""
        from .sweep import SweepProc, VmcSweepProc

        sweep_cls = VmcSweepProc if self.sampling_type == "vmc" \
            else SweepProc
        mesh = None
        if self.fused_sweep_mesh is not None:
            from ..parallel import make_walker_mesh

            rows, walker_devs = self.fused_sweep_mesh
            if rows != len(self.app_spec):
                raise ValueError(
                    f"fused_sweep_mesh rows ({rows}) must equal the "
                    f"number of procedures ({len(self.app_spec)})")
            need = rows * walker_devs
            if torch.device(device).type == "cuda" \
                    and torch.cuda.device_count() < need:
                raise ValueError(
                    f"fused_sweep_mesh {rows}x{walker_devs} needs "
                    f"{need} devices; {torch.cuda.device_count()} visible")
            mesh = make_walker_mesh(need, device, rows=rows)
        exec_logger.info(
            f"Executing {len(self.app_spec)} "
            f"{self.sampling_type.upper()} procedures as one fused "
            f"sweep..." + (f" (2-D {self.fused_sweep_mesh[0]}x"
                           f"{self.fused_sweep_mesh[1]} mesh)"
                           if mesh is not None else ""))
        pairs = [spec.build_input(device=device) for spec in self.app_spec]
        if mesh is None:
            sweep_proc = sweep_cls(tuple(proc for proc, _ in pairs))
        else:
            sweep_proc = sweep_cls(tuple(proc for proc, _ in pairs),
                                   mesh=mesh)
        results = sweep_proc.exec([pi for _, pi in pairs])
        for spec, result in zip(self.app_spec, results):
            spec.proc_output.dump(result)
        exec_logger.info("All the QMC calculations have completed.")
        return results

    def exec(self, device="cuda"):
        """Run the procedures on ``device``, each dumping its result to
        its output file: one fused sweep with ``fused_sweep`` and more
        than one procedure, else one after the other, where a wf_opt
        stanza's optimized parameters (rm, and the trial orbital's depth
        when optimized jointly) go into every later stanza's model
        spec."""
        app_spec_set = self.app_spec
        exec_logger.info("Starting the QMC calculations...")
        exec_logger.info(f"Starting the execution of a set of "
                         f"{len(app_spec_set)} QMC calculations...")
        if self.fused_sweep and len(app_spec_set) > 1:
            return self._exec_fused(device=device)
        results = []
        opt_params_star = None
        for proc_num, app_spec in enumerate(app_spec_set, 1):
            exec_logger.info(f"Starting procedure ID{proc_num}...")
            if isinstance(app_spec, WFOptAppSpec):
                opt_spec = app_spec.exec(device=device)
                opt_params_star = {
                    "tbf_contact_cutoff": opt_spec.tbf_contact_cutoff}
                if opt_spec.obf_lattice_depth is not None:
                    opt_params_star["obf_lattice_depth"] = \
                        opt_spec.obf_lattice_depth
                results.append(opt_spec)
            else:
                if opt_params_star is not None:
                    new_spec = app_spec.proc.model_spec.evolve(
                        **opt_params_star)
                    app_spec = replace(app_spec, proc=replace(
                        app_spec.proc, model_spec=new_spec))
                results.append(app_spec.exec(device=device))
            exec_logger.info(f"Procedure ID{proc_num} completed.")
        exec_logger.info("All the QMC calculations have completed.")
        return results
