"""Command-line interfaces for mrbp QMC calculations.

Counterpart of ``phd_qmclib_tpu.mrbp_cli``.  Console scripts
``mrbp-dmc-torch`` / ``mrbp-vmc-torch`` (or ``python -m
phd_qmclib_torch.mrbp_cli dmc|vmc ...``), each with four commands:

* ``proc-template TEMPLATE [-o OUT] [-r]`` - render a Jinja2 template
  (with the unit constants ``LKP/UE/ER/K_OPT`` in context) into a YAML
  config with a dated, hostname-tagged filename.
* ``start CONFIG [--device cuda|cpu]`` - load a YAML/TOML config and
  execute its ``app_spec`` procedures on the device (default: the GPU).
* ``resume CHECKPOINT OUTPUT [--device cuda|cpu]`` - finish a killed run
  from its mid-run checkpoint file.
* ``analyze RESULT [-g GROUP] [--full] [--json] [--extrapolate-with VMC]
  [--dt-fit|--nw-fit|--fs-fit]`` - report the physics stored in a result
  file, or fit across a sweep's rows (``qmc_exec.report``, on the CPU).

``click`` is imported when a CLI is built, not when this module is, so
the module imports where ``click`` is missing.
"""
import functools
import os
import pathlib
import socket
from math import pi

from .qmc_exec import cli_app, config
from .utils import now

__all__ = ["dmc_cli", "make_cli", "vmc_cli"]

#: Template context variables (``mrbp_qmc/config.py:15-28``).
TEMPLATE_VARS = {
    "LKP": 1.0,
    "UE": 1.0,
    "ER": pi ** 2,
    "K_OPT": pi,
}

#: Console-script prefix of the generated config filenames.
PREFIXES = {"dmc": "mrbp-dmc", "vmc": "mrbp-vmc"}

#: Module-level loader singleton (``mrbp_qmc/dmc_exec/config.py:1-10``).
loader = config.Loader()


def gen_filename(prefix: str, ext: str = "yml") -> str:
    """Dated, hostname-tagged config filename
    (``mrbp_qmc/dmc_cli.py:67-81``)."""
    now_ = now()
    date_id = now_.strftime("%Y-%m-%d")
    time_id = now_.strftime("%H-%M-%S.%fus")
    hostname = socket.gethostname()
    return f"{prefix}-conf_{date_id}_{time_id}@{hostname}.{ext}"


@functools.cache
def make_cli(sampling_type: str):
    """The click command group of ``sampling_type`` (``dmc`` or
    ``vmc``), built at the first call."""
    import click

    prefix = PREFIXES[sampling_type]
    config_path_type = click.Path(exists=True)
    output_path_type = click.Path(exists=False)
    device_option = click.option(
        "--device", default="cuda", show_default=True,
        help="torch device the procedures run on (cuda, cuda:1, cpu)")

    @click.group()
    def cli():
        """CLI to execute a QMC calculation for a 1D Bose gas in a
        multi-rod lattice (PyTorch, on a GPU unless told otherwise)."""

    @cli.command(name="proc-template")
    @click.argument("template", type=config_path_type)
    @click.option("-o", "--output", type=output_path_type, default=None)
    @click.option("-r", "--replace", is_flag=True, default=False)
    def proc_template(template: str, output: str = None,
                      replace: bool = False):
        """Process a template and generate a configuration file."""
        tpl_path = pathlib.Path(template).absolute()
        assert tpl_path.is_file()
        output_path = pathlib.Path(output).absolute() if output \
            else pathlib.Path(".").absolute()
        if output_path.is_dir():
            output_path /= gen_filename(prefix)
        click.echo("Template path:")
        click.echo(f"    {tpl_path}")
        click.echo("Path to output configuration file:")
        click.echo(f"    {output_path}")
        if output_path.exists() and not replace:
            raise IOError(f"file {output_path} exists")
        os.makedirs(output_path.parent, exist_ok=True)
        config_template = config.Template(tpl_path, vars=TEMPLATE_VARS)
        config_template.save(output_path)
        click.echo("Output file successfully saved")

    @cli.command(name="start")
    @click.argument("config_path", type=config_path_type)
    @device_option
    def start(config_path: str, device: str = "cuda"):
        """Start the QMC calculation from a configuration file."""
        config_data = loader.load(config_path)
        app = cli_app.CLIApp.from_config(config_data, sampling_type)
        app.exec(device=device)

    @cli.command(name="resume")
    @click.argument("checkpoint_path", type=config_path_type)
    @click.argument("output_path", type=output_path_type)
    @click.option("-g", "--group", default="resumed",
                  help="result group inside the output file")
    @click.option("--no-checkpointing", is_flag=True, default=False,
                  help="do not keep writing mid-run checkpoints while "
                       "finishing the run")
    @device_option
    def resume(checkpoint_path: str, output_path: str,
               group: str = "resumed", no_checkpointing: bool = False,
               device: str = "cuda"):
        """Finish a killed run from its mid-run checkpoint file.

        Schema-v2 checkpoints resume bit-exactly (identical to the
        uninterrupted run, including every estimator series); the
        completed result is dumped to OUTPUT_PATH like ``start`` would
        have done.
        """
        if sampling_type == "dmc":
            from .qmc_exec import dmc as proc_mod
            from .qmc_exec.io import DmcHDF5FileHandler as Handler
        else:
            from .qmc_exec import vmc as proc_mod
            from .qmc_exec.io import VmcHDF5FileHandler as Handler

        try:
            proc, pin = proc_mod.Proc.restore_checkpoint(
                checkpoint_path, device=device)
        except (ValueError, KeyError, OSError) as exc:
            raise click.ClickException(
                f"not a readable {sampling_type} checkpoint: "
                f"{exc}") from exc
        if pin.resume is None:
            # Legacy (v1) checkpoint: walker state only, no resume
            # payload — the run continues from the saved state with
            # fresh estimator windows (restore_checkpoint logged it).
            done = 0
            click.echo("Legacy (v1) checkpoint: continuing from the "
                       "saved walker state (estimator windows reopen "
                       "fresh)")
        else:
            done = pin.resume["blocks_completed"]
        click.echo(f"Resuming at block {done}/{proc.num_blocks} "
                   f"from '{checkpoint_path}'")
        if no_checkpointing:
            proc = proc.evolve({"checkpoint_file": None})
        result = proc.exec(pin)
        Handler(location=output_path, group=group).dump(result)
        click.echo(f"Resumed result saved to '{output_path}' "
                   f"(group '{group}')")

    @cli.command(name="analyze")
    @click.argument("result_path", type=config_path_type)
    @click.option("-g", "--group", default=None,
                  help="result group inside the file (default: every "
                       f"{sampling_type} result stored)")
    @click.option("--full", is_flag=True, default=False,
                  help="print full per-bin/per-mode estimator tables")
    @click.option("--extrapolate-with", "vmc_path", default=None,
                  type=config_path_type,
                  help="(dmc only) a matched VMC result file: also "
                       "report the second-order extrapolated "
                       "estimators 2<DMC mixed> - <VMC>")
    @click.option("--vmc-group", default=None,
                  help="group of the VMC result inside the "
                       "--extrapolate-with file (default: the first "
                       "stored)")
    @click.option("--json", "as_json", is_flag=True, default=False,
                  help="emit a machine-readable JSON summary instead "
                       "of the human report")
    @click.option("--dt-fit", "dt_fit", is_flag=True, default=False,
                  help="(dmc only) extrapolate E(dt) -> E(0) across "
                       "every stored DMC result (e.g. a fused "
                       "time_step sweep); -g restricts to a group "
                       "prefix")
    @click.option("--nw-fit", "nw_fit", is_flag=True, default=False,
                  help="(dmc only) extrapolate the O(1/N_w) "
                       "population-control bias to E(N_w -> inf) "
                       "across every stored DMC result; -g restricts "
                       "to a group prefix")
    @click.option("--fs-fit", "fs_fit", is_flag=True, default=False,
                  help="(dmc only) finite-size extrapolation "
                       "E/N(N) -> E/N(inf) in x = 1/N^2 (the PBC "
                       "Luttinger-liquid Casimir correction) across "
                       "stored DMC results at matched density; -g "
                       "restricts to a group prefix")
    @click.option("--dt-fit-order", "fit_order", default=1,
                  show_default=True,
                  help="polynomial degree of the "
                       "--dt-fit/--nw-fit/--fs-fit extrapolation")
    def analyze(result_path: str, group: str = None, full: bool = False,
                vmc_path: str = None, vmc_group: str = None,
                as_json: bool = False, dt_fit: bool = False,
                nw_fit: bool = False, fs_fit: bool = False,
                fit_order: int = 1):
        """Report the physics stored in an HDF5 result file (energy
        with reblocked errors, population, S(k), density, OBDM, g2,
        effective mass).  Beyond the upstream library, which leaves
        result inspection to notebook code."""
        from .qmc_exec.report import report_hdf5

        # With --dt-fit/--nw-fit/--fs-fit, -g is a group PREFIX
        # selecting the sweep rows for the fit; the per-group reports
        # then cover the whole file (a prefix is not a stored group
        # name).
        any_fit = dt_fit or nw_fit or fs_fit
        report_group = None if any_fit else group

        def _report(**kw):
            try:
                return report_hdf5(result_path, group=report_group,
                                   sampling_type=sampling_type, **kw)
            except ValueError as exc:
                # A clean one-line message instead of a traceback
                # (wrong group, empty file, checkpoint-only file...).
                raise click.ClickException(str(exc)) from exc

        fit_summaries = []
        if any_fit:
            if sampling_type != "dmc":
                raise click.UsageError(
                    f"--{'dt' if dt_fit else 'nw' if nw_fit else 'fs'}"
                    f"-fit applies to DMC results")
            from .qmc_exec.report import sweep_fit_hdf5
            for kind, active in (("dt", dt_fit), ("nw", nw_fit),
                                 ("fs", fs_fit)):
                if not active:
                    continue
                try:
                    fit_summaries.append(
                        (kind, sweep_fit_hdf5(result_path, kind,
                                              group_prefix=group,
                                              order=fit_order)))
                except ValueError as exc:
                    raise click.ClickException(str(exc)) from exc

        extrapolated = None
        if vmc_path is not None:
            if sampling_type != "dmc":
                raise click.UsageError(
                    "--extrapolate-with applies to DMC results")
            from .qmc_exec.io import (DmcHDF5FileHandler,
                                      VmcHDF5FileHandler)
            from .qmc_exec.report import find_result_groups
            if vmc_group is None:
                vmc_entries = [g for g, st
                               in find_result_groups(vmc_path)
                               if st == "vmc"]
                if not vmc_entries:
                    raise click.UsageError(
                        f"no VMC result stored in '{vmc_path}'")
                vmc_group = vmc_entries[0]
            dmc_entries = [g for g, st in find_result_groups(result_path)
                           if st == "dmc"]
            if not dmc_entries:
                raise click.UsageError(
                    f"no DMC result stored in '{result_path}'")
            if group is None:
                dgroup = dmc_entries[0]
            elif any_fit:
                # With a fit flag active, -g is a group PREFIX (see
                # above) — resolve the first stored group matching it
                # instead of treating the prefix as a literal name.
                dgroup = next(
                    (g for g in dmc_entries if g.startswith(group)),
                    None)
                if dgroup is None:
                    raise click.UsageError(
                        f"no stored DMC group matches the prefix "
                        f"'{group}' in '{result_path}'")
            else:
                dgroup = group
            try:
                extrapolated = (
                    DmcHDF5FileHandler(location=result_path,
                                       group=dgroup).load(device="cpu"),
                    VmcHDF5FileHandler(location=vmc_path,
                                       group=vmc_group).load(device="cpu"))
            except (ValueError, KeyError) as exc:
                raise click.ClickException(str(exc)) from exc
        if as_json:
            import json as _json

            payload = _json.loads(_report(as_json=True))
            if extrapolated is not None:
                from .qmc_exec.report import summarize_extrapolated
                extra = summarize_extrapolated(*extrapolated)
                for entry in payload:
                    if entry["sampling_type"] == "dmc":
                        entry["extrapolated"] = extra
                        break
            for kind, summary in fit_summaries:
                payload.append({"sampling_type": f"{kind}_fit",
                                **summary})
            click.echo(_json.dumps(payload, indent=2))
            return
        click.echo(_report(full=full))
        if extrapolated is not None:
            from .qmc_exec.report import describe_extrapolated
            click.echo("")
            click.echo(describe_extrapolated(*extrapolated, full=full))
        for _, summary in fit_summaries:
            from .qmc_exec.report import describe_sweep_fit
            click.echo("")
            click.echo(describe_sweep_fit(summary))

    return cli


def dmc_cli(*args, **kwargs):
    """The ``mrbp-dmc-torch`` console script."""
    return make_cli("dmc")(*args, **kwargs)


def vmc_cli(*args, **kwargs):
    """The ``mrbp-vmc-torch`` console script."""
    return make_cli("vmc")(*args, **kwargs)


if __name__ == "__main__":  # pragma: no cover
    import sys

    which = sys.argv[1] if len(sys.argv) > 1 else "dmc"
    sys.argv = [sys.argv[0]] + sys.argv[2:]
    (dmc_cli if which == "dmc" else vmc_cli)()
