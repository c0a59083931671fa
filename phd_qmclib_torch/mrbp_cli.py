"""Command-line interfaces for mrbp QMC calculations.

Counterpart of ``phd_qmclib_tpu.mrbp_cli``.  Console scripts
``mrbp-dmc-torch`` / ``mrbp-vmc-torch`` (or ``python -m
phd_qmclib_torch.mrbp_cli dmc|vmc ...``), each with three commands:

* ``proc-template TEMPLATE [-o OUT] [-r]`` - render a Jinja2 template
  (with the unit constants ``LKP/UE/ER/K_OPT`` in context) into a YAML
  config with a dated, hostname-tagged filename.
* ``start CONFIG [--device cuda|cpu]`` - load a YAML/TOML config and
  execute its ``app_spec`` procedures on the device (default: the GPU).
* ``resume CHECKPOINT OUTPUT [--device cuda|cpu]`` - finish a killed run
  from its mid-run checkpoint file.

The ``analyze`` command (the report of a result file) is not here yet:
the files this package writes load in ``phd_qmclib_tpu``'s ``analyze``.

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
