"""Execution layer: the DMC and VMC procedures and their fused sweeps,
the block-statistics data model, HDF5 IO, config loading, the CLI
application objects and the report of stored results."""
from . import (  # noqa: F401
    cli_app, config, data, dmc, io, proc, report, sweep, vmc)
from .logging import exec_logger  # noqa: F401
