"""Execution layer: the DMC and VMC procedures, the block-statistics
data model, HDF5 IO, config loading and the CLI application objects."""
from . import cli_app, config, data, dmc, io, proc, vmc  # noqa: F401
from .logging import exec_logger  # noqa: F401
