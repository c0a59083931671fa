"""Block-statistics data models for VMC and DMC results."""
from . import dmc, vmc  # noqa: F401
