"""QMC model layer: generic Bijl-Jastrow functions and the mrbp model."""
from . import jastrow, mrbp  # noqa: F401
