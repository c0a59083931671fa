"""Legacy alias package: the mrbp model under its old name."""
from . import bloch_phonon  # noqa: F401
