"""Monte Carlo samplers: DMC (drift-diffusion with branching)."""
from . import dmc  # noqa: F401
