"""Monte Carlo samplers: VMC (Metropolis chains) and DMC (drift-diffusion
with branching)."""
from . import dmc, vmc  # noqa: F401
