"""One Metropolis step of the VMC chains, in plain PyTorch.

Every particle of every chain moves by ``move_spread (u - 1/2)`` (or a
normal of that width), the proposal is wrapped into ``[0, L)``, and the
chain takes it where ``log|psi'| > log(u') / 2 + log|psi|``.  The
estimators sum over the chains: the S(k) parts and the OBDM grid of each
chain's configuration.
"""
import torch

from . import streams

__all__ = ["proposal"]


def proposal(model, traffic_proc: dict, pos, seed: int, block_index: int,
             step_in_block: int, steps_per_block: int, draw_dtype, dtype,
             device):
    """``(proposal, u)``: the step's proposed positions from ``pos`` and
    its acceptance uniforms, drawn in the program's ``draw_dtype``."""
    unit, u = streams.vmc_draws(
        seed, block_index, step_in_block, tuple(pos.shape), draw_dtype,
        device, bool(traffic_proc.get("gaussian", False)), steps_per_block)
    spread = float(traffic_proc["move_spread"])
    prop = torch.remainder(pos.to(device, dtype) + spread * unit.to(dtype),
                           model.p.length)
    return prop, u
