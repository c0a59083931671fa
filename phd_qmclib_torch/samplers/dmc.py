"""Diffusion Monte Carlo: drift-diffusion propagation with birth/death
branching and population control.

Counterpart of ``phd_qmclib_tpu.samplers.dmc`` without estimators and on
one device.  Each step, as in the JAX package:

1. comb on the previous step's weights: each valid walker ``i`` is
   cloned ``floor(w_i + u_i)`` times, ``floor(w + u) -> cumsum ->
   searchsorted``, capped at the buffer size;
2. the children are the pre-diffusion parents, gathered with their
   energies and drifts;
3. the reference-energy controller ``E_ref = E_accum - c log(W /
   W_target) / dt`` updates from the ensemble sums;
4. the children diffuse with the previous ``E_ref``:
   ``z' = z + 2 F dt + sigma xi``, ``sigma = sqrt(2 dt)``, recast into
   ``[0, L)``;
5. the fused local energy and drift at ``z'`` (the pair kernel) and the
   branching weight ``w = exp(-dt ((E' + E)/2 - E_ref))``.

:meth:`Sampling.blocks` is a Python loop over steps that never waits on
the device inside a block: the walker count stays a 0-d device tensor,
and the per-step ensemble scalars are stacked into ``(nts,)`` tensors
and fetched once per block.  The comb uniforms come from a
``torch.Generator`` on the device, one stream per block; the diffusion
noise from the Philox normals kernel keyed by ``(rng_seed, global step
index)``.
"""
import typing as t
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .. import utils
from ..models import mrbp
from ..ops import prng

__all__ = [
    "PropsData",
    "Sampling",
    "SamplingBlock",
    "State",
    "branching_comb",
    "state_from_numpy",
]


class State(t.NamedTuple):
    """DMC walker-ensemble state: per-walker tensors sized to the
    ``max_num_walkers`` buffer plus 0-d ensemble scalars."""
    pos: torch.Tensor           # (Wm, N) walker positions
    drift: torch.Tensor         # (Wm, N) drift forces at pos
    energies: torch.Tensor      # (Wm,) local energies at pos
    weights: torch.Tensor       # (Wm,) branching weights
    masks: torch.Tensor         # (Wm,) bool; True = slot invalid
    energy: torch.Tensor        # ensemble energy sum of the last step
    weight: torch.Tensor        # ensemble weight of the last step
    num_walkers: torch.Tensor   # int64: valid walkers
    ref_energy: torch.Tensor    # E_ref for the next diffusion
    accum_energy: torch.Tensor  # running growth-energy estimate
    total_energy: torch.Tensor  # controller accumulator
    total_weight: torch.Tensor  # controller accumulator


class PropsData(t.NamedTuple):
    """Per-step ensemble properties of a block, each ``(nts,)`` on the
    host."""
    energy: torch.Tensor
    weight: torch.Tensor
    num_walkers: torch.Tensor
    ref_energy: torch.Tensor
    accum_energy: torch.Tensor


class SamplingBlock(t.NamedTuple):
    """Data yielded per block."""
    iter_props: PropsData
    last_state: State


def branching_comb(weights: torch.Tensor, num_walkers: torch.Tensor,
                   u: torch.Tensor) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized stochastic branching comb on the uniforms ``u (Wm,)``.

    Each valid parent ``i`` is cloned ``floor(w_i + u_i)`` times; the
    first ``max_num_walkers`` children survive.  ``parent[slot]`` is the
    number of parents whose cumulative clone count is ``<= slot``: the
    same table as the JAX package's marks matmul, by ``searchsorted``.

    :return: ``(parent_idx (Wm,), new_num_walkers 0-d)``, both int64.
    """
    max_w = weights.shape[-1]
    slots = torch.arange(max_w, device=weights.device)
    n_clones = torch.floor(weights + u).to(torch.int64)
    n_clones = torch.where(slots < num_walkers, n_clones, 0)
    cum = torch.cumsum(n_clones, dim=0)
    new_num = torch.clamp(cum[-1], max=max_w)
    parent = torch.searchsorted(cum, slots, right=True)
    return torch.clamp(parent, 0, max_w - 1), new_num


def state_from_numpy(state, device="cpu") -> State:
    """The port's :class:`State` from a JAX ``State`` (or any object with
    the same fields, as numpy-convertible arrays) on ``device``.

    The JAX ``num_walkers`` has one entry per shard; only one-shard
    states convert.
    """
    fields = {name: torch.tensor(np.asarray(getattr(state, name)),
                                 device=device)
              for name in State._fields}
    num_walkers = fields["num_walkers"]
    if num_walkers.numel() != 1:
        raise ValueError(f"only one-shard states convert, got "
                         f"{num_walkers.numel()} walker counts")
    fields["num_walkers"] = num_walkers.reshape(()).to(torch.int64)
    return State(**fields)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


@dataclass(frozen=True)
class Sampling:
    """DMC sampling spec bound to an mrbp model.

    The walker buffer has the fixed size ``max_num_walkers``;
    ``target_num_walkers`` drives the population controller.
    ``ref_compat`` takes the slot's previous-step energy as ``E_prev``
    in the branching weight instead of the parent's (the reference
    library's stale-slot read; both are O(dt) discretizations).
    """
    model_spec: mrbp.Spec
    time_step: float
    max_num_walkers: int
    target_num_walkers: int
    num_walkers_control_factor: t.Optional[float] = None
    rng_seed: t.Optional[int] = None
    ref_compat: bool = False

    def __post_init__(self):
        if self.rng_seed is None:
            object.__setattr__(self, "rng_seed",
                               int(utils.get_random_rng_seed()))
        if self.num_walkers_control_factor is None:
            object.__setattr__(self, "num_walkers_control_factor", 0.125)

    @property
    def cfc_params(self) -> mrbp.CFCParams:
        return self.model_spec.cfc_params

    @cached_property
    def core_funcs(self):
        return mrbp.core_funcs(self.model_spec)

    @property
    def sigma_spread(self) -> float:
        """Diffusion step width ``sqrt(2 dt)``."""
        return float(np.sqrt(2 * self.time_step))

    def _cast_params(self, dtype, device) -> mrbp.CFCParams:
        return mrbp.cast_params(self.cfc_params, dtype, device)

    # -- state construction ---------------------------------------------------

    def build_state(self, sys_conf_set: np.ndarray,
                    ref_energy: t.Optional[float] = None,
                    dtype=None, device="cpu") -> State:
        """Build the initial ensemble on ``device`` from a configuration
        set ``(num, N)`` or ``(num, 2, N)``.

        Takes the last ``target_num_walkers`` configurations, computes
        their fused energy and drift, sets unit weights, and seeds
        ``E_ref`` with the weighted ensemble energy.
        """
        sys_conf_set = np.asarray(sys_conf_set)
        nop = self.model_spec.boson_number
        if sys_conf_set.ndim == 3 and sys_conf_set.shape[-2] == 2:
            pos_set = sys_conf_set[:, mrbp.SysConfSlot.pos, :]
        elif sys_conf_set.ndim == 2 and sys_conf_set.shape[-1] == nop:
            pos_set = sys_conf_set
        else:
            raise ValueError("sys_conf_set does not match the model's "
                             "configuration layout")
        pos_set = pos_set[-self.target_num_walkers:]
        num = pos_set.shape[0]
        max_w = self.max_num_walkers
        if num > max_w:
            raise ValueError(f"{num} configurations do not fit the "
                             f"{max_w}-walker buffer")
        if dtype is None:
            dtype = pos_set.dtype if np.issubdtype(
                pos_set.dtype, np.floating) else np.float64
        dtype = _torch_dtype(dtype)

        pos = torch.zeros((max_w, nop), dtype=dtype, device=device)
        pos[:num] = torch.as_tensor(pos_set, dtype=dtype, device=device)
        valid = torch.arange(max_w, device=device) < num
        cfc = self._cast_params(dtype, device)
        energies, drift = self.core_funcs.energy_and_drift(pos, cfc)
        weights = valid.to(dtype)
        energies = torch.where(valid, energies, 0.0)
        drift = torch.where(valid[:, None], drift, 0.0)

        state_energy = float((energies * weights).sum())
        state_weight = float(weights.sum())
        energy_mean = state_energy / state_weight
        if ref_energy is None:
            ref_energy = energy_mean

        def f(x):
            return torch.tensor(x, dtype=dtype, device=device)

        return State(
            pos=pos, drift=drift, energies=energies, weights=weights,
            masks=~valid, energy=f(state_energy), weight=f(state_weight),
            num_walkers=torch.tensor(num, dtype=torch.int64,
                                     device=device),
            ref_energy=f(ref_energy), accum_energy=f(energy_mean),
            total_energy=f(0.0), total_weight=f(0.0))

    # -- the step -------------------------------------------------------------

    def _step(self, state: State, e_prev_slots: t.Optional[torch.Tensor],
              comb_u: torch.Tensor, xi: torch.Tensor,
              cfc: mrbp.CFCParams):
        """One time step with the comb uniforms ``comb_u (Wm,)`` and the
        pre-scaled diffusion noise ``xi (Wm, N)``.

        ``e_prev_slots`` is the slot-wise previous-step energy of
        ``ref_compat`` (``None`` otherwise).  Returns ``(new_state,
        new_e_prev_slots, parent)``.
        """
        dt = self.time_step
        nwc = self.num_walkers_control_factor
        target = float(self.target_num_walkers)

        # 1) Branching comb on the previous step's weights.
        parent, nw = branching_comb(state.weights, state.num_walkers,
                                    comb_u)
        valid = torch.arange(state.pos.shape[0],
                             device=state.pos.device) < nw

        # 2) Children: cloned (pre-diffusion) parents with parent
        #    energies.
        cpos = state.pos[parent]
        cdrift = state.drift[parent]
        cenergy = state.energies[parent]

        state_energy = torch.where(valid, cenergy, 0.0).sum()
        state_weight = nw.to(state.pos.dtype)

        # 3) Population-control update.
        total_energy = state.total_energy + state_energy
        total_weight = state.total_weight + state_weight
        accum_energy = total_energy / total_weight
        new_ref = accum_energy - nwc * torch.log(
            torch.clamp(state_weight, min=1.0) / target) / dt

        # 4) Diffuse the children with the PREVIOUS E_ref.
        npos = mrbp.recast(cpos + 2.0 * cdrift * dt + xi, cfc)

        # 5) Fused energy and drift, and the branching weight.
        nenergy, ndrift = self.core_funcs.energy_and_drift(npos, cfc)
        if e_prev_slots is not None:
            # Only live slots are written: a slot that goes dead and
            # later revives sees its stale energy.
            e_prev = e_prev_slots
            e_prev_slots = torch.where(valid, cenergy, e_prev_slots)
        else:
            e_prev = cenergy
        nweight = torch.exp(
            -dt * (0.5 * (nenergy + e_prev) - state.ref_energy))
        nweight = torch.where(valid, nweight, 0.0)

        new_state = State(
            pos=npos, drift=ndrift, energies=nenergy, weights=nweight,
            masks=~valid, energy=state_energy, weight=state_weight,
            num_walkers=nw, ref_energy=new_ref, accum_energy=accum_energy,
            total_energy=total_energy, total_weight=total_weight)
        return new_state, e_prev_slots, parent

    def _block_seed(self, block_index: int) -> int:
        """Seed of the comb-uniform stream of one block."""
        ss = np.random.SeedSequence([self.rng_seed, block_index])
        return int(ss.generate_state(1, dtype=np.uint64)[0])

    # -- public sampling APIs -------------------------------------------------

    def blocks(self, ini_state: State, num_time_steps_block: int,
               burn_in_blocks: int = 0,
               block_offset: int = 0) -> t.Iterator[SamplingBlock]:
        """Yield :class:`SamplingBlock` objects indefinitely.

        ``burn_in_blocks`` is accepted for the JAX package's signature:
        with no estimators, burn-in blocks and measured blocks run the
        same step.  ``block_offset`` continues the random streams of a
        run that already consumed that many blocks: the comb stream of
        block ``b`` is seeded from ``(rng_seed, block_offset + b)`` and
        the diffusion noise of its step ``t`` is keyed by ``(rng_seed,
        (block_offset + b) * nts + t)``.
        """
        del burn_in_blocks
        state = ini_state
        dtype, device = state.pos.dtype, state.pos.device
        nts = num_time_steps_block
        cfc = self._cast_params(dtype, device)
        sigma = self.sigma_spread
        block_index = block_offset
        while True:
            gen = torch.Generator(device=device)
            gen.manual_seed(self._block_seed(block_index))
            e_prev_slots = state.energies if self.ref_compat else None
            steps = []
            for step in range(nts):
                comb_u = torch.rand(state.weights.shape, generator=gen,
                                    dtype=dtype, device=device)
                xi = sigma * prng.normal(self.rng_seed,
                                         block_index * nts + step,
                                         state.pos.shape, dtype, device)
                state, e_prev_slots, _ = self._step(state, e_prev_slots,
                                                    comb_u, xi, cfc)
                steps.append((state.energy, state.weight,
                              state.num_walkers, state.ref_energy,
                              state.accum_energy))
            props = PropsData(*(torch.stack(column).cpu()
                                for column in zip(*steps)))
            yield SamplingBlock(props, state)
            block_index += 1

    def replay_states(self, ini_state: State, comb_u,
                      diffusion_noise) -> t.Dict[str, torch.Tensor]:
        """Run the dynamics with injected noise: the comb uniforms
        ``comb_u (nts, Wm)`` and the pre-scaled Gaussian displacements
        ``diffusion_noise (nts, Wm, N)`` (``~N(0, sigma)``).

        Returns per-step tensors: ``num_walkers, energy, weight,
        ref_energy, accum_energy`` (the ensemble scalars), ``pos,
        energies, weights`` (the post-diffusion ensemble) and ``parent``
        (the branching table).
        """
        dtype, device = ini_state.pos.dtype, ini_state.pos.device
        comb_u = torch.as_tensor(comb_u, dtype=dtype, device=device)
        xi = torch.as_tensor(diffusion_noise, dtype=dtype, device=device)
        cfc = self._cast_params(dtype, device)
        state = ini_state
        e_prev_slots = ini_state.energies if self.ref_compat else None
        out = {name: [] for name in (
            "num_walkers", "energy", "weight", "ref_energy",
            "accum_energy", "pos", "energies", "weights", "parent")}
        for step in range(comb_u.shape[0]):
            state, e_prev_slots, parent = self._step(
                state, e_prev_slots, comb_u[step], xi[step], cfc)
            for name in out:
                out[name].append(parent if name == "parent"
                                 else getattr(state, name))
        return {name: torch.stack(values) for name, values in out.items()}
