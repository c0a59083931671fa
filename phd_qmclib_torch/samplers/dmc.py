"""Diffusion Monte Carlo: drift-diffusion propagation with birth/death
branching and population control, and the DMC estimators.

Counterpart of ``phd_qmclib_tpu.samplers.dmc`` on one device.  Each
step, as in the JAX package:

1. comb on the previous step's weights: each valid walker ``i`` is
   cloned ``floor(w_i + u_i)`` times, ``floor(w + u) -> cumsum ->
   searchsorted``, capped at the buffer size;
2. the children are the pre-diffusion parents, gathered with their
   energies and drifts;
3. the reference-energy controller ``E_ref = E_accum - c log(W /
   W_target) / dt`` updates from the ensemble sums;
4. the estimators measure the post-branching (pre-diffusion) ensemble;
5. the children diffuse with the previous ``E_ref``:
   ``z' = z + 2 F dt + sigma xi``, ``sigma = sqrt(2 dt)``, recast into
   ``[0, L)``;
6. the fused local energy and drift at ``z'`` (the pair kernel) and the
   branching weight ``w = exp(-dt ((E' + E)/2 - E_ref))``.

Estimators: the density histogram (through the histogram kernel), the
S(k) Fourier parts, the one-body density matrix (OBDM) grid, the
pair-distance histogram g2(r) (the histogram kernel again) and the
centre-of-mass (CM) diffusion.  Each is mixed, or pure: a per-walker
accumulator transported through the branching ancestry every step,
frozen after ``pfw_num_time_steps`` and divided by the number of
contributions (forward walking).  ``est_every = K`` measures every K-th
step; the steps in between only compose the ancestry permutation, which
the next measured step applies to the accumulators in one gather.

The imaginary-time-correlation (ITC) estimator ``F(k, tau)`` keeps each
walker's last ``num_lags`` measured ``rho_k`` amplitudes in a ring
buffer in the :class:`State` (row 0 the newest).  The buffer rides the
branching through its own composed permutation, which resets only at an
ITC-measured step (every ``est_every * est_every_mult``-th); such a step
gathers the buffer once, correlates the step's amplitudes with every
lag row, and shifts them in.  Its pure variant accumulates the
per-walker lag products and per-lag counts through the same permutation.

:meth:`Sampling.blocks` is a Python loop over steps that never waits on
the device inside a block: the walker count stays a 0-d device tensor,
the measuring decisions use the step index the host already knows, and
the per-step ensemble scalars and estimator rows are stacked and fetched
once per block.  The comb uniforms come from a ``torch.Generator`` on
the device, one stream per block; the diffusion noise from the Philox
normals kernel keyed by ``(rng_seed, global step index)``.
"""
import typing as t
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .. import utils
from ..models import mrbp
from ..ops import histogram, pairwise, prng

__all__ = [
    "DensityEstSpec",
    "ITCEstSpec",
    "OBDEstSpec",
    "PairCorrEstSpec",
    "PropsData",
    "Sampling",
    "SamplingBlock",
    "SSFEstSpec",
    "State",
    "aux_from_numpy",
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
    #: CM-diffusion accumulator (``cm_diffusion_est``): each walker's
    #: ancestry-transported centre-of-mass displacement since the
    #: measurement window opened, ``(Wm,)``; ``None`` when disabled.
    cmd_accum: t.Optional[torch.Tensor] = None
    #: ITC lag ring buffer ``(Wm, num_lags, num_modes, 2)``: each
    #: walker's ``(Re, Im) rho_k`` of its last ``num_lags`` ITC-measured
    #: steps, row 0 the newest; ``None`` when disabled.
    itc_buf: t.Optional[torch.Tensor] = None
    #: Number of valid lag rows of ``itc_buf``, a 0-d int32 tensor that
    #: saturates at ``num_lags``.
    itc_filled: t.Optional[torch.Tensor] = None


class PropsData(t.NamedTuple):
    """Per-step ensemble properties of a block, each ``(nts,)`` on the
    host."""
    energy: torch.Tensor
    weight: torch.Tensor
    num_walkers: torch.Tensor
    ref_energy: torch.Tensor
    accum_energy: torch.Tensor


class SamplingBlock(t.NamedTuple):
    """Data yielded per block; the estimator rows are on the host, one
    per measured step, and ``None`` in burn-in blocks or when the
    estimator is off."""
    iter_props: PropsData
    iter_density: t.Optional[torch.Tensor]  # (nts // K, num_bins)
    iter_ssf: t.Optional[torch.Tensor]      # (nts // K, num_modes, 3)
    last_state: State
    iter_obd: t.Optional[torch.Tensor] = None  # (nts // (K m), num_pos)
    #: Per measured step ``[sum_w W_cm^2, sum_w W_cm]`` over the valid
    #: walkers, ``(nts // K, 2)``.
    iter_cmd: t.Optional[torch.Tensor] = None
    iter_g2: t.Optional[torch.Tensor] = None   # (nts // (K m), num_bins)
    #: ITC lag sums ``sum_w Re[rho_k(t) conj(rho_k(t - l))]`` per
    #: ITC-measured step, ``(nts // (K m), num_lags + 1, num_modes)``,
    #: row 0 the equal-time ``|rho_k|^2``; and the matching per-lag
    #: contribution counts ``(nts // (K m), num_lags + 1)``, which
    #: discount the initial fill of the ring buffer.
    iter_itc: t.Optional[torch.Tensor] = None
    iter_itc_nw: t.Optional[torch.Tensor] = None
    #: The pure estimators' accumulators after the block (on the
    #: device) when the forward-walking window spans several blocks;
    #: ``None`` otherwise.
    aux_carry: t.Optional[dict] = None


@dataclass(frozen=True)
class DensityEstSpec:
    """Density estimator spec: a ``num_bins`` histogram over ``[0, L)``."""
    num_bins: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None


@dataclass(frozen=True)
class SSFEstSpec:
    """Static structure factor spec: the harmonic momenta
    ``k_j = j 2 pi / L``, ``j < num_modes``."""
    num_modes: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None


@dataclass(frozen=True)
class OBDEstSpec:
    """One-body density matrix spec: ``n1(sz)`` on a ``num_pos``-point
    grid over ``[0, L/2]``.

    ``n1`` is off-diagonal in position, so the pure variant transports
    the per-walker ``n1_loc`` values through the ancestry: exact only
    when the trial function is the ground state.  ``est_every_mult``
    evaluates the grid only every ``est_every * est_every_mult``-th
    step; the ancestry transport still advances every step.
    """
    num_pos: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None
    est_every_mult: int = 1


@dataclass(frozen=True)
class PairCorrEstSpec:
    """Direct pair-correlation spec: a histogram of unordered-pair
    minimum-image distances on ``num_bins`` bins over ``[0, L/2]``,
    ``g2(r) = <counts> L / (N (N-1) dr)``.  ``est_every_mult`` thins it
    like the OBDM grid."""
    num_bins: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None
    est_every_mult: int = 1


@dataclass(frozen=True)
class ITCEstSpec:
    """Imaginary-time density-density correlation spec: ``F(k, tau) =
    <rho_k(t + tau) rho_-k(t)> / N`` for the harmonic momenta ``k_j = j
    2 pi / L``, ``j < num_modes``, at the lags ``tau_l = l * est_every *
    est_every_mult * dt``, ``l = 0..num_lags``.

    The mixed estimator (the default) sums each valid walker's product
    of its current amplitude with the lag rows of its ring buffer; its
    lag 0 is the S(k) estimator's mixed slot-0 sum.  ``as_pure_est``
    forward-walks the per-walker products and per-lag counts like the
    other pure estimators, with the same ``pfw_num_time_steps`` window
    semantics.  ``est_every_mult`` measures and shifts the buffer only
    every ``est_every * est_every_mult``-th step, which lengthens the
    lag unit at a fixed buffer size.  The walker dynamics and the other
    estimators are bit-identical for any value.
    """
    num_modes: int
    num_lags: int
    est_every_mult: int = 1
    as_pure_est: bool = False
    pfw_num_time_steps: t.Optional[int] = None

    def __post_init__(self):
        if self.num_modes < 1:
            raise ValueError("num_modes must be a positive integer")
        if self.num_lags < 1:
            raise ValueError("num_lags must be a positive integer")
        if self.est_every_mult < 1:
            raise ValueError(
                "est_every_mult must be a positive integer")


#: The pure ITC accumulators, which ride the ITC permutation.
_ITC_AUX = ("aux_itc", "aux_itc_cnt")


class _Branch(t.NamedTuple):
    """The post-branching ensemble of a step, which the estimators
    measure."""
    parent: torch.Tensor  # (Wm,) int64 branching table
    pos: torch.Tensor     # (Wm, N) children, before diffusion
    valid: torch.Tensor   # (Wm,) bool


class _Consts(t.NamedTuple):
    """What a run's steps and estimators need on the device, made once
    per run."""
    cfc: mrbp.CFCParams
    params: torch.Tensor  # pairwise.pack_params(cfc), the kernels' vector
    density_bin_size: t.Optional[torch.Tensor]  # 0-d
    obd_offsets: t.Optional[torch.Tensor]       # (num_pos,)


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


def state_from_numpy(state, device="cuda") -> State:
    """The port's :class:`State` from a JAX ``State`` (or any object with
    the same fields, as numpy-convertible arrays) on ``device``.

    The JAX ``num_walkers`` has one entry per shard; only one-shard
    states convert.  ``cmd_accum`` and the ITC ring buffer (``itc_buf``,
    with row 0 the newest amplitude in both packages, and
    ``itc_filled``) convert when present.
    """
    fields = {}
    for name in State._fields:
        value = getattr(state, name, None)
        fields[name] = (None if value is None else
                        torch.tensor(np.asarray(value), device=device))
    num_walkers = fields["num_walkers"]
    if num_walkers.numel() != 1:
        raise ValueError(f"only one-shard states convert, got "
                         f"{num_walkers.numel()} walker counts")
    fields["num_walkers"] = num_walkers.reshape(()).to(torch.int64)
    return State(**fields)


def aux_from_numpy(aux_carry: dict,
                   device="cuda") -> t.Dict[str, torch.Tensor]:
    """The pure estimators' accumulators of a JAX ``SamplingBlock.
    aux_carry`` (numpy-convertible arrays) as tensors on ``device``, for
    :meth:`Sampling.replay_estimators` to continue a JAX window."""
    return {name: torch.tensor(np.asarray(value), device=device)
            for name, value in aux_carry.items()}


@dataclass(frozen=True)
class Sampling:
    """DMC sampling spec bound to an mrbp model.

    The walker buffer has the fixed size ``max_num_walkers``;
    ``target_num_walkers`` drives the population controller.  The
    ``*_est_spec`` fields switch the estimators on; ``cm_diffusion_est``
    accumulates each walker's CM displacement (drift and noise, before
    the recast, so windings count) through the ancestry and resets it
    every ``cm_window_blocks`` measured blocks (``None``: one window for
    the whole run).  ``est_every`` measures every K-th step.
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
    density_est_spec: t.Optional[DensityEstSpec] = None
    ssf_est_spec: t.Optional[SSFEstSpec] = None
    obd_est_spec: t.Optional[OBDEstSpec] = None
    pair_corr_est_spec: t.Optional[PairCorrEstSpec] = None
    itc_est_spec: t.Optional[ITCEstSpec] = None
    cm_diffusion_est: bool = False
    cm_window_blocks: t.Optional[int] = 1
    est_every: int = 1
    ref_compat: bool = False

    def __post_init__(self):
        if self.rng_seed is None:
            object.__setattr__(self, "rng_seed",
                               int(utils.get_random_rng_seed()))
        if self.num_walkers_control_factor is None:
            object.__setattr__(self, "num_walkers_control_factor", 0.125)
        if self.est_every < 1:
            raise ValueError("est_every must be a positive integer")
        thinned = (self.obd_est_spec, self.pair_corr_est_spec)
        for spec in thinned:
            if spec is not None and spec.est_every_mult < 1:
                raise ValueError(
                    "est_every_mult must be a positive integer")
        if self.est_every > 1 or any(
                spec is not None and spec.est_every_mult > 1
                for spec in thinned):
            # As in the JAX package, the rule leaves the ITC spec out.
            for spec in (self.density_est_spec, self.ssf_est_spec,
                         *thinned):
                if spec is None or not spec.as_pure_est \
                        or not spec.pfw_num_time_steps:
                    continue
                if spec.pfw_num_time_steps % self._every(spec):
                    raise ValueError(
                        "pfw_num_time_steps must be divisible by "
                        "est_every (x est_every_mult for the "
                        "OBDM/pair-correlation estimators)")

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

    # -- estimator geometry ---------------------------------------------------

    @property
    def density_bins_edges(self) -> np.ndarray:
        if self.density_est_spec is None:
            raise TypeError("the density spec has not been specified")
        num_bins = self.density_est_spec.num_bins
        return np.linspace(0, self.model_spec.supercell_size, num_bins + 1)

    @property
    def ssf_momenta(self) -> np.ndarray:
        if self.ssf_est_spec is None:
            raise TypeError(
                "no S(k) estimator spec was configured for this sampling")
        num_modes = self.ssf_est_spec.num_modes
        return np.arange(num_modes) * 2 * np.pi \
            / self.model_spec.supercell_size

    @property
    def obd_pos_offsets(self) -> np.ndarray:
        if self.obd_est_spec is None:
            raise TypeError(
                "the one-body density matrix spec has not been specified")
        return np.linspace(0.0, 0.5 * self.model_spec.supercell_size,
                           self.obd_est_spec.num_pos)

    @property
    def itc_momenta(self) -> np.ndarray:
        if self.itc_est_spec is None:
            raise TypeError("no imaginary-time-correlation spec was "
                            "configured for this sampling")
        num_modes = self.itc_est_spec.num_modes
        return np.arange(num_modes) * 2 * np.pi \
            / self.model_spec.supercell_size

    @property
    def itc_lag_times(self) -> np.ndarray:
        """The imaginary-time lags ``tau_l = l * est_every *
        est_every_mult * dt``, ``l = 0..num_lags`` (one leading
        equal-time entry)."""
        if self.itc_est_spec is None:
            raise TypeError("no imaginary-time-correlation spec was "
                            "configured for this sampling")
        lags = np.arange(self.itc_est_spec.num_lags + 1)
        return lags * self._every(self.itc_est_spec) * self.time_step

    @property
    def _itc_buf_shape(self) -> t.Tuple[int, ...]:
        spec = self.itc_est_spec
        return (self.max_num_walkers, spec.num_lags, spec.num_modes, 2)

    @property
    def pair_corr_bin_edges(self) -> np.ndarray:
        if self.pair_corr_est_spec is None:
            raise TypeError(
                "the pair-correlation spec has not been specified")
        num_bins = self.pair_corr_est_spec.num_bins
        return np.linspace(0, 0.5 * self.model_spec.supercell_size,
                           num_bins + 1)

    @property
    def _est_specs(self):
        return (self.density_est_spec, self.ssf_est_spec,
                self.obd_est_spec, self.pair_corr_est_spec,
                self.itc_est_spec)

    def _every(self, spec) -> int:
        """Measuring period of an estimator, in steps."""
        return self.est_every * getattr(spec, "est_every_mult", 1)

    def _pfw_steps(self, spec) -> int:
        # An unset window is effectively infinite.
        return spec.pfw_num_time_steps if spec.pfw_num_time_steps \
            else 99999999

    def _pure_aux_shapes(self) -> t.Dict[str, t.Tuple[int, ...]]:
        """Shapes of the pure estimators' forward-walking accumulators."""
        max_w = self.max_num_walkers
        density, ssf, obd, g2, itc = (
            spec if spec is not None and spec.as_pure_est else None
            for spec in self._est_specs)
        shapes = {}
        if density:
            shapes["aux_density"] = (max_w, density.num_bins)
        if ssf:
            shapes["aux_ssf"] = (max_w, ssf.num_modes, 3)
        if obd:
            shapes["aux_obd"] = (max_w, obd.num_pos)
        if g2:
            shapes["aux_g2"] = (max_w, g2.num_bins)
        if itc:
            shapes["aux_itc"] = (max_w, itc.num_lags + 1, itc.num_modes)
            shapes["aux_itc_cnt"] = (max_w, itc.num_lags + 1)
        return shapes

    def pfw_window_blocks(self, num_time_steps_block: int) -> int:
        """Forward-walking window length in blocks.

        1 (per-block windows) unless a pure estimator's
        ``pfw_num_time_steps`` is a multiple of the block length longer
        than one block: the accumulators then persist across ``pfw /
        nts`` blocks.  Estimators with a shorter window freeze at their
        own and keep transporting to the end of the longest.
        """
        window = 1
        for spec in self._est_specs:
            if spec is None or not spec.as_pure_est \
                    or not spec.pfw_num_time_steps:
                continue
            pfw = int(spec.pfw_num_time_steps)
            if pfw > num_time_steps_block \
                    and pfw % num_time_steps_block == 0:
                window = max(window, pfw // num_time_steps_block)
        return window

    def _check_block_length(self, num_time_steps_block: int) -> None:
        """A measured block must end on a measured step of every
        estimator."""
        for spec, name in ((self.obd_est_spec, "obd"),
                           (self.pair_corr_est_spec, "g2"),
                           (self.itc_est_spec, "itc")):
            if spec is not None and spec.est_every_mult > 1 \
                    and num_time_steps_block % self._every(spec):
                raise ValueError(
                    "num_time_steps_block must be divisible by "
                    f"est_every * {name} est_every_mult")
        if num_time_steps_block % self.est_every:
            raise ValueError("num_time_steps_block must be divisible by "
                             "est_every")

    def _fresh_aux(self, dtype, device) -> t.Dict[str, torch.Tensor]:
        return {name: torch.zeros(shape, dtype=dtype, device=device)
                for name, shape in self._pure_aux_shapes().items()}

    def _fresh_itc(self, dtype, device) -> t.Dict[str, torch.Tensor]:
        """The :class:`State`'s ITC fields at the start of a fill."""
        if self.itc_est_spec is None:
            return {}
        return {"itc_buf": torch.zeros(self._itc_buf_shape, dtype=dtype,
                                       device=device),
                "itc_filled": torch.zeros((), dtype=torch.int32,
                                          device=device)}

    def _consts(self, dtype, device) -> _Consts:
        cfc = self._cast_params(dtype, device)
        bin_size = offsets = None
        if self.density_est_spec is not None:
            sc = cfc.model_params.supercell_size
            bin_size = sc / torch.full_like(sc,
                                            self.density_est_spec.num_bins)
        if self.obd_est_spec is not None:
            offsets = torch.as_tensor(self.obd_pos_offsets, dtype=dtype,
                                      device=device)
        return _Consts(cfc, pairwise.pack_params(cfc, dtype, device),
                       bin_size, offsets)

    # -- state construction ---------------------------------------------------

    def build_state(self, sys_conf_set: np.ndarray,
                    ref_energy: t.Optional[float] = None,
                    dtype=None, device="cuda") -> State:
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
        dtype = utils.torch_dtype(dtype)

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
            total_energy=f(0.0), total_weight=f(0.0),
            cmd_accum=(torch.zeros(max_w, dtype=dtype, device=device)
                       if self.cm_diffusion_est else None),
            **self._fresh_itc(dtype, device))

    # -- the step -------------------------------------------------------------

    def _step(self, state: State, e_prev_slots: t.Optional[torch.Tensor],
              comb_u: torch.Tensor, xi: torch.Tensor, consts: _Consts):
        """One time step with the comb uniforms ``comb_u (Wm,)`` and the
        pre-scaled diffusion noise ``xi (Wm, N)``.

        ``e_prev_slots`` is the slot-wise previous-step energy of
        ``ref_compat`` (``None`` otherwise).  A state with a
        ``cmd_accum`` transports it through the parents and adds the
        step's CM displacement.  Returns ``(new_state,
        new_e_prev_slots, branch)``, where ``branch`` is the
        post-branching ensemble the estimators measure.
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

        # 4) Diffuse the children with the PREVIOUS E_ref: move, energy
        #    and drift, and the branching weight.
        if e_prev_slots is not None:
            # Only live slots are written: a slot that goes dead and
            # later revives sees its stale energy.
            e_prev = e_prev_slots
            e_prev_slots = torch.where(valid, cenergy, e_prev_slots)
        else:
            e_prev = cenergy
        npos, nenergy, ndrift, nweight = self.diffuse(
            cpos, cdrift, e_prev, xi, state.ref_energy, consts.cfc,
            consts.params)
        nweight = torch.where(valid, nweight, 0.0)
        cmd_accum = state.cmd_accum
        if cmd_accum is not None:
            cmd_accum = cmd_accum[parent] \
                + (2.0 * cdrift * dt + xi).mean(dim=-1)

        new_state = State(
            pos=npos, drift=ndrift, energies=nenergy, weights=nweight,
            masks=~valid, energy=state_energy, weight=state_weight,
            num_walkers=nw, ref_energy=new_ref, accum_energy=accum_energy,
            total_energy=total_energy, total_weight=total_weight,
            cmd_accum=cmd_accum, itc_buf=state.itc_buf,
            itc_filled=state.itc_filled)
        return new_state, e_prev_slots, _Branch(parent, cpos, valid)

    def diffuse(self, cpos: torch.Tensor, cdrift: torch.Tensor,
                e_prev: torch.Tensor, xi: torch.Tensor,
                ref_energy: torch.Tensor, cfc: mrbp.CFCParams,
                params: t.Optional[torch.Tensor] = None):
        """The step's diffusion of the children ``cpos, cdrift (W, N)``
        with the pre-scaled noise ``xi``: the move and recast, the fused
        energy and drift at the new positions, and the weight
        ``exp(-dt ((E' + e_prev) / 2 - ref_energy))``.  Returns
        ``(npos, nenergy, ndrift, nweight)``, the outputs of
        :func:`phd_qmclib_torch.ops.pairwise.diffuse_energy_drift`, which
        fuses the same sequence in one kernel.  ``params`` is
        ``pairwise.pack_params(cfc)`` when the caller packed it once.
        """
        dt = self.time_step
        npos = mrbp.recast(cpos + 2.0 * cdrift * dt + xi, cfc)
        nenergy, ndrift = self.core_funcs.energy_and_drift(npos, cfc, params)
        nweight = torch.exp(-dt * (0.5 * (nenergy + e_prev) - ref_energy))
        return npos, nenergy, ndrift, nweight

    def _estimate(self, consts: _Consts, aux: dict,
                  perm: t.Optional[torch.Tensor],
                  itc_perm: t.Optional[torch.Tensor], branch: _Branch,
                  state: State, step_idx: int):
        """The estimators of one measured step.

        ``perm`` is the ancestry permutation composed over the
        transport-only steps since the last measured one (``None``: the
        identity); every accumulator but the ITC pair is gathered
        through ``perm[parent]`` once.  ``itc_perm`` is the ITC
        estimator's own composition, this step's parents included, over
        the steps since the last ITC-measured one.  ``state`` is the
        step's new state (its CM accumulator and ITC ring buffer), and
        ``step_idx`` the step's index in the forward-walking window.
        Returns ``(new_aux, est, new_state)`` with one row per estimator
        measured at this step.
        """
        funcs, cfc = self.core_funcs, consts.cfc
        cpos, valid = branch.pos, branch.valid
        anc = branch.parent if perm is None else perm[branch.parent]
        aux = {name: acc if name in _ITC_AUX else acc[anc]
               for name, acc in aux.items()}
        est = {}

        def masked_sum(x):
            return torch.where(valid.view((-1,) + (1,) * (x.dim() - 1)),
                               x, 0.0).sum(dim=0)

        def pure_divisor(spec, like):
            # A device tensor as the divisor: CUDA divides by a host
            # scalar as a multiply by its reciprocal, which may differ
            # from the CPU's (and the JAX package's) division in the
            # last bit.
            pfw, every = self._pfw_steps(spec), self._every(spec)
            return like.new_full(
                (), min((step_idx + 1) // every, pfw // every))

        def measure(name, spec, values):
            if not spec.as_pure_est:
                return masked_sum(values)
            if step_idx < self._pfw_steps(spec):
                aux[name] = aux[name] + values
            total = masked_sum(aux[name])
            return total / pure_divisor(spec, total)

        def due(spec):
            return (step_idx + 1) % self._every(spec) == 0

        spec = self.density_est_spec
        if spec is not None:
            hist = histogram.walker_histogram(cpos, consts.density_bin_size,
                                              spec.num_bins)
            hist = torch.where(valid[:, None], hist, 0.0)
            est["density"] = measure("aux_density", spec, hist)
        spec = self.ssf_est_spec
        ssf_parts = None
        if spec is not None:
            ssf_parts = funcs.fourier_density_parts_harmonics(
                spec.num_modes, cpos, cfc)
            est["ssf"] = measure("aux_ssf", spec, ssf_parts)
        spec = self.obd_est_spec
        if spec is not None and due(spec):
            est["obd"] = measure("aux_obd", spec,
                                 funcs.one_body_density_grid(
                                     consts.obd_offsets, cpos, cfc))
        spec = self.pair_corr_est_spec
        if spec is not None and due(spec):
            est["g2"] = measure("aux_g2", spec,
                                funcs.pair_dist_histogram(
                                    spec.num_bins, cpos, cfc))
        if state.cmd_accum is not None:
            est["cmd"] = torch.stack([masked_sum(state.cmd_accum ** 2),
                                      masked_sum(state.cmd_accum)])

        spec = self.itc_est_spec
        if spec is not None and due(spec):
            num_lags, num_modes = spec.num_lags, spec.num_modes
            # One gather through the composed permutation: the same
            # rows as a gather through the parents on every step.
            buf = state.itc_buf[itc_perm]
            # The amplitudes of the post-branching ensemble: the S(k)
            # estimator's own (re, im) slots when it has the modes.
            from_ssf = ssf_parts is not None \
                and self.ssf_est_spec.num_modes >= num_modes
            if from_ssf:
                reim = ssf_parts[:, :num_modes, 1:3]
            else:
                reim = funcs.fourier_density_reim_harmonics(
                    num_modes, cpos, cfc)
            re, im = reim[..., 0], reim[..., 1]
            maskf = valid.to(cpos.dtype)
            lag_ok = (torch.arange(1, num_lags + 1, device=cpos.device)
                      <= state.itc_filled).to(cpos.dtype)
            # Re[rho_k(t) conj(rho_k(t - l))] per walker, lag and mode,
            # as a multiply and add in the tensors' own precision (no
            # matrix-product path whose precision a global flag sets).
            prod_w = (buf[..., 0] * re[:, None] + buf[..., 1] * im[:, None]) \
                * maskf[:, None, None]
            if spec.as_pure_est:
                sq_w = torch.where(valid[:, None], re ** 2 + im ** 2, 0.0)
                contrib = torch.cat([sq_w[:, None], prod_w], dim=1)
                cnt_row = torch.cat([lag_ok.new_ones(1), lag_ok])
                acc = aux["aux_itc"][itc_perm]
                cnt = aux["aux_itc_cnt"][itc_perm]
                if step_idx < self._pfw_steps(spec):
                    acc = acc + contrib
                    cnt = cnt + maskf[:, None] * cnt_row
                aux["aux_itc"], aux["aux_itc_cnt"] = acc, cnt
                divisor = pure_divisor(spec, acc)
                est["itc"] = masked_sum(acc) / divisor
                est["itc_nw"] = masked_sum(cnt) / divisor
            else:
                # Lag 0 equals the S(k) estimator's mixed slot-0 sums bit
                # for bit: a sum's order follows its tensor's shape, so
                # take the walker sum over the S(k) parts themselves.
                lag0 = masked_sum(ssf_parts)[:num_modes, 0] if from_ssf \
                    else masked_sum(re ** 2 + im ** 2)
                est["itc"] = torch.cat([lag0[None], prod_w.sum(dim=0)])
                nwf = state.num_walkers.to(cpos.dtype)
                est["itc_nw"] = torch.cat([nwf[None], nwf * lag_ok])
            state = state._replace(
                itc_buf=torch.cat([reim[:, None], buf[:, :-1]], dim=1),
                itc_filled=torch.clamp(state.itc_filled + 1, max=num_lags))
        return aux, est, state

    def _run(self, state: State, draws, consts: _Consts,
             measuring: bool, aux: t.Optional[dict], step_offset: int):
        """Step through ``draws``, an iterable of ``(comb_u, xi)``.

        With ``measuring``, every ``est_every``-th step measures the
        estimators (step ``k`` of the run has index ``step_offset + k``
        in the forward-walking window) and the steps in between compose
        the ancestry permutation.  The ITC ring buffer's permutation
        composes on every step and resets at the ITC-measured ones;
        without ``measuring`` the buffer is neither transported nor
        shifted.  Returns ``(state, aux, props, est)``: the per-step
        ensemble scalars and estimator rows, as lists of device tensors.
        """
        e_prev_slots = state.energies if self.ref_compat else None
        cadence = self.est_every
        use_itc = measuring and self.itc_est_spec is not None
        perm = itc_perm = None
        props, est = [], {}
        for step, (comb_u, xi) in enumerate(draws):
            state, e_prev_slots, branch = self._step(
                state, e_prev_slots, comb_u, xi, consts)
            props.append((state.energy, state.weight, state.num_walkers,
                          state.ref_energy, state.accum_energy))
            if not measuring:
                continue
            if use_itc:
                itc_perm = (branch.parent if itc_perm is None
                            else itc_perm[branch.parent])
            if (step + 1) % cadence:
                if any(name not in _ITC_AUX for name in aux):
                    perm = (branch.parent if perm is None
                            else perm[branch.parent])
                continue
            aux, rows, state = self._estimate(
                consts, aux, perm, itc_perm, branch, state,
                step_offset + step)
            perm = None
            if "itc" in rows:
                itc_perm = None
            for name, row in rows.items():
                est.setdefault(name, []).append(row)
        return state, aux, props, est

    def _block_draws(self, block_index: int, num_time_steps_block: int,
                     state: State, noise: torch.Tensor):
        """The comb uniforms and diffusion noise of one block, drawn on
        the state's device as the steps consume them.  The noise, already
        scaled by sigma, is written into the run's buffer ``noise`` of
        ``state.pos``' shape: each step consumes it before the next draw,
        in stream order."""
        dtype, device = state.pos.dtype, state.pos.device
        gen = torch.Generator(device=device)
        gen.manual_seed(utils.block_seed(self.rng_seed, block_index))
        for step in range(num_time_steps_block):
            comb_u = torch.rand(state.weights.shape, generator=gen,
                                dtype=dtype, device=device)
            xi = prng.normal(
                self.rng_seed, block_index * num_time_steps_block + step,
                noise.shape, dtype, device, scale=self.sigma_spread,
                out=noise)
            yield comb_u, xi

    # -- public sampling APIs -------------------------------------------------

    def blocks(self, ini_state: State, num_time_steps_block: int,
               burn_in_blocks: int = 0,
               block_offset: int = 0) -> t.Iterator[SamplingBlock]:
        """Yield :class:`SamplingBlock` objects indefinitely.

        The first ``burn_in_blocks`` blocks run the dynamics only: no
        estimator is measured and their rows are ``None`` (the CM
        accumulator still advances, and its first window opens with the
        first measured block; the ITC ring buffer is neither
        transported nor shifted there, so a run with burn-in blocks
        restarts its fill, whatever the initial state carried).  A
        forward-walking window longer than one block carries the pure
        accumulators across blocks (``aux_carry``), with the step index
        counted from the window's start.  ``block_offset`` continues the random streams of a run
        that already consumed that many blocks: the comb stream of block
        ``b`` is seeded from ``(rng_seed, block_offset + b)`` and the
        diffusion noise of its step ``t`` is keyed by ``(rng_seed,
        (block_offset + b) * nts + t)``.
        """
        state = ini_state
        dtype, device = state.pos.dtype, state.pos.device
        if self.cm_diffusion_est and state.cmd_accum is None:
            state = state._replace(cmd_accum=torch.zeros(
                state.pos.shape[0], dtype=dtype, device=device))
        if self.itc_est_spec is not None and (
                state.itc_buf is None or burn_in_blocks > 0):
            # A state without the ring buffer starts an empty fill (the
            # lag counts discount the unfilled rows).  A filled buffer
            # would come out of the burn-in misaligned with its slots,
            # walkers cloned and killed under it, yet counted as valid.
            state = state._replace(**self._fresh_itc(dtype, device))
        nts = num_time_steps_block
        consts = self._consts(dtype, device)
        window = self.pfw_window_blocks(nts)
        cmd_window = self.cm_window_blocks
        noise = torch.empty(state.pos.shape, dtype=dtype, device=device)
        aux = None
        block = 0
        while True:
            measured_idx = block - burn_in_blocks
            measuring = measured_idx >= 0
            if self.cm_diffusion_est and (
                    measured_idx == 0 or (cmd_window and measured_idx > 0
                                          and measured_idx % cmd_window
                                          == 0)):
                state = state._replace(
                    cmd_accum=torch.zeros_like(state.cmd_accum))
            step_offset = 0
            if measuring:
                self._check_block_length(nts)
                win_pos = measured_idx % window
                if win_pos == 0:
                    aux = self._fresh_aux(dtype, device)
                step_offset = win_pos * nts
            draws = self._block_draws(block_offset + block, nts, state,
                                      noise)
            state, aux, steps, est = self._run(state, draws, consts,
                                               measuring, aux, step_offset)
            props = PropsData(*(torch.stack(column).cpu()
                                for column in zip(*steps)))
            rows = {name: torch.stack(values).cpu()
                    for name, values in est.items()}
            yield SamplingBlock(
                props, rows.get("density"), rows.get("ssf"), state,
                iter_obd=rows.get("obd"), iter_cmd=rows.get("cmd"),
                iter_g2=rows.get("g2"), iter_itc=rows.get("itc"),
                iter_itc_nw=rows.get("itc_nw"),
                aux_carry=aux if measuring and window > 1 else None)
            block += 1

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
        consts = self._consts(dtype, device)
        state = ini_state
        e_prev_slots = ini_state.energies if self.ref_compat else None
        out = {name: [] for name in (
            "num_walkers", "energy", "weight", "ref_energy",
            "accum_energy", "pos", "energies", "weights", "parent")}
        for step in range(comb_u.shape[0]):
            state, e_prev_slots, branch = self._step(
                state, e_prev_slots, comb_u[step], xi[step], consts)
            for name in out:
                out[name].append(branch.parent if name == "parent"
                                 else getattr(state, name))
        return {name: torch.stack(values) for name, values in out.items()}

    def replay_estimators(self, ini_state: State, comb_u, diffusion_noise,
                          aux_in: t.Optional[dict] = None,
                          step_offset: int = 0):
        """The estimators under injected noise (see :meth:`replay_states`
        for ``comb_u`` and ``diffusion_noise``): every ``est_every``-th
        step measures, the others only transport.

        ``aux_in`` (e.g. from :func:`aux_from_numpy`) and
        ``step_offset`` continue a forward-walking window that started
        ``step_offset`` steps earlier; by default the window starts
        here with zero accumulators.  The ITC ring buffer continues
        from ``ini_state``'s.  Returns ``(est, aux, state)``: for each
        estimator its rows stacked over the steps where it measured
        (``(nts // K, ...)``, or ``nts // (K m)`` with a multiplier),
        the final accumulators, and the final state with its ring
        buffer.
        """
        dtype, device = ini_state.pos.dtype, ini_state.pos.device
        comb_u = torch.as_tensor(comb_u, dtype=dtype, device=device)
        xi = torch.as_tensor(diffusion_noise, dtype=dtype, device=device)
        aux = self._fresh_aux(dtype, device)
        if aux_in is not None:
            aux = {name: torch.as_tensor(aux_in[name], dtype=dtype,
                                         device=device) for name in aux}
        if self.itc_est_spec is not None and ini_state.itc_buf is None:
            ini_state = ini_state._replace(
                **self._fresh_itc(dtype, device))
        state, aux, _, est = self._run(ini_state, zip(comb_u, xi),
                                       self._consts(dtype, device), True,
                                       aux, step_offset)
        return ({name: torch.stack(rows) for name, rows in est.items()},
                aux, state)
