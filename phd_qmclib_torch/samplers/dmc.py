"""Diffusion Monte Carlo: drift-diffusion propagation with birth/death
branching and population control, and the DMC estimators.

Counterpart of ``phd_qmclib_tpu.samplers.dmc``.  Each step, as in the
JAX package:

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
normals kernel keyed by ``(rng_seed, global step index)``.  On a CUDA
device a run of one row without a walker mesh replays each step after
its first from CUDA graphs (:func:`step_graph`): the host launches one
graph a step in place of the step's few dozen operations, and the draws
and the estimators stay eager around it.

On a walker mesh (``mesh``, a ``phd_qmclib_torch.parallel.WalkerMesh``:
one process per device) every rank steps its shard of the buffer, the
``max_num_walkers / S`` slots ``rank * shard_size ..``, with a valid
prefix and a walker count of its own: the comb, the gathers, the
diffusion, the pair kernel and the weights stay on the shard, and the
ensemble sums that the population controller reads (energy, weight, the
walker count) are ``mesh.psum``-ed every step, where the JAX package
``psum``-s them.  The estimator sums are shard-local and ``psum``-ed
once per block.  Each shard draws its own streams: the comb's from
``(rng_seed, block index, shard)``, the noise keyed by ``(rng_seed,
shard)``.  Per-shard combs make the shards' populations random walks,
so ``rebalance_every`` deals the valid walkers evenly over the shards
every K blocks (:meth:`Sampling.rebalance`).  A state given to the
sampler is the global view (``num_walkers`` with one entry per shard);
a state saved under another shard count is re-laid out first
(:meth:`Sampling.adapt_state_shards`).
"""
import dataclasses
import typing as t
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .. import utils
from ..models import mrbp
from ..ops import histogram, pairwise, prng
from ..utils import tracing

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

    @property
    def max_num_walkers(self) -> int:
        return self.pos.shape[-2]

    @property
    def confs(self) -> torch.Tensor:
        """Packed ``(Wm, 2, N)`` (pos, drift) buffer: the layout of the
        state's configurations in a result file."""
        return torch.stack([self.pos, self.drift], dim=-2)


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


#: The State fields with one entry per walker slot.
WALKER_FIELDS = ("pos", "drift", "energies", "weights", "masks",
                 "cmd_accum", "itc_buf")


class _Branch(t.NamedTuple):
    """The post-branching ensemble of a step, which the estimators
    measure, with the rows' leading axis."""
    parent: torch.Tensor  # (R, Wm) int64 branching table, flat over rows
    pos: torch.Tensor     # (R, Wm, N) children, before diffusion
    valid: torch.Tensor   # (R, Wm) bool
    #: (R,) int64: the walkers of every shard (the step's own count).
    num_walkers: t.Optional[torch.Tensor] = None


class _Divisor(t.NamedTuple):
    """A per-row divisor of the population controller.  ``x / d`` by a
    Python float on a CUDA tensor is the multiply by ``1 / d``, taken in
    double and rounded to the tensor's type (torch's scalar division
    there), while the CPU divides: rows with their own ``d`` take the
    same form, so that each row's controller is its single sampling's,
    bit for bit."""
    value: t.Union[float, torch.Tensor]
    reciprocal: bool = False

    def divide(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.value if self.reciprocal else x / self.value


class _Consts(t.NamedTuple):
    """What a run's steps and estimators need on the device, made once
    per run, for R rows (a fused sweep's; one for a single sampling).

    A constant the rows share is what a single sampling uses (a 0-d
    tensor, a Python float); one that differs is a tensor with the row
    axis first, shaped to broadcast where it is used."""
    cfc: mrbp.CFCParams   # leaves 0-d, or (R, 1, 1) where the rows differ
    params: torch.Tensor  # pairwise.pack_params: (16,), or the (R, 16) table
    density_bin_size: t.Optional[torch.Tensor]  # 0-d, or (R, 1, 1)
    obd_offsets: t.Optional[torch.Tensor]  # (num_pos,) or (num_pos, R, 1, 1)
    dt: t.Union[float, torch.Tensor]            # (R, 1, 1): the move
    neg_dt: t.Union[float, torch.Tensor]        # (R, 1): the weight
    nwc: t.Union[float, torch.Tensor]           # (R,)
    dt_divisor: _Divisor
    target_divisor: _Divisor
    seeds: t.Tuple[int, ...]      # the rows' rng_seed: the comb streams
    noise_keys: t.Tuple[int, ...]  # the noise's keys (a shard's own)
    sigma: float                  # one row: the noise's scale
    keys: t.Optional[torch.Tensor]    # rows: prng.key_table(noise_keys)
    sigmas: t.Optional[torch.Tensor]  # rows: (R,) scales
    slots: torch.Tensor           # (R, Wm) arange, the comb's slots
    offsets: t.Optional[torch.Tensor]  # (R, 1) row starts r Wm; None: R = 1
    #: The walker mesh whose shard this run steps; ``None`` unsharded.
    mesh: t.Any = None
    #: The run's :class:`_StepGraph` (:func:`step_graph`); ``None``: the
    #: steps run eagerly.
    graph: t.Any = None

    @property
    def shard(self) -> t.Optional[int]:
        return None if self.mesh is None else self.mesh.rank

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the mesh's shards (itself unsharded)."""
        return x if self.mesh is None else self.mesh.psum(x)


def _rows_value(values, dtype, device, ndim: int):
    """The rows' values of a constant: a Python float when they agree,
    else a ``(R,) + (1,) * (ndim - 1)`` tensor."""
    if all(v == values[0] for v in values):
        return float(values[0])
    return torch.tensor(values, dtype=dtype, device=device).view(
        (-1,) + (1,) * (ndim - 1))


def _rows_divisor(values, dtype, device) -> _Divisor:
    value = _rows_value(values, dtype, device, 1)
    if isinstance(value, float) or value.device.type == "cpu":
        return _Divisor(value)
    # The reciprocal of the double, then rounded: 1 / float32(1e-3) is
    # one ulp off float32(1 / 1e-3).
    recips = [1.0 / float(v) for v in values]
    return _Divisor(torch.tensor(recips, dtype=dtype, device=device), True)


def _rows_cfc(specs, dtype, device) -> mrbp.CFCParams:
    """The rows' parameters: each leaf the rows share as its 0-d tensor,
    each that differs as an ``(R, 1, 1)`` tensor (positions are ``(R,
    Wm, N)``)."""
    host = [spec.cfc_params for spec in specs]
    cast = [mrbp.cast_params(c, dtype, device) for c in host]

    def group(i):
        fields = []
        for j in range(len(host[0][i])):
            values = [float(c[i][j]) for c in host]
            fields.append(cast[0][i][j] if all(v == values[0] for v in values)
                          else torch.stack([c[i][j] for c in cast]).view(
                              -1, 1, 1))
        return type(host[0][i])(*fields)

    return mrbp.CFCParams(*(group(i) for i in range(3)))


def _take(x: torch.Tensor, flat: torch.Tensor,
          out: t.Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``(R, Wm, ...)`` gathered by flat walker indices ``(R,
    Wm)`` (row ``r``'s walkers are ``r Wm .. r Wm + Wm - 1``), into
    ``out`` (``x``'s shape) where given."""
    rows = x.reshape((-1,) + x.shape[2:])
    if out is None:
        return rows[flat]
    torch.index_select(rows, 0, flat.reshape(-1), out=out.view(rows.shape))
    return out


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """``(R, Wm, ...) -> (R, ...)``: each row's sum over its walkers, as
    a single sampling sums them, a sum per row: a torch sum's order
    follows its tensor's shape (and, on the card, its start's
    alignment), so a batched sum would part a fused row from its run in
    the last bit."""
    def one(row):
        if row.device.type == "cuda" and row.data_ptr() % 256:
            row = row.clone()
        return row.sum(dim=0)

    if x.shape[0] == 1:
        return one(x[0])[None]
    return torch.stack([one(row) for row in x])


def _row_consts(samplings, dtype, device, max_w: t.Optional[int] = None,
                mesh=None) -> _Consts:
    """The constants of the rows ``samplings`` (a fused sweep's, or one
    sampling) for a run in ``dtype`` on ``device`` over buffers of
    ``max_w`` slots (default: the sampling's; a shard of ``mesh``: its
    share)."""
    ref = samplings[0]
    num_rows = len(samplings)
    max_w = ref.max_num_walkers if max_w is None else max_w
    cfc, params, offsets = _rows_model(samplings, dtype, device)
    bin_size = None
    if ref.density_est_spec is not None:
        sc = cfc.model_params.supercell_size
        bin_size = sc / torch.full_like(sc, ref.density_est_spec.num_bins)
    dts = [s.time_step for s in samplings]
    seeds = tuple(int(s.rng_seed) for s in samplings)
    noise_keys = seeds if mesh is None else tuple(
        utils.shard_key(seed, mesh.rank) for seed in seeds)
    rows = num_rows > 1
    return _Consts(
        cfc=cfc, params=params, density_bin_size=bin_size,
        obd_offsets=offsets, dt=_rows_value(dts, dtype, device, 3),
        neg_dt=_rows_value([-dt for dt in dts], dtype, device, 2),
        nwc=_rows_value([s.num_walkers_control_factor for s in samplings],
                        dtype, device, 1),
        dt_divisor=_rows_divisor(dts, dtype, device),
        target_divisor=_rows_divisor(
            [float(s.target_num_walkers) for s in samplings], dtype, device),
        seeds=seeds, noise_keys=noise_keys, sigma=ref.sigma_spread,
        keys=prng.key_table(noise_keys, device) if rows else None,
        sigmas=(torch.tensor([s.sigma_spread for s in samplings],
                             dtype=dtype, device=device) if rows else None),
        slots=torch.arange(max_w, device=device).repeat(num_rows, 1),
        offsets=(torch.arange(num_rows, device=device)[:, None] * max_w
                 if rows else None),
        mesh=mesh)


def branching_comb(weights: torch.Tensor, num_walkers: torch.Tensor,
                   u: torch.Tensor, slots: t.Optional[torch.Tensor] = None
                   ) -> t.Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized stochastic branching comb on the uniforms ``u (...,
    Wm)``.

    Each valid parent ``i`` is cloned ``floor(w_i + u_i)`` times; the
    first ``max_num_walkers`` children survive.  ``parent[slot]`` is the
    number of parents whose cumulative clone count is ``<= slot``: the
    same table as the JAX package's marks matmul, by ``searchsorted``.
    Leading axes are rows, each combed on its own (``num_walkers`` then
    has them); ``slots`` is ``arange(Wm)`` in ``weights``' shape when
    the caller keeps it.

    :return: ``(parent_idx (..., Wm), new_num_walkers (...))``, both
        int64, the parents indexing within their row.
    """
    max_w = weights.shape[-1]
    if slots is None:
        slots = torch.arange(max_w, device=weights.device).expand(
            weights.shape).contiguous()
    n_clones = torch.floor(weights + u).to(torch.int64)
    n_clones = torch.where(slots < num_walkers[..., None], n_clones, 0)
    cum = torch.cumsum(n_clones, dim=-1)
    new_num = torch.clamp(cum[..., -1], max=max_w)
    parent = torch.searchsorted(cum, slots, right=True)
    return torch.clamp(parent, 0, max_w - 1), new_num


def _as_rows(state):
    """A single sampling's state (any of the samplers' ``State``
    tuples) as one row: views with a leading row axis."""
    return type(state)(*(None if x is None else x[None] for x in state))


def _row(state, r: int):
    """Row ``r`` of a rows state (views)."""
    return type(state)(*(None if x is None else x[r] for x in state))


def _rows_model(samplings, dtype, device):
    """The rows' model constants ``(cfc, params, obd_offsets)``: the
    parameters (:func:`_rows_cfc`), the kernels' vector (one row) or
    ``(R, 16)`` table, packed row by row as a single sampling packs it,
    and the OBDM grid, ``(num_pos,)`` or ``(num_pos, R, 1, 1)``."""
    cfc = _rows_cfc([s.model_spec for s in samplings], dtype, device)
    if len(samplings) == 1:
        params = pairwise.pack_params(cfc, dtype, device)
    else:
        params = torch.stack([pairwise.pack_params(
            mrbp.cast_params(s.cfc_params, dtype, device), dtype, device)
            for s in samplings])
    offsets = None
    if samplings[0].obd_est_spec is not None:
        grids = [s.obd_pos_offsets for s in samplings]
        if all(np.array_equal(g, grids[0]) for g in grids):
            offsets = torch.as_tensor(grids[0], dtype=dtype, device=device)
        else:
            offsets = torch.as_tensor(np.stack(grids, axis=1), dtype=dtype,
                                      device=device)[..., None, None]
    return cfc, params, offsets


def state_from_numpy(state, device="cuda") -> State:
    """The port's :class:`State` from a JAX ``State`` (or any object with
    the same fields, as numpy-convertible arrays) on ``device``.

    The JAX ``num_walkers`` has one entry per shard.  A one-shard state
    converts with a 0-d count; an S-shard state is the global view, with
    the ``(S,)`` counts: a sampling on an S-shard mesh steps each rank's
    slice of it, any other re-lays it out first
    (:meth:`Sampling.adapt_state_shards`).  ``cmd_accum`` and the ITC
    ring buffer (``itc_buf``, with row 0 the newest amplitude in both
    packages, and ``itc_filled``) convert when present.
    """
    fields = {}
    for name in State._fields:
        value = getattr(state, name, None)
        fields[name] = (None if value is None else
                        torch.tensor(np.asarray(value), device=device))
    num_walkers = fields["num_walkers"].to(torch.int64)
    fields["num_walkers"] = num_walkers.reshape(
        () if num_walkers.numel() == 1 else (-1,))
    return State(**fields)


def _check_shards(max_w: int, target: int, num_shards: int) -> None:
    if max_w % num_shards or target % num_shards:
        raise ValueError(
            f"max_num_walkers and target_num_walkers must be divisible by "
            f"the mesh 'walkers' axis size ({num_shards})")


def _shard_counts(state: State) -> torch.Tensor:
    """A global state's walker count per shard, ``(S,)``."""
    return state.num_walkers.reshape(-1)


def aux_from_numpy(aux_carry: dict,
                   device="cuda") -> t.Dict[str, torch.Tensor]:
    """The pure estimators' accumulators of a JAX ``SamplingBlock.
    aux_carry`` (numpy-convertible arrays) as tensors on ``device``, for
    :meth:`Sampling.replay_estimators` to continue a JAX window."""
    return {name: torch.tensor(np.asarray(value), device=device)
            for name, value in aux_carry.items()}


# -- the step replayed from CUDA graphs ---------------------------------------

#: The :class:`State` fields a step reads: one step's output, the next
#: step's input.
_CARRIED = ("pos", "drift", "energies", "weights", "num_walkers",
            "ref_energy", "total_energy", "total_weight", "cmd_accum")
#: The devices whose runs replay their steps from graphs.
_GRAPH_DEVICES = ("cuda",)


def _graphs_engage(device, num_rows: int, mesh) -> bool:
    """Whether a run replays its steps from CUDA graphs (DMC's and
    VMC's): a run of one row on a CUDA device without a walker mesh.
    Not on the CPU, for a fused sweep's rows, nor on a mesh, whose gloo
    collectives a graph cannot capture."""
    return (torch.device(device).type in _GRAPH_DEVICES and num_rows == 1
            and mesh is None)


def step_graph(device, num_rows: int, mesh,
               steps: int) -> t.Optional["_StepGraph"]:
    """The replay of a run's steps from CUDA graphs, where it engages
    (:func:`_graphs_engage`), in blocks of ``steps`` steps; ``None``
    elsewhere: the steps run eagerly.

    ``step_graph.capture_count`` counts the runs whose step was
    captured, ``step_graph.replay_count`` the steps replayed (set them
    to 0 to reset)."""
    if not _graphs_engage(device, num_rows, mesh):
        return None
    return _StepGraph(steps)


step_graph.capture_count = 0
step_graph.replay_count = 0


def _record_graph(fn):
    """``fn()`` captured in a CUDA graph with a memory pool of its own:
    ``(replay, outputs)``, where ``replay()`` runs the captured work
    again into the same outputs, on the current stream.

    Captured on a side stream (the default stream cannot be captured),
    without the ``empty_cache`` of ``torch.cuda.graph``: the memory the
    run's eager work has freed stays cached for it."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            outputs = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph.replay, outputs


class _Launches:
    """The kernels' launch counters (``(function, attribute)`` pairs)
    that a step captured on two sides advances.  A capture records the
    launches without making them: :meth:`capture` takes back what the
    capture of both sides counted, and :meth:`replayed` adds one side's
    for each replay."""

    def __init__(self, counters):
        self.counters = counters
        self.per_replay = [0] * len(counters)

    def capture(self, sides):
        """``sides()``, the capture of both sides, with its counts taken
        back."""
        before = [getattr(fn, attr) for fn, attr in self.counters]
        out = sides()
        for i, ((fn, attr), count) in enumerate(zip(self.counters, before)):
            self.per_replay[i] = (getattr(fn, attr) - count) // 2
            setattr(fn, attr, count)
        return out

    def replayed(self) -> None:
        for (fn, attr), count in zip(self.counters, self.per_replay):
            setattr(fn, attr, getattr(fn, attr) + count)


class _TwoSides:
    """The flow of a step replayed from two CUDA graphs, DMC's and VMC's
    ``_StepGraph``.  The run's first step runs eagerly (the kernels'
    first launches, a build among them, stay out of the capture); the
    second captures the step's body twice (``_capture``), each side
    reading one set of input buffers and writing its carried outputs
    into the other's, and from then on the sides replay in turn.  An
    input that is not the side's own buffer is copied in first.

    ``counters`` are the kernels' launch counters a step advances
    (:class:`_Launches`); ``counts`` the function whose
    ``capture_count`` and ``replay_count`` the graphs advance."""

    def __init__(self, counters, counts):
        self.warm = False
        self.sides = None
        self.turn = 0
        self.launches = _Launches(counters)
        self.counts = counts

    def _replay(self, given: dict, capture):
        """The outputs of the side whose turn it is, replayed on the
        inputs ``given`` by name.  Before the first replay ``capture()``
        sets ``sides``, each side ``(inputs, replay, outputs)``."""
        if self.sides is None:
            self.launches.capture(capture)
            self.counts.capture_count += 1
        inputs, replay, out = self.sides[self.turn]
        self.turn ^= 1
        for name, buf in inputs.items():
            if given[name].data_ptr() != buf.data_ptr():
                buf.copy_(given[name])
        replay()
        self.counts.replay_count += 1
        self.launches.replayed()
        return out


def _packed_props(state: State, branch: _Branch) -> torch.Tensor:
    """A step's ensemble scalars, ``(energy, weight, num_walkers,
    ref_energy, accum_energy)``, as one ``(5, R)`` float64 tensor (the
    walker count exact)."""
    return torch.stack([x.to(torch.float64) for x in (
        state.energy, state.weight, branch.num_walkers, state.ref_energy,
        state.accum_energy)])


def _block_props(steps, dtype) -> PropsData:
    """A block's per-step ensemble scalars ``(nts, R)`` on the host, from
    each step's 5-tuple, or from a graphed run's ``(nts, 5, R)``
    :func:`_packed_props` (:meth:`_StepGraph.block_props`)."""
    if isinstance(steps, torch.Tensor):
        columns = steps.unbind(1)
        return PropsData(*(
            column.to(torch.int64 if name == "num_walkers" else dtype)
            for name, column in zip(PropsData._fields, columns)))
    return PropsData(*(torch.stack(column).cpu() for column in zip(*steps)))


class _StepGraph(_TwoSides):
    """The steps of one run, replayed from two CUDA graphs
    (:class:`_TwoSides`) of the step's body (:meth:`Sampling._step_body`).

    A step never writes the buffers of its own input, which the caller
    may read after the step returns, nor the outputs of the step before
    (its branching table, which the ancestry permutations read one step
    later).  The inputs copied in are the run's first state and a CM
    accumulator reset at a window's start.  The children's positions go
    to one buffer of both sides: only the step's own estimators read
    them.  The same kernels run in the same order on the same data as
    the eager step, so a replayed step is bit-equal to it.  The ITC ring
    buffer is carried past the graph as it is.

    What outlives the step after next is copied: each step writes its
    packed scalars into the block's row ``count`` (:meth:`block_props`),
    and the state a block yields is a copy (:meth:`owned`).  A replay
    adds the K1 launches it makes to K1's launch counter."""

    def __init__(self, steps: int):
        super().__init__(((pairwise.energy_and_drift, "launch_count"),),
                         step_graph)
        self.steps = steps
        self.props = self.count = None

    def step(self, sampling: "Sampling", state: State, e_prev_slots,
             comb_u: torch.Tensor, xi: torch.Tensor, consts: _Consts):
        """:meth:`Sampling._step` of the run's next step."""
        if not self.warm:
            self.warm = True
            out = new, _, branch = sampling._step_body(
                state, e_prev_slots, comb_u, xi, consts)
            packed = _packed_props(new, branch)
            self.props = packed.new_empty((self.steps,) + packed.shape)
            self.count = torch.zeros(1, dtype=torch.int64,
                                     device=packed.device)
            self._keep(packed)
            return out
        out = self._replay(
            dict(state._asdict(), e_prev_slots=e_prev_slots, comb_u=comb_u,
                 xi=xi),
            lambda: self._capture(sampling, state, e_prev_slots, comb_u, xi,
                                  consts))
        new_state = out["state"]._replace(itc_buf=state.itc_buf,
                                          itc_filled=state.itc_filled)
        return new_state, out["e_prev_slots"], out["branch"]

    def _capture(self, sampling, state, e_prev_slots, comb_u, xi, consts):
        given = dict(state._asdict(), e_prev_slots=e_prev_slots)
        names = [name for name in _CARRIED + ("e_prev_slots",)
                 if given[name] is not None]
        sets = [{name: given[name].clone() for name in names}
                for _ in range(2)]
        cpos = torch.empty_like(state.pos)

        def side(src, dst):
            def body():
                new, e_prev, branch = sampling._step_body(
                    state._replace(**{name: src[name] for name in names
                                      if name in _CARRIED}),
                    src.get("e_prev_slots"), comb_u, xi, consts, cpos)
                carried = dict(new._asdict(), e_prev_slots=e_prev)
                floats = [name for name in names
                          if dst[name].is_floating_point()]
                torch._foreach_copy_([dst[name] for name in floats],
                                     [carried[name] for name in floats])
                for name in names:
                    if name not in floats:
                        dst[name].copy_(carried[name])
                self._keep(_packed_props(new, branch))
                return {"masks": new.masks, "energy": new.energy,
                        "weight": new.weight,
                        "accum_energy": new.accum_energy,
                        "parent": branch.parent, "valid": branch.valid}

            replay, out = _record_graph(body)
            new_state = State(
                **{name: dst.get(name) for name in _CARRIED},
                masks=out["masks"], energy=out["energy"],
                weight=out["weight"], accum_energy=out["accum_energy"])
            branch = _Branch(out["parent"], cpos, out["valid"],
                             dst["num_walkers"])
            inputs = dict(src, comb_u=comb_u, xi=xi)
            return inputs, replay, {
                "state": new_state, "e_prev_slots": dst.get("e_prev_slots"),
                "branch": branch}

        self.sides = [side(sets[0], sets[1]), side(sets[1], sets[0])]

    def _keep(self, packed: torch.Tensor) -> None:
        self.props.index_copy_(0, self.count, packed[None])
        self.count += 1

    def block_props(self) -> torch.Tensor:
        """The block's ``(steps, 5, R)`` packed scalars on the host; the
        next block writes from row 0 again."""
        props = self.props.to("cpu", copy=True)
        self.count.zero_()
        return props

    @staticmethod
    def owned(state: State) -> State:
        """``state`` with a copy of every tensor the graphs write."""
        return state._replace(**{
            name: value.clone() for name, value in state._asdict().items()
            if value is not None and name not in ("itc_buf", "itc_filled")})


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

    ``mesh`` (a ``phd_qmclib_torch.parallel.WalkerMesh``, given on each
    rank of a :func:`phd_qmclib_torch.parallel.launch`) shards the
    walker buffer over its ranks: branching per shard, population
    control global.  ``rebalance_every`` deals the valid walkers evenly
    over the shards every K blocks (``None``: never; one shard never
    needs it).
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
    mesh: t.Any = None
    rebalance_every: t.Optional[int] = None

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
        _check_shards(self.max_num_walkers, self.target_num_walkers,
                      self.num_shards)

    def __getstate__(self):
        # The fields only: the cached functions (closures) are made again
        # where the sampling is unpickled (a rank of a mesh).
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @property
    def num_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    @property
    def shard_size(self) -> int:
        """Walker slots of a shard."""
        return self.max_num_walkers // self.num_shards

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

    def _fresh_aux(self, dtype, device,
                   rows: t.Optional[int] = None) -> t.Dict[str, torch.Tensor]:
        """Zero accumulators of a shard's slots; with ``rows``, for that
        many rows."""
        lead = (self.shard_size,) if rows is None \
            else (rows, self.shard_size)
        return {name: torch.zeros(lead + shape[1:], dtype=dtype,
                                  device=device)
                for name, shape in self._pure_aux_shapes().items()}

    def _fresh_itc(self, dtype, device, rows: t.Optional[int] = None,
                   slots: t.Optional[int] = None
                   ) -> t.Dict[str, torch.Tensor]:
        """The :class:`State`'s ITC fields at the start of a fill, for
        ``slots`` walker slots (default: a shard's); with ``rows``, for
        that many rows."""
        if self.itc_est_spec is None:
            return {}
        lead = () if rows is None else (rows,)
        slots = self.shard_size if slots is None else slots
        return {"itc_buf": torch.zeros(lead + (slots,)
                                       + self._itc_buf_shape[1:],
                                       dtype=dtype, device=device),
                "itc_filled": torch.zeros(lead, dtype=torch.int32,
                                          device=device)}

    def _consts(self, dtype, device) -> _Consts:
        return _row_consts((self,), dtype, device, self.shard_size,
                           self.mesh)

    # -- state construction ---------------------------------------------------

    def build_state(self, sys_conf_set: np.ndarray,
                    ref_energy: t.Optional[float] = None,
                    dtype=None, device="cuda",
                    num_shards: t.Optional[int] = None) -> State:
        """Build the initial ensemble on ``device`` from a configuration
        set ``(num, N)`` or ``(num, 2, N)``.

        Takes the last ``target_num_walkers`` configurations, computes
        their fused energy and drift, sets unit weights, and seeds
        ``E_ref`` with the weighted ensemble energy.  On ``num_shards``
        shards (default: the mesh's) the state is the global view of the
        JAX package's layout: shard ``s`` holds configurations ``s *
        ceil(num / S) ..`` as a valid prefix of its slots, and
        ``num_walkers`` has one entry per shard (0-d on one shard).
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
        num_shards = self.num_shards if num_shards is None else num_shards
        _check_shards(max_w, self.target_num_walkers, num_shards)

        shard_size = max_w // num_shards
        per_shard = -(-num // num_shards)  # ceil
        pos = torch.zeros((max_w, nop), dtype=dtype, device=device)
        valid = torch.zeros(max_w, dtype=torch.bool, device=device)
        counts = []
        for s in range(num_shards):
            chunk = torch.as_tensor(pos_set[s * per_shard:(s + 1) * per_shard],
                                    dtype=dtype, device=device)
            start = s * shard_size
            pos[start:start + len(chunk)] = chunk
            valid[start:start + len(chunk)] = True
            counts.append(len(chunk))
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
            num_walkers=torch.tensor(counts if num_shards > 1 else num,
                                     dtype=torch.int64, device=device),
            ref_energy=f(ref_energy), accum_energy=f(energy_mean),
            total_energy=f(0.0), total_weight=f(0.0),
            cmd_accum=(torch.zeros(max_w, dtype=dtype, device=device)
                       if self.cm_diffusion_est else None),
            **self._fresh_itc(dtype, device, slots=max_w))

    # -- shards ---------------------------------------------------------------

    def _adapt(self, state: State, aux: t.Optional[dict] = None):
        """:meth:`adapt_state_shards` of ``state`` and of the pure
        accumulators ``aux`` (global, in the state's layout, or
        ``None``): ``(state, aux)``."""
        if state.num_walkers.numel() == self.num_shards:
            return state, aux
        src = _shard_counts(state).tolist()
        max_w, num_shards = state.max_num_walkers, self.num_shards
        if max_w != self.max_num_walkers or max_w % len(src) \
                or max_w % num_shards:
            raise ValueError(
                f"cannot re-layout a {len(src)}-shard state of {max_w} "
                f"slots onto {num_shards} shards of {self.max_num_walkers}")
        src_size = max_w // len(src)
        valid_idx = [s * src_size + k for s, c in enumerate(src)
                     for k in range(c)]
        num = len(valid_idx)
        shard_size = max_w // num_shards
        per_shard = -(-num // num_shards)  # ceil, like build_state
        dest_idx, counts = [], []
        for s in range(num_shards):
            chunk = min(per_shard, num - len(dest_idx), shard_size)
            dest_idx.extend(range(s * shard_size, s * shard_size + chunk))
            counts.append(chunk)
        device = state.pos.device
        dest = torch.tensor(dest_idx, dtype=torch.int64, device=device)
        valid = torch.tensor(valid_idx[:len(dest_idx)], dtype=torch.int64,
                             device=device)

        def relayout(buf):
            if buf is None:
                return None
            buf = torch.as_tensor(buf, device=device)
            out = torch.zeros_like(buf)
            out[dest] = buf[valid]
            return out

        masks = torch.ones(max_w, dtype=torch.bool, device=device)
        masks[dest] = False
        fields = {name: relayout(getattr(state, name))
                  for name in WALKER_FIELDS if name != "masks"}
        state = state._replace(
            masks=masks, **fields, num_walkers=torch.tensor(
                counts if num_shards > 1 else counts[0], dtype=torch.int64,
                device=device))
        if aux is not None:
            aux = {name: relayout(value) for name, value in aux.items()}
        return state, aux

    def adapt_state_shards(self, state: State) -> State:
        """Re-lay out a global state saved under another shard count
        (``num_walkers`` with one entry per shard; a 0-d count is one
        shard) onto this sampling's shards.

        The valid walkers compact in slot order and fill this sampling's
        per-shard prefixes as :meth:`build_state` does, each with every
        per-walker buffer (positions, drift, energies, weights, the CM
        accumulator and the ITC ring buffer): values kept, not
        recomputed, so the physics continues from the saved ensemble (the
        random streams are per shard, so the trajectory continues
        statistically, not bit for bit).  Nothing changes when the
        layouts match.
        """
        return self._adapt(state)[0]

    def rebalance(self, state: State) -> State:
        """Deal the valid walkers of a global state (``(S,)`` counts)
        evenly over its S shards: packed in slot order, walker ``k`` goes
        to slot ``(k % S) * shard_size + k // S``, a bijection of the
        slots, so every shard keeps a valid prefix, and the per-walker
        buffers (the CM accumulator and the ITC ring buffer included)
        move with their walkers.  The JAX package's ``rebalance``, on a
        sampling of S shards."""
        num_shards = _shard_counts(state).numel()
        max_w = state.max_num_walkers
        shard_size = max_w // num_shards
        device = state.pos.device
        slots = torch.arange(max_w, device=device)
        shard_of, row_of = slots // shard_size, slots % shard_size
        valid = row_of < _shard_counts(state)[shard_of]
        order = torch.argsort(torch.where(valid, 0, 1), stable=True)
        dest = (slots % num_shards) * shard_size + slots // num_shards
        n_total = valid.sum()
        shards = torch.arange(num_shards, device=device)
        counts = n_total // num_shards + (shards < n_total % num_shards)
        new_valid = row_of < counts[shard_of]

        def permute(buf, masked=True):
            if buf is None:
                return None
            out = torch.zeros_like(buf)
            out[dest] = buf[order]
            if not masked:
                return out
            return torch.where(new_valid.view((-1,) + (1,) * (buf.dim() - 1)),
                               out, 0.0)

        return state._replace(
            pos=permute(state.pos, masked=False),
            drift=permute(state.drift), energies=permute(state.energies),
            weights=permute(state.weights), masks=~new_valid,
            num_walkers=counts.reshape(state.num_walkers.shape),
            cmd_accum=permute(state.cmd_accum),
            itc_buf=permute(state.itc_buf))

    def _rebalance_shard(self, state: State) -> State:
        """:meth:`rebalance` of the rank's shard ``state``: the rank's
        shard of the rebalanced global view."""
        return self._shard_of(self.rebalance(
            self.mesh.gather_state(state)))[0]

    def _shard_of(self, state: State, aux: t.Optional[dict] = None):
        """This rank's shard of a global ``state`` (re-laid out first when
        its shard count differs) and of the pure accumulators ``aux``,
        with a 0-d walker count, on the mesh's device: ``(state, aux)``.
        Unsharded, the state itself."""
        state, aux = self._adapt(state, aux)
        if self.mesh is None:
            if aux is not None:
                aux = {name: torch.as_tensor(value)
                       for name, value in aux.items()}
            return state._replace(
                num_walkers=state.num_walkers.reshape(())), aux
        device, rank = self.mesh.device, self.mesh.rank
        lo, hi = rank * self.shard_size, (rank + 1) * self.shard_size
        fields = {name: (value[lo:hi] if name in WALKER_FIELDS
                         and value is not None else value)
                  for name, value in state._asdict().items()}
        fields["num_walkers"] = _shard_counts(state)[rank]
        local = State(**{name: None if value is None else value.to(device)
                         for name, value in fields.items()})
        if aux is not None:
            aux = {name: torch.as_tensor(value)[lo:hi].to(device)
                   for name, value in aux.items()}
        return local, aux

    # -- the step -------------------------------------------------------------

    def _step(self, state: State, e_prev_slots: t.Optional[torch.Tensor],
              comb_u: torch.Tensor, xi: torch.Tensor, consts: _Consts):
        """One time step of R rows (:func:`_row_consts`; every field of
        ``state`` with the rows' leading axis) with the comb uniforms
        ``comb_u (R, Wm)`` and the pre-scaled diffusion noise ``xi (R,
        Wm, N)``.

        ``e_prev_slots`` is the slot-wise previous-step energy of
        ``ref_compat`` (``None`` otherwise).  A state with a
        ``cmd_accum`` transports it through the parents and adds the
        step's CM displacement.  Each row combs, controls and diffuses
        with its own constants, exactly as its single sampling would.
        Returns ``(new_state, new_e_prev_slots, branch)``, where
        ``branch`` is the post-branching ensemble the estimators
        measure.

        The step runs :meth:`_step_body`, or replays it from the run's
        CUDA graphs (``consts.graph``, :func:`step_graph`): then the
        returned tensors are the graphs' buffers, which the step after
        next overwrites.
        """
        if consts.graph is not None:
            return consts.graph.step(self, state, e_prev_slots, comb_u, xi,
                                     consts)
        return self._step_body(state, e_prev_slots, comb_u, xi, consts)

    def _step_body(self, state: State,
                   e_prev_slots: t.Optional[torch.Tensor],
                   comb_u: torch.Tensor, xi: torch.Tensor, consts: _Consts,
                   cpos: t.Optional[torch.Tensor] = None):
        """The work of :meth:`_step`, run eagerly or captured; ``cpos``
        is a buffer for the children's positions."""
        # 1) Branching comb on the previous step's weights, row by row.
        parent, nw = branching_comb(state.weights, state.num_walkers,
                                    comb_u, consts.slots)
        valid = consts.slots < nw[:, None]
        if consts.offsets is not None:
            parent = parent + consts.offsets

        # 2) Children: cloned (pre-diffusion) parents with parent
        #    energies.
        cpos = _take(state.pos, parent, cpos)
        cdrift = _take(state.drift, parent)
        cenergy = _take(state.energies, parent)

        state_energy = _row_sums(torch.where(valid, cenergy, 0.0))
        state_weight = nw.to(state.pos.dtype)
        nw_total = nw
        if consts.mesh is not None:
            # The shards' sums in one collective; the counts are exact
            # integers in the state's type.
            sums = consts.psum(torch.stack([state_energy, state_weight],
                                           dim=-1))
            state_energy, state_weight = sums[..., 0], sums[..., 1]
            nw_total = state_weight.to(torch.int64)

        # 3) Population-control update.
        total_energy = state.total_energy + state_energy
        total_weight = state.total_weight + state_weight
        accum_energy = total_energy / total_weight
        new_ref = accum_energy - consts.dt_divisor.divide(
            consts.nwc * torch.log(consts.target_divisor.divide(
                torch.clamp(state_weight, min=1.0))))

        # 4) Diffuse the children with the PREVIOUS E_ref: move, energy
        #    and drift, and the branching weight.
        if e_prev_slots is not None:
            # Only live slots are written: a slot that goes dead and
            # later revives sees its stale energy.
            e_prev = e_prev_slots
            e_prev_slots = torch.where(valid, cenergy, e_prev_slots)
        else:
            e_prev = cenergy
        npos, nenergy, ndrift, nweight = self._diffuse(
            cpos, cdrift, e_prev, xi, state.ref_energy[:, None], consts.cfc,
            consts.params, consts.dt, consts.neg_dt)
        nweight = torch.where(valid, nweight, 0.0)
        cmd_accum = state.cmd_accum
        if cmd_accum is not None:
            cmd_accum = _take(cmd_accum, parent) \
                + (2.0 * cdrift * consts.dt + xi).mean(dim=-1)

        new_state = State(
            pos=npos, drift=ndrift, energies=nenergy, weights=nweight,
            masks=~valid, energy=state_energy, weight=state_weight,
            num_walkers=nw, ref_energy=new_ref, accum_energy=accum_energy,
            total_energy=total_energy, total_weight=total_weight,
            cmd_accum=cmd_accum, itc_buf=state.itc_buf,
            itc_filled=state.itc_filled)
        return new_state, e_prev_slots, _Branch(parent, cpos, valid,
                                                nw_total)

    def _diffuse(self, cpos, cdrift, e_prev, xi, ref_energy, cfc, params,
                 dt, neg_dt):
        """:meth:`diffuse` with the time step ``dt`` (and ``neg_dt =
        -dt``) as floats, or as the rows' tensors."""
        npos = mrbp.recast(cpos + 2.0 * cdrift * dt + xi, cfc)
        nenergy, ndrift = self.core_funcs.energy_and_drift(npos, cfc, params)
        nweight = torch.exp(neg_dt * (0.5 * (nenergy + e_prev) - ref_energy))
        return npos, nenergy, ndrift, nweight

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
        return self._diffuse(cpos, cdrift, e_prev, xi, ref_energy, cfc,
                             params, dt, -dt)

    def _estimate(self, consts: _Consts, aux: dict,
                  perm: t.Optional[torch.Tensor],
                  itc_perm: t.Optional[torch.Tensor], branch: _Branch,
                  state: State, step_idx: int):
        """The estimators of one measured step of R rows (every tensor
        with the rows' leading axis; the permutations flat over the rows,
        as :meth:`_step`'s parents).

        ``perm`` is the ancestry permutation composed over the
        transport-only steps since the last measured one (``None``: the
        identity); every accumulator but the ITC pair is gathered
        through ``perm[parent]`` once.  ``itc_perm`` is the ITC
        estimator's own composition, this step's parents included, over
        the steps since the last ITC-measured one.  ``state`` is the
        step's new state (its CM accumulator and ITC ring buffer), and
        ``step_idx`` the step's index in the forward-walking window.
        Returns ``(new_aux, est, new_state)`` with one ``(R, ...)`` row
        per estimator measured at this step; each row's walker sums are
        its single sampling's (:func:`_row_sums`).
        """
        funcs, cfc = self.core_funcs, consts.cfc
        cpos, valid = branch.pos, branch.valid
        anc = branch.parent if perm is None \
            else perm.reshape(-1)[branch.parent]
        aux = {name: acc if name in _ITC_AUX else _take(acc, anc)
               for name, acc in aux.items()}
        est = {}

        def masked_sum(x):
            return _row_sums(torch.where(
                valid.view(valid.shape + (1,) * (x.dim() - 2)), x, 0.0))

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
            with tracing.span(tracing.DENSITY):
                hist = histogram.walker_histogram(
                    cpos, consts.density_bin_size, spec.num_bins)
                hist = torch.where(valid[..., None], hist, 0.0)
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
                                     consts.obd_offsets, cpos, cfc,
                                     consts.params))
        spec = self.pair_corr_est_spec
        if spec is not None and due(spec):
            est["g2"] = measure("aux_g2", spec,
                                funcs.pair_dist_histogram(
                                    spec.num_bins, cpos, cfc))
        if state.cmd_accum is not None:
            est["cmd"] = torch.stack([masked_sum(state.cmd_accum ** 2),
                                      masked_sum(state.cmd_accum)], dim=1)

        spec = self.itc_est_spec
        if spec is not None and due(spec):
            with tracing.span(tracing.ITC):
                num_lags, num_modes = spec.num_lags, spec.num_modes
                # One gather through the composed permutation: the same
                # rows as a gather through the parents on every step.
                buf = _take(state.itc_buf, itc_perm)
                # The amplitudes of the post-branching ensemble: the
                # S(k) estimator's own (re, im) slots when it has the
                # modes.
                from_ssf = ssf_parts is not None \
                    and self.ssf_est_spec.num_modes >= num_modes
                if from_ssf:
                    reim = ssf_parts[..., :num_modes, 1:3]
                else:
                    reim = funcs.fourier_density_reim_harmonics(
                        num_modes, cpos, cfc)
                re, im = reim[..., 0], reim[..., 1]
                maskf = valid.to(cpos.dtype)
                lag_ok = (torch.arange(1, num_lags + 1, device=cpos.device)
                          <= state.itc_filled[:, None]).to(cpos.dtype)
                # Re[rho_k(t) conj(rho_k(t - l))] per walker, lag and
                # mode, as a multiply and add in the tensors' own
                # precision (no matrix-product path whose precision a
                # global flag sets).
                prod_w = (buf[..., 0] * re[:, :, None]
                          + buf[..., 1] * im[:, :, None]) \
                    * maskf[:, :, None, None]
                if spec.as_pure_est:
                    sq_w = torch.where(valid[..., None],
                                       re ** 2 + im ** 2, 0.0)
                    contrib = torch.cat([sq_w[:, :, None], prod_w], dim=2)
                    cnt_row = torch.cat(
                        [lag_ok.new_ones((lag_ok.shape[0], 1)), lag_ok],
                        dim=1)
                    acc = _take(aux["aux_itc"], itc_perm)
                    cnt = _take(aux["aux_itc_cnt"], itc_perm)
                    if step_idx < self._pfw_steps(spec):
                        acc = acc + contrib
                        cnt = cnt + maskf[:, :, None] * cnt_row[:, None]
                    aux["aux_itc"], aux["aux_itc_cnt"] = acc, cnt
                    divisor = pure_divisor(spec, acc)
                    est["itc"] = masked_sum(acc) / divisor
                    est["itc_nw"] = masked_sum(cnt) / divisor
                else:
                    # Lag 0 equals the S(k) estimator's mixed slot-0 sums
                    # bit for bit: a sum's order follows its tensor's
                    # shape, so take the walker sum over the S(k) parts
                    # themselves.
                    lag0 = masked_sum(ssf_parts)[:, :num_modes, 0] \
                        if from_ssf else masked_sum(re ** 2 + im ** 2)
                    est["itc"] = torch.cat(
                        [lag0[:, None], _row_sums(prod_w)], dim=1)
                    nwf = state.num_walkers.to(cpos.dtype)[:, None]
                    est["itc_nw"] = torch.cat([nwf, nwf * lag_ok], dim=1)
                state = state._replace(
                    itc_buf=torch.cat([reim[:, :, None], buf[:, :, :-1]],
                                      dim=2),
                    itc_filled=torch.clamp(state.itc_filled + 1,
                                           max=num_lags))
        return aux, est, state

    def _run(self, state: State, draws, consts: _Consts,
             measuring: bool, aux: t.Optional[dict], step_offset: int,
             thin: int = 0):
        """Step R rows (:meth:`_step`) through ``draws``, an iterable of
        ``(comb_u, xi)``.

        With ``measuring``, every ``est_every``-th step measures the
        estimators (step ``k`` of the run has index ``step_offset + k``
        in the forward-walking window) and the steps in between compose
        the ancestry permutation.  The ITC ring buffer's permutation
        composes on every step and resets at the ITC-measured ones;
        without ``measuring`` the buffer is neither transported nor
        shifted.  Returns ``(state, aux, props, est, ensembles)``: the
        per-step ensemble scalars (none where the steps replay from
        graphs, which keep them: :meth:`_StepGraph.block_props`) and
        estimator rows and, with ``thin``, every ``thin``-th step's
        ``(pos, energies, weights)``, as lists of device tensors with the
        rows' leading axis.
        """
        e_prev_slots = state.energies if self.ref_compat else None
        cadence = self.est_every
        use_itc = measuring and self.itc_est_spec is not None
        perm = itc_perm = None
        props, est, ensembles = [], {}, []
        for step, (comb_u, xi) in enumerate(draws):
            with tracing.span(tracing.STEP_DMC):
                state, e_prev_slots, branch = self._step(
                    state, e_prev_slots, comb_u, xi, consts)
            if consts.graph is None:
                props.append((state.energy, state.weight,
                              branch.num_walkers, state.ref_energy,
                              state.accum_energy))
            if thin and (step + 1) % thin == 0:
                ensembles.append((state.pos, state.energies, state.weights))
            if not measuring:
                continue
            if use_itc:
                itc_perm = (branch.parent if itc_perm is None
                            else itc_perm.reshape(-1)[branch.parent])
            if (step + 1) % cadence:
                if any(name not in _ITC_AUX for name in aux):
                    perm = (branch.parent if perm is None
                            else perm.reshape(-1)[branch.parent])
                continue
            aux, rows, state = self._estimate(
                consts, aux, perm, itc_perm, branch, state,
                step_offset + step)
            perm = None
            if "itc" in rows:
                itc_perm = None
            for name, row in rows.items():
                est.setdefault(name, []).append(row)
        return state, aux, props, est, ensembles

    def _draws(self, consts: _Consts, block_index: int,
               num_time_steps_block: int, noise: torch.Tensor,
               comb: torch.Tensor):
        """The comb uniforms and diffusion noise of one block of R rows,
        drawn on the device as the steps consume them: each row's
        uniforms from its own ``torch.Generator``, seeded from
        ``(rng_seed, block index)`` as its single sampling's, and its
        noise, already scaled by its sigma, keyed by ``(rng_seed, global
        step index)``.  The noise goes into the run's buffer ``noise (R,
        Wm, N)`` (one launch for all rows), the rows' uniforms into
        the run's ``comb (R, Wm)``: each step consumes them before the
        next draw, in stream order.
        A shard of a mesh draws its own streams: the comb's seeded from
        ``(rng_seed, block index, shard)``, the noise keyed by its
        ``consts.noise_keys``."""
        dtype, device = noise.dtype, noise.device
        gens = []
        for seed in consts.seeds:
            gen = torch.Generator(device=device)
            gen.manual_seed(utils.block_seed(seed, block_index, consts.shard))
            gens.append(gen)
        for step in range(num_time_steps_block):
            global_step = block_index * num_time_steps_block + step
            for gen, row in zip(gens, comb):
                row.uniform_(0, 1, generator=gen)
            if consts.keys is None:
                prng.normal(consts.noise_keys[0], global_step,
                            noise.shape[1:],
                            dtype, device, scale=consts.sigma, out=noise[0])
            else:
                prng.normal_rows(consts.keys, global_step, consts.sigmas,
                                 noise)
            yield comb, noise

    def _row_blocks(self, consts: _Consts, ini_state: State,
                    num_time_steps_block: int, burn_in_blocks: int,
                    block_offset: int, start_block_idx: int,
                    aux_init: t.Optional[dict],
                    rebalance_pending0: bool = False):
        """The block loop of :meth:`blocks` on R rows: ``ini_state`` and
        ``aux_init`` have the rows' leading axis, this sampling gives
        the static structure and ``consts`` (:func:`_row_consts`) the
        rows' own constants.  Yields ``(props, rows, state, aux_carry)``
        per block: the per-step scalars ``(nts, R)`` on the host, the
        estimator rows ``(R, n, ...)`` on the host by name (none in
        burn-in blocks), the last state and the carried accumulators.
        On a mesh (one row, a shard of it) the estimator rows are the
        shards' sums, and a due rebalance runs at the start of a block:
        every ``rebalance_every`` blocks, held until a forward-walking
        window starts (``rebalance_pending0`` re-arms one a checkpoint
        cut before its window's start)."""
        state = ini_state
        num_rows = state.pos.shape[0]
        dtype, device = state.pos.dtype, state.pos.device
        if self.cm_diffusion_est and state.cmd_accum is None:
            state = state._replace(cmd_accum=torch.zeros(
                state.pos.shape[:2], dtype=dtype, device=device))
        start_block_idx = int(start_block_idx)
        if self.itc_est_spec is not None and (
                state.itc_buf is None or start_block_idx < burn_in_blocks):
            # A state without the ring buffer starts an empty fill (the
            # lag counts discount the unfilled rows).  A filled buffer
            # would come out of the burn-in misaligned with its slots,
            # walkers cloned and killed under it, yet counted as valid.
            state = state._replace(**self._fresh_itc(dtype, device,
                                                     num_rows))
        nts = num_time_steps_block
        window = self.pfw_window_blocks(nts)
        cmd_window = self.cm_window_blocks
        noise = torch.empty(state.pos.shape, dtype=dtype, device=device)
        comb = torch.empty(state.weights.shape, dtype=dtype, device=device)
        consts = consts._replace(graph=step_graph(device, num_rows,
                                                  consts.mesh, nts))
        aux = None
        if window > 1 and aux_init is not None:
            aux = self._fresh_aux(dtype, device, num_rows)
            aux.update((name, torch.as_tensor(value, dtype=dtype,
                                              device=device))
                       for name, value in aux_init.items() if name in aux)
        block = start_block_idx
        rebalance_every = self.rebalance_every if self.num_shards > 1 \
            else None
        rebalance_pending = bool(rebalance_pending0)
        while True:
            measured_idx = block - burn_in_blocks
            measuring = measured_idx >= 0
            if rebalance_every and block and block % rebalance_every == 0:
                rebalance_pending = True
            if rebalance_pending and (measured_idx <= 0
                                      or measured_idx % window == 0):
                # The pure accumulators ride outside the state: a due
                # rebalance waits for a window's start, where they are
                # zero, as in the JAX package.
                state = _as_rows(self._rebalance_shard(_row(state, 0)))
                rebalance_pending = False
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
                if win_pos == 0 or aux is None:
                    # A window's start; or a resume inside a window
                    # without its accumulators, which restart from zero.
                    aux = self._fresh_aux(dtype, device, num_rows)
                step_offset = win_pos * nts
            draws = self._draws(consts, block_offset + block, nts, noise,
                                comb)
            with tracing.span(tracing.RUN_DMC):
                state, aux, steps, est, _ = self._run(
                    state, draws, consts, measuring, aux, step_offset)
            props = _block_props(
                steps if consts.graph is None
                else consts.graph.block_props(), dtype)
            # The shards' estimator sums, once per block.
            rows = {name: consts.psum(torch.stack(values, dim=1)).cpu()
                    for name, values in est.items()}
            yield (props, rows,
                   state if consts.graph is None
                   else consts.graph.owned(state),
                   aux if measuring and window > 1 else None)
            block += 1

    # -- public sampling APIs -------------------------------------------------

    def blocks(self, ini_state: State, num_time_steps_block: int,
               burn_in_blocks: int = 0,
               block_offset: int = 0,
               start_block_idx: int = 0,
               aux_init: t.Optional[dict] = None,
               rebalance_pending0: bool = False
               ) -> t.Iterator[SamplingBlock]:
        """Yield :class:`SamplingBlock` objects indefinitely.

        The first ``burn_in_blocks`` blocks run the dynamics only: no
        estimator is measured and their rows are ``None`` (the CM
        accumulator still advances, and its first window opens with the
        first measured block; the ITC ring buffer is neither
        transported nor shifted there, so a run with burn-in blocks
        restarts its fill, whatever the initial state carried).  A
        forward-walking window longer than one block carries the pure
        accumulators across blocks (``aux_carry``), with the step index
        counted from the window's start.  ``block_offset`` continues
        the random streams of a run that already consumed that many
        blocks: the comb stream of block ``b`` is seeded from
        ``(rng_seed, block_offset + b)`` and the diffusion noise of its
        step ``t`` is keyed by ``(rng_seed, (block_offset + b) * nts +
        t)``.

        A run interrupted after block ``b - 1`` resumes with
        ``start_block_idx = b`` from the state that block left: the
        block counter starts there, so the random streams, the position
        in the forward-walking window and the CM window cadence are
        those of the uninterrupted run, and past the burn-in the ITC
        ring buffer keeps its fill.  ``aux_init`` (arrays or tensors by
        accumulator name) are the pure accumulators of a window that
        spans the cut; names it lacks start from zero.

        The loop is a fused sweep's (``phd_qmclib_torch.parallel.
        ParamSweep``) with this sampling as its one row.

        On a mesh every rank calls this with the global view of the
        state (and of ``aux_init``), and steps its shard of it on the
        mesh's device: ``last_state`` and ``aux_carry`` are the rank's
        shard (``mesh.gather_state`` gives the global view), the
        per-step scalars and the estimator rows the whole ensemble's.
        ``rebalance_pending0`` re-arms a cadence rebalance that a
        checkpoint cut while it waited for its window's start.  A state
        of another shard count is re-laid out first
        (:meth:`adapt_state_shards`).
        """
        state, aux_init = self._shard_of(ini_state, aux_init)
        state = _as_rows(state)
        consts = self._consts(state.pos.dtype, state.pos.device)
        if aux_init is not None:
            aux_init = {name: value[None] for name, value in aux_init.items()}
        for props, rows, last, carry in self._row_blocks(
                consts, state, num_time_steps_block, burn_in_blocks,
                block_offset, start_block_idx, aux_init,
                rebalance_pending0):
            rows = {name: value[0] for name, value in rows.items()}
            yield SamplingBlock(
                PropsData(*(column[:, 0] for column in props)),
                rows.get("density"), rows.get("ssf"), _row(last, 0),
                iter_obd=rows.get("obd"), iter_cmd=rows.get("cmd"),
                iter_g2=rows.get("g2"), iter_itc=rows.get("itc"),
                iter_itc_nw=rows.get("itc_nw"),
                aux_carry=(None if carry is None else
                           {name: acc[0] for name, acc in carry.items()}))

    def states(self, ini_state: State) -> t.Iterator[State]:
        """Step-by-step state generator (one block per step); use
        :meth:`blocks` for production."""
        for block in self.blocks(ini_state, num_time_steps_block=1):
            yield block.last_state

    def state_data_blocks(self, ini_state: State,
                          num_time_steps_block: int, thin: int = 1,
                          block_offset: int = 0):
        """Yield blocks that also record the walker ensembles.

        Yields ``(ensembles, block)``: ``ensembles`` is a dict with
        ``pos (nts // thin, Wm, N)``, ``energies`` and ``weights``, every
        ``thin``-th step's post-diffusion ensemble on the state's
        device, and ``block`` the usual :class:`SamplingBlock`.  No
        estimator is measured while recording, and the block streams are
        those of :meth:`blocks` at the same ``block_offset``.  On a mesh,
        as in :meth:`blocks`, the ensembles are the rank's shard's.
        """
        if num_time_steps_block % thin:
            raise ValueError(
                "num_time_steps_block must be divisible by thin")
        state = _as_rows(self._shard_of(ini_state)[0])
        consts = self._consts(state.pos.dtype, state.pos.device)
        noise = torch.empty(state.pos.shape, dtype=state.pos.dtype,
                            device=state.pos.device)
        comb = torch.empty(state.weights.shape, dtype=state.pos.dtype,
                           device=state.pos.device)
        block = int(block_offset)
        while True:
            draws = self._draws(consts, block, num_time_steps_block, noise,
                                comb)
            state, _, steps, _, kept = self._run(
                state, draws, consts, False, None, 0, thin)
            props = PropsData(*(torch.stack(column)[:, 0].cpu()
                                for column in zip(*steps)))
            ensembles = dict(zip(("pos", "energies", "weights"),
                                 (torch.stack(column)[:, 0]
                                  for column in zip(*kept))))
            yield ensembles, SamplingBlock(props, None, None,
                                           _row(state, 0))
            block += 1

    def _replay(self, consts: _Consts, state: State, comb_u: torch.Tensor,
                xi: torch.Tensor) -> t.Dict[str, torch.Tensor]:
        """:meth:`replay_states` of R rows (:func:`_row_consts`): ``comb_u
        (nts, R, Wm)``, ``xi (nts, R, Wm, N)``; each output with the
        rows' axis after the steps', ``parent`` within its row."""
        e_prev_slots = state.energies if self.ref_compat else None
        offsets = 0 if consts.offsets is None else consts.offsets
        out = {name: [] for name in (
            "num_walkers", "energy", "weight", "ref_energy",
            "accum_energy", "pos", "energies", "weights", "parent")}
        for step in range(comb_u.shape[0]):
            state, e_prev_slots, branch = self._step(
                state, e_prev_slots, comb_u[step], xi[step], consts)
            for name in out:
                out[name].append(
                    branch.parent - offsets if name == "parent"
                    else branch.num_walkers if name == "num_walkers"
                    else getattr(state, name))
        return {name: torch.stack(values) for name, values in out.items()}

    def replay_states(self, ini_state: State, comb_u,
                      diffusion_noise) -> t.Dict[str, torch.Tensor]:
        """Run the dynamics with injected noise: the comb uniforms
        ``comb_u (nts, Wm)`` and the pre-scaled Gaussian displacements
        ``diffusion_noise (nts, Wm, N)`` (``~N(0, sigma)``).

        Returns per-step tensors: ``num_walkers, energy, weight,
        ref_energy, accum_energy`` (the ensemble scalars), ``pos,
        energies, weights`` (the post-diffusion ensemble) and ``parent``
        (the branching table).  On a mesh the state and the draws are
        the global ones: each rank steps its shard with its slice of the
        draws and returns its shard's ensemble (``parent`` within the
        shard), and the whole ensemble's scalars.
        """
        ini_state, _ = self._shard_of(ini_state)
        comb_u, xi = self._shard_draws(ini_state, comb_u, diffusion_noise)
        out = self._replay(
            self._consts(ini_state.pos.dtype, ini_state.pos.device),
            _as_rows(ini_state), comb_u[:, None], xi[:, None])
        return {name: value[:, 0] for name, value in out.items()}

    def _shard_draws(self, state: State, comb_u, diffusion_noise):
        """This rank's slice of injected global draws, as tensors like
        ``state``'s."""
        lo = 0 if self.mesh is None else self.mesh.rank * self.shard_size

        def part(draws):
            draws = torch.as_tensor(draws, dtype=state.pos.dtype)
            return draws[:, lo:lo + self.shard_size].to(state.pos.device)

        return part(comb_u), part(diffusion_noise)

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
        buffer.  On a mesh, as in :meth:`replay_states`: the estimator
        rows are the shards' sums, the accumulators and the state the
        rank's shard.
        """
        ini_state, aux_in = self._shard_of(ini_state, aux_in)
        dtype, device = ini_state.pos.dtype, ini_state.pos.device
        comb_u, xi = self._shard_draws(ini_state, comb_u, diffusion_noise)
        aux = self._fresh_aux(dtype, device, 1)
        if aux_in is not None:
            aux = {name: aux_in[name].to(dtype=dtype, device=device)[None]
                   for name in aux}
        if self.itc_est_spec is not None and ini_state.itc_buf is None:
            ini_state = ini_state._replace(
                **self._fresh_itc(dtype, device))
        consts = self._consts(dtype, device)
        state, aux, _, est, _ = self._run(
            _as_rows(ini_state), zip(comb_u[:, None], xi[:, None]),
            consts, True, aux, step_offset)
        return ({name: consts.psum(torch.stack(rows))[:, 0]
                 for name, rows in est.items()},
                {name: acc[0] for name, acc in aux.items()}, _row(state, 0))
