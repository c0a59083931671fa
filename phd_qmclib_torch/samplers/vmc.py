"""Variational Monte Carlo: Metropolis sampling of ``|psi|^2``.

Counterpart of ``phd_qmclib_tpu.samplers.vmc``: ``num_walkers``
independent Markov chains advance in lockstep.  Each
step, as in the JAX package:

1. every particle of every chain moves by ``move_spread (u - 1/2)``
   with ``u`` uniform in [0, 1) or, with ``gaussian``, by a normal of
   width ``move_spread``; the proposal is recast into ``[0, L)``;
2. the fused log|psi| and local energy of the proposal: the log|psi|
   variant of the pair kernel;
3. the reference's Metropolis test: accept when
   ``log|psi'| > log(u)/2 + log|psi|``;
4. when the estimators measure every step, the S(k) parts (and the OBDM
   grid) of the proposal, carried through rejections.

``est_every = K``, an OBDM or g2 ``est_every_mult`` above 1, or the g2
estimator at all switch to the chunked cadence: K plain steps, then the
S(k), OBDM and g2 sums of the chunk-final configurations.  Its entries
equal the every-step mode's at the measured steps, and the chain
dynamics are the same for any K.

:meth:`Sampling.blocks` is a Python loop over steps that never waits on
the device inside a block: the per-step properties and estimator rows
stay on the device and are stacked once per block, and the acceptance
rate is the one value fetched per block.  The uniform draws (moves and
acceptance) come from a ``torch.Generator`` on the device, seeded per
block from ``(rng_seed, block index)``; the Gaussian moves from the
Philox normals kernel keyed by ``(rng_seed, global step index)``.

On a walker mesh (``mesh``, one process per device) the chains split
over the ranks, ``num_walkers / S`` each, with their own streams (seeded
from ``(rng_seed, block index, shard)``, the noise keyed by ``(rng_seed,
shard)``).  The chains never couple: only the block's S(k), OBDM and g2
sums (``mesh.psum``, once per block) and the acceptance rate (their
mean, ``mesh.pmean``) cross the shards, and the per-step properties are
gathered, so that a block holds what the whole ensemble did.  A state
given to the sampler is the global one; ``last_state`` is the rank's
chains.
"""
import dataclasses
import typing as t
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .. import utils
from ..models import mrbp
from ..ops import prng
from .dmc import _as_rows, _row, _row_sums, _rows_model, _rows_value

__all__ = [
    "OBDEstSpec",
    "PairCorrEstSpec",
    "PropsData",
    "Sampling",
    "SamplingBlock",
    "SSFEstSpec",
    "State",
    "state_from_numpy",
]


class State(t.NamedTuple):
    """The chain ensemble: ``pos (W, N)``, and per chain its log|psi|,
    local energy and last acceptance flag, plus the S(k) and OBDM parts
    the every-step mode carries through rejections."""
    pos: torch.Tensor
    wf_abs_log: torch.Tensor
    energy: torch.Tensor
    move_stat: torch.Tensor
    ssf_parts: t.Optional[torch.Tensor] = None  # (W, M, 3)
    obd_parts: t.Optional[torch.Tensor] = None  # (W, M)


class PropsData(t.NamedTuple):
    """Per-step, per-chain properties of a block, ``(nts, W)`` each, on
    the state's device."""
    wf_abs_log: torch.Tensor
    energy: torch.Tensor
    move_stat: torch.Tensor  # bool


class SamplingBlock(t.NamedTuple):
    """The data of one block; the estimator rows are sums over the
    chains, one per measured step, on the state's device, and ``None``
    when the estimator is off."""
    iter_props: PropsData
    #: ``(nts // K, num_modes, 3)``: |rho_k|^2, Re rho_k, Im rho_k.
    iter_ssf: t.Optional[torch.Tensor]
    accept_rate: float
    last_state: State
    iter_obd: t.Optional[torch.Tensor] = None  # (nts // (K m), num_pos)
    iter_g2: t.Optional[torch.Tensor] = None   # (nts // (K m), num_bins)


@dataclass(frozen=True)
class SSFEstSpec:
    """Static structure factor spec: the harmonic momenta
    ``k_j = j 2 pi / L``, ``j < num_modes``."""
    num_modes: int


@dataclass(frozen=True)
class OBDEstSpec:
    """One-body density matrix spec: ``n1(sz)`` on a ``num_pos``-point
    grid over ``[0, L/2]``, measured every ``est_every *
    est_every_mult``-th step."""
    num_pos: int
    est_every_mult: int = 1


@dataclass(frozen=True)
class PairCorrEstSpec:
    """Direct pair-correlation spec: a histogram of unordered-pair
    minimum-image distances on ``num_bins`` bins over ``[0, L/2]``,
    measured every ``est_every * est_every_mult``-th step."""
    num_bins: int
    est_every_mult: int = 1


class _Consts(t.NamedTuple):
    """What a run needs on the device, made once per run, for R rows
    (a fused sweep's; one for a single sampling): a constant the rows
    share as a single sampling has it, one that differs with the row
    axis first (see ``phd_qmclib_torch.samplers.dmc._Consts``)."""
    cfc: mrbp.CFCParams
    params: torch.Tensor  # pack_params(cfc): (16,), or the (R, 16) table
    obd_offsets: t.Optional[torch.Tensor]  # (num_pos,), (num_pos, R, 1, 1)
    move_spread: t.Union[float, torch.Tensor]  # (R, 1, 1) where it differs
    seeds: t.Tuple[int, ...]        # the rows' rng_seed: the uniform streams
    noise_keys: t.Tuple[int, ...]   # the Gaussian moves' keys (a shard's own)
    keys: t.Optional[torch.Tensor]  # rows, gaussian: key_table(noise_keys)
    spreads: t.Optional[torch.Tensor]  # rows, gaussian: (R,) scales
    #: The walker mesh whose chains this run steps; ``None`` unsharded.
    mesh: t.Any = None


def _row_consts(samplings, dtype, device, mesh=None) -> _Consts:
    """The constants of the rows ``samplings`` (a fused sweep's, or one
    sampling) for a run in ``dtype`` on ``device``, a shard of
    ``mesh``'s."""
    cfc, params, offsets = _rows_model(samplings, dtype, device)
    seeds = tuple(int(s.rng_seed) for s in samplings)
    noise_keys = seeds if mesh is None else tuple(
        utils.shard_key(seed, mesh.rank) for seed in seeds)
    spreads = [s.move_spread for s in samplings]
    noise_rows = samplings[0].gaussian and len(samplings) > 1
    return _Consts(
        cfc, params, offsets, _rows_value(spreads, dtype, device, 3), seeds,
        noise_keys, prng.key_table(noise_keys, device) if noise_rows else None,
        (torch.tensor(spreads, dtype=dtype, device=device) if noise_rows
         else None), mesh)


def state_from_numpy(state, device="cuda") -> State:
    """The port's :class:`State` from a JAX VMC ``State`` (or any object
    with the same fields, as numpy-convertible arrays) on ``device``."""
    return State(**{
        name: (None if getattr(state, name, None) is None else
               torch.tensor(np.asarray(getattr(state, name)), device=device))
        for name in State._fields})


def _mult(spec) -> int:
    return spec.est_every_mult if spec is not None else 1


@dataclass(frozen=True)
class Sampling:
    """VMC sampling spec bound to an mrbp model."""
    model_spec: mrbp.Spec
    move_spread: float
    rng_seed: t.Optional[int] = None
    ssf_est_spec: t.Optional[SSFEstSpec] = None
    obd_est_spec: t.Optional[OBDEstSpec] = None
    pair_corr_est_spec: t.Optional[PairCorrEstSpec] = None
    #: Number of independent Markov chains advanced in lockstep.
    num_walkers: int = 1
    #: Gaussian proposals of width ``move_spread`` (the reference's
    #: ``vmc_ndf`` sampling with ``sigma = sqrt(time_step)``).
    gaussian: bool = False
    #: Estimator cadence: measure every K-th step.
    est_every: int = 1
    #: The walker mesh whose ranks share the chains (a
    #: ``phd_qmclib_torch.parallel.WalkerMesh``); ``None``: one device.
    mesh: t.Any = None

    def __post_init__(self):
        if self.est_every < 1:
            raise ValueError("est_every must be a positive integer")
        for spec in (self.obd_est_spec, self.pair_corr_est_spec):
            if spec is not None and spec.est_every_mult < 1:
                raise ValueError(
                    "est_every_mult must be a positive integer")
        if self.rng_seed is None:
            object.__setattr__(self, "rng_seed",
                               int(utils.get_random_rng_seed()))
        if self.num_walkers % self.num_shards:
            raise ValueError(
                f"num_walkers must be divisible by the mesh 'walkers' axis "
                f"size ({self.num_shards})")

    def __getstate__(self):
        # The fields only: the cached functions (closures) are made again
        # where the sampling is unpickled (a rank of a mesh).
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @property
    def num_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _shard_of(self, state: State) -> State:
        """This rank's chains of a global state, on the mesh's device
        (unsharded, the state itself)."""
        if self.mesh is None:
            return state
        num = self.num_walkers // self.num_shards
        lo = self.mesh.rank * num
        return State(*(None if x is None else x[lo:lo + num].to(
            self.mesh.device) for x in state))

    # -- derived --------------------------------------------------------------

    @property
    def cfc_params(self) -> mrbp.CFCParams:
        return self.model_spec.cfc_params

    @cached_property
    def core_funcs(self):
        return mrbp.core_funcs(self.model_spec)

    @property
    def ssf_momenta(self) -> np.ndarray:
        """Momenta ``k_j = 2 pi j / L``."""
        if self.ssf_est_spec is None:
            raise TypeError("no S(k) estimator spec was configured "
                            "for this sampling")
        num_modes = self.ssf_est_spec.num_modes
        return np.arange(num_modes) * 2 * np.pi \
            / self.model_spec.supercell_size

    @property
    def obd_pos_offsets(self) -> np.ndarray:
        """OBDM displacement grid: ``num_pos`` points over ``[0, L/2]``."""
        if self.obd_est_spec is None:
            raise TypeError("the one-body density matrix spec has not "
                            "been specified")
        return np.linspace(0.0, 0.5 * self.model_spec.supercell_size,
                           self.obd_est_spec.num_pos)

    @property
    def pair_corr_bin_edges(self) -> np.ndarray:
        if self.pair_corr_est_spec is None:
            raise TypeError(
                "the pair-correlation spec has not been specified")
        return np.linspace(0, 0.5 * self.model_spec.supercell_size,
                           self.pair_corr_est_spec.num_bins + 1)

    @property
    def _chunked(self) -> bool:
        """Whether the estimators measure on the chunk-final
        configurations (see the module docstring)."""
        return (self.est_every > 1 or _mult(self.obd_est_spec) > 1
                or self.pair_corr_est_spec is not None)

    def _consts(self, dtype, device) -> _Consts:
        return _row_consts((self,), dtype, device, self.mesh)

    def _check_block_length(self, num_steps_block: int) -> None:
        if self._chunked and (
                num_steps_block % (self.est_every
                                   * _mult(self.obd_est_spec))
                or num_steps_block % (self.est_every
                                      * _mult(self.pair_corr_est_spec))):
            raise ValueError("num_steps_block must be divisible by "
                             "est_every (x est_every_mult for the OBDM / "
                             "pair-correlation estimators)")

    # -- state construction ---------------------------------------------------

    def _seed_parts(self, consts: _Consts, pos: torch.Tensor, ssf=None,
                    obd=None):
        """The S(k) parts and the OBDM grid of ``pos``, as the
        every-step mode carries them, by the step's own functions: a
        state stored without its parts (a result file, a checkpoint)
        gets back, bit for bit, the parts its chains carried.  Parts
        already given are kept."""
        funcs = self.core_funcs
        if self.ssf_est_spec is not None and ssf is None:
            ssf = funcs.fourier_density_parts_harmonics(
                self.ssf_est_spec.num_modes, pos, consts.cfc)
        if consts.obd_offsets is not None and obd is None:
            obd = funcs.one_body_density_grid(consts.obd_offsets, pos,
                                              consts.cfc)
        return ssf, obd

    def build_state(self, sys_conf: np.ndarray, dtype=None,
                    device="cuda") -> State:
        """The initial ensemble on ``device`` from one configuration of
        shape ``(2, N)`` or ``(N,)`` (every chain starts there) or a batch
        ``(W, 2, N)``/``(W, N)``: log|psi|, energy, and the S(k) and OBDM
        parts when those estimators are on.  ``dtype`` defaults to the
        configuration's floating type."""
        sys_conf = np.asarray(sys_conf)
        nop = self.model_spec.boson_number
        if sys_conf.ndim >= 2 and sys_conf.shape[-2] == 2 \
                and sys_conf.shape[-1] == nop:
            pos = sys_conf[..., mrbp.SysConfSlot.pos, :]
        elif sys_conf.shape[-1] == nop:
            pos = sys_conf
        else:
            raise ValueError("sys_conf shape does not match the model spec")
        if pos.ndim == 1:
            pos = np.broadcast_to(pos, (self.num_walkers, nop))
        if pos.shape[0] != self.num_walkers:
            raise ValueError(f"need {self.num_walkers} walker "
                             f"configurations, got {pos.shape[0]}")
        if dtype is None:
            dtype = pos.dtype if np.issubdtype(pos.dtype, np.floating) \
                else np.float64
        dtype = utils.torch_dtype(dtype)
        # Row-major whatever the start's shape: a broadcast copy would
        # keep the broadcast's strides, and the steps' sums their order.
        pos = torch.as_tensor(np.array(pos, order="C"), dtype=dtype,
                              device=device)
        consts = self._consts(dtype, device)
        wf_abs_log, energy = self.core_funcs.log_psi_and_energy(
            pos, consts.cfc, consts.params)
        ssf, obd = self._seed_parts(consts, pos)
        move_stat = torch.ones(pos.shape[0], dtype=torch.bool, device=device)
        return State(pos, wf_abs_log, energy, move_stat, ssf, obd)

    # -- the step -------------------------------------------------------------

    def _step(self, state: State, disp: torch.Tensor, u: torch.Tensor,
              consts: _Consts, with_est: bool) -> State:
        """One Metropolis step of R rows (every field of ``state`` with
        the rows' leading axis) on the displacements ``disp (R, W, N)``
        and the acceptance uniforms ``u (R, W)``; ``with_est`` carries
        the proposal's S(k) parts and OBDM grid through rejections."""
        funcs, cfc = self.core_funcs, consts.cfc
        prop = mrbp.recast(state.pos + disp, cfc)
        lp_prop, e_prop = funcs.log_psi_and_energy(prop, cfc, consts.params)
        # Metropolis condition of the reference (qmc_base/vmc.py:636).
        accept = lp_prop > 0.5 * torch.log(u) + state.wf_abs_log
        new = State(torch.where(accept[..., None], prop, state.pos),
                    torch.where(accept, lp_prop, state.wf_abs_log),
                    torch.where(accept, e_prop, state.energy), accept)
        if with_est and self.ssf_est_spec is not None:
            parts = funcs.fourier_density_parts_harmonics(
                self.ssf_est_spec.num_modes, prop, cfc)
            new = new._replace(ssf_parts=torch.where(
                accept[..., None, None], parts, state.ssf_parts))
        if with_est and self.obd_est_spec is not None:
            grid = funcs.one_body_density_grid(consts.obd_offsets, prop, cfc)
            new = new._replace(obd_parts=torch.where(
                accept[..., None], grid, state.obd_parts))
        return new

    def _measure(self, consts: _Consts, pos: torch.Tensor,
                 chunk: int) -> t.Dict[str, torch.Tensor]:
        """The chunked mode's estimator sums of R rows (``pos (R, W,
        N)``) at the end of chunk ``chunk``, each row summed over its
        chains as a single sampling sums them; the OBDM and g2 only
        every ``est_every_mult``-th chunk."""
        funcs, cfc = self.core_funcs, consts.cfc
        rows = {}
        if self.ssf_est_spec is not None:
            rows["ssf"] = _row_sums(funcs.fourier_density_parts_harmonics(
                self.ssf_est_spec.num_modes, pos, cfc))
        spec = self.obd_est_spec
        if spec is not None and (chunk + 1) % spec.est_every_mult == 0:
            rows["obd"] = _row_sums(funcs.one_body_density_grid(
                consts.obd_offsets, pos, cfc))
        spec = self.pair_corr_est_spec
        if spec is not None and (chunk + 1) % spec.est_every_mult == 0:
            rows["g2"] = _row_sums(funcs.pair_dist_histogram(
                spec.num_bins, pos, cfc))
        return rows

    def _run(self, state: State, draws, consts: _Consts, thin: int = 0):
        """Step R rows through ``draws``, an iterable of ``(disp, u)``.

        Returns ``(state, props, rows, confs)``: the per-step
        ``(wf_abs_log, energy, move_stat)``, the estimator rows by name
        and, with ``thin``, every ``thin``-th step's positions, all as
        lists of device tensors with the rows' leading axis.
        """
        chunked, cadence = self._chunked, self.est_every
        if chunked:
            # The chunked mode carries no parts.
            state = state._replace(ssf_parts=None, obd_parts=None)
        props, rows, confs = [], {}, []
        for step, (disp, u) in enumerate(draws):
            state = self._step(state, disp, u, consts, not chunked)
            props.append((state.wf_abs_log, state.energy, state.move_stat))
            if thin and (step + 1) % thin == 0:
                confs.append(state.pos)
            if not chunked:
                step_rows = {"ssf": state.ssf_parts, "obd": state.obd_parts}
                step_rows = {name: _row_sums(parts)
                             for name, parts in step_rows.items()
                             if parts is not None}
            elif (step + 1) % cadence == 0:
                step_rows = self._measure(consts, state.pos, step // cadence)
            else:
                continue
            for name, row in step_rows.items():
                rows.setdefault(name, []).append(row)
        return state, props, rows, confs

    def _draws(self, consts: _Consts, block_index: int,
               num_steps_block: int, shape, dtype, device,
               noise: t.Optional[torch.Tensor],
               bufs: t.Optional[t.Tuple[torch.Tensor, torch.Tensor]]):
        """The displacements and acceptance uniforms of one block of R
        rows of ``shape (R, W, N)``, drawn on the device as the steps
        consume them: each row's from its own ``torch.Generator``, seeded
        from ``(rng_seed, block index)`` as its single sampling's.
        Gaussian displacements, already scaled by each row's
        ``move_spread``, are written into the run's buffer ``noise`` (one
        launch for all rows); the rows' uniforms into ``bufs`` (a single
        sampling draws fresh tensors): each step consumes them before
        the next draw, in stream order."""
        shard = None if consts.mesh is None else consts.mesh.rank
        gens = []
        for seed in consts.seeds:
            gen = torch.Generator(device=device)
            gen.manual_seed(utils.block_seed(seed, block_index, shard))
            gens.append(gen)
        for step in range(num_steps_block):
            global_step = block_index * num_steps_block + step
            if bufs is None:
                gen = gens[0]
                if self.gaussian:
                    disp = prng.normal(
                        consts.noise_keys[0], global_step, shape[1:], dtype,
                        device, scale=self.move_spread, out=noise[0])
                else:
                    disp = self.move_spread * (torch.rand(
                        shape[1:], generator=gen, dtype=dtype,
                        device=device) - 0.5)
                u = torch.rand(shape[1:2], generator=gen, dtype=dtype,
                               device=device)
                yield disp[None], u[None]
                continue
            moves, accept = bufs
            if self.gaussian:
                disp = prng.normal_rows(consts.keys, global_step,
                                        consts.spreads, noise)
            for r, gen in enumerate(gens):
                if not self.gaussian:
                    torch.rand(moves[r].shape, generator=gen, out=moves[r])
                torch.rand(accept[r].shape, generator=gen, out=accept[r])
            if not self.gaussian:
                disp = consts.move_spread * (moves - 0.5)
            yield disp, accept

    # -- public sampling APIs -------------------------------------------------

    def _row_blocks(self, consts: _Consts, ini_state: State,
                    num_steps_block: int, block_offset: int, thin: int):
        """The block loop of R rows: ``ini_state`` has the rows' leading
        axis, this sampling gives the static structure and ``consts``
        (:func:`_row_consts`) the rows' own constants.  Yields ``(confs,
        props, rows, accept_rates, state)`` per block: every ``thin``-th
        step's positions ``(R, nts // thin, W, N)`` (with ``thin``), the
        per-step properties ``(R, nts, W)`` and estimator rows ``(R, n,
        ...)`` on the device, the rows' acceptance rates (floats, the
        block's one host sync) and the last state.  On a mesh the
        estimator rows are the shards' sums, the acceptance rates the
        mean of theirs, the properties gathered over the chains."""
        if num_steps_block < 1:
            raise ValueError("num_steps_block must be nonzero and positive")
        self._check_block_length(thin or num_steps_block)
        state = ini_state
        dtype, device = state.pos.dtype, state.pos.device
        if not self._chunked:
            # A state built or loaded without the parts the every-step
            # mode carries: compute them.
            ssf, obd = self._seed_parts(consts, state.pos, state.ssf_parts,
                                        state.obd_parts)
            state = state._replace(ssf_parts=ssf, obd_parts=obd)
        block_index = int(block_offset)
        shape = state.pos.shape
        noise = (torch.empty(shape, dtype=dtype, device=device)
                 if self.gaussian else None)
        bufs = None
        if shape[0] > 1:
            bufs = (None if self.gaussian else
                    torch.empty(shape, dtype=dtype, device=device),
                    torch.empty(shape[:2], dtype=dtype, device=device))
        while True:
            draws = self._draws(consts, block_index, num_steps_block, shape,
                                dtype, device, noise, bufs)
            state, props, rows, confs = self._run(state, draws, consts, thin)
            props = PropsData(*(torch.stack(column, dim=1)
                                for column in zip(*props)))
            rows = {name: torch.stack(values, dim=1)
                    for name, values in rows.items()}
            rates = props.move_stat.double().mean(dim=(1, 2))
            if consts.mesh is not None:
                mesh = consts.mesh
                rows = {name: mesh.psum(value) for name, value in rows.items()}
                rates = mesh.pmean(rates)
                props = PropsData(*(torch.cat(mesh.all_gather(column), dim=-1)
                                    for column in props))
            # The block's one host sync.
            rates = rates.tolist()
            yield ((torch.stack(confs, dim=1) if thin else None), props,
                   rows, rates, state)
            block_index += 1

    def _blocks(self, num_steps_block: int, ini_state: State,
                block_offset: int, thin: int):
        """Yield ``(confs, block)`` per block; see :meth:`blocks`."""
        state = _as_rows(self._shard_of(ini_state))
        consts = self._consts(state.pos.dtype, state.pos.device)
        for confs, props, rows, rates, last in self._row_blocks(
                consts, state, num_steps_block, block_offset, thin):
            rows = {name: value[0] for name, value in rows.items()}
            block = SamplingBlock(
                PropsData(*(column[0] for column in props)),
                rows.get("ssf"), rates[0], _row(last, 0), rows.get("obd"),
                rows.get("g2"))
            yield (None if confs is None else confs[0]), block

    def blocks(self, num_steps_block: int, ini_state: State,
               block_offset: int = 0) -> t.Iterator[SamplingBlock]:
        """Yield :class:`SamplingBlock` objects indefinitely.

        The random streams of block ``b`` derive from ``(rng_seed,
        block_offset + b)``: a continuation passes the consumed block
        count as ``block_offset``.  On a mesh every rank passes the
        global state and steps its chains of it (see the module).
        """
        for _, block in self._blocks(num_steps_block, ini_state,
                                     block_offset, 0):
            yield block

    def replay_chain(self, ini_state: State, moves_u, accept_u):
        """Drive the chains with injected noise instead of the sampler's
        draws.

        ``moves_u``: the uniforms of the moves or, with ``gaussian``, the
        pre-scaled Gaussian displacements, ``(nts, N)`` for every chain
        alike or ``(nts, W, N)``; ``accept_u``: the Metropolis uniforms,
        ``(nts,)`` or ``(nts, W)``.  The arithmetic is the production
        step's own.  Returns ``(pos (nts, W, N), wf_abs_log (nts, W),
        accepted (nts, W))``, the post-step chain states.  On a mesh the
        state and the draws ``(nts, W, ...)`` are the global ones and
        each rank returns its chains'.
        """
        ini_state = self._shard_of(ini_state)
        if self.mesh is not None:
            num = self.num_walkers // self.num_shards
            lo = self.mesh.rank * num
            moves_u, accept_u = (torch.as_tensor(moves_u),
                                 torch.as_tensor(accept_u))
            if moves_u.dim() == 3:
                moves_u = moves_u[:, lo:lo + num]
            if accept_u.dim() == 2:
                accept_u = accept_u[:, lo:lo + num]
        dtype, device = ini_state.pos.dtype, ini_state.pos.device
        moves = torch.as_tensor(moves_u, dtype=dtype, device=device)
        accept = torch.as_tensor(accept_u, dtype=dtype, device=device)
        if moves.dim() == 2:
            moves = moves[:, None, :]
        if accept.dim() == 1:
            accept = accept[:, None]
        shape = ini_state.pos.shape
        out = self._replay(self._consts(dtype, device), _as_rows(ini_state),
                           moves.expand((len(moves),) + shape)[:, None],
                           accept.expand((len(accept),) + shape[:1])[:, None])
        return tuple(column[:, 0] for column in out)

    def _replay(self, consts: _Consts, state: State, moves: torch.Tensor,
                accept: torch.Tensor):
        """:meth:`replay_chain` of R rows (:func:`_row_consts`): ``moves
        (nts, R, W, N)``, ``accept (nts, R, W)``; each output with the
        rows' axis after the steps'."""
        out = []
        for mu, au in zip(moves, accept):
            disp = mu if self.gaussian \
                else consts.move_spread * (mu - 0.5)
            state = self._step(state, disp, au, consts, with_est=False)
            out.append((state.pos, state.wf_abs_log, state.move_stat))
        return tuple(torch.stack(column) for column in zip(*out))

    def as_chain(self, num_steps: int, ini_state: State) -> SamplingBlock:
        """The sampling as a single block of ``num_steps`` steps."""
        if num_steps < 1:
            raise ValueError("num_steps must be at least 1")
        return next(self.blocks(num_steps, ini_state))

    def states(self, ini_state: State) -> t.Iterator[State]:
        """Step-by-step state generator (one block per step)."""
        for block in self.blocks(1, ini_state):
            yield block.last_state

    def state_data_blocks(self, num_steps_block: int, ini_state: State,
                          thin: int = 1, block_offset: int = 0):
        """Yield ``(confs, block)`` per block, ``confs (num_steps_block //
        thin, W, N)`` every ``thin``-th step's chain positions (on the
        device): the configurations the wavefunction optimization reads.
        Each ``thin`` steps must end on a measured step of every
        estimator."""
        if num_steps_block % thin:
            raise ValueError("num_steps_block must be divisible by thin")
        yield from self._blocks(num_steps_block, ini_state, block_offset,
                                thin)
