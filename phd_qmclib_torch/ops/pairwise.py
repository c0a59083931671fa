"""Fused Bijl-Jastrow local energy, drift and log|psi|: the hot ops of
DMC and VMC, and the fused DMC diffusion step.

Counterpart of ``phd_qmclib_tpu.ops.pairwise``:

* :func:`energy_and_drift` replaces ``energy_and_drift_pallas``, both
  variants: the forward one (the DMC step) and, with
  ``with_log_psi=True``, the one that adds log|psi| (the VMC step).  For
  every walker, O(N^2) minimum-image pair terms reduce to a
  per-particle drift and a per-walker local energy (and log|psi|), plus
  the one-body Kronig-Penney terms.
* :func:`energy_and_drift_params_vjp`, the vector-Jacobian product of
  the log|psi| variant with respect to the packed parameters, and
  :class:`LogPsiAndEnergy`, the autograd function that pairs it with the
  forward: the counterpart of XLA's autodiff of the JAX package's
  ``log_psi_and_energy``, which the gradient optimizer of the trial
  function differentiates.  It has no Pallas counterpart.
* :func:`diffuse_energy_drift` replaces ``diffuse_energy_drift_pallas``:
  noise, move, recast, the forward terms and the branching weight in one
  pass.  As in the JAX package, no sampler calls it.
* :func:`obd_grid`, the one-body density matrix at a grid of offsets,
  every offset of a walker in one CTA: the CUDA side of the OBDM
  estimator, which the JAX package leaves to XLA.  Its plain version is
  ``models/jastrow.py``'s ``one_body_density_grid``, which
  ``models/mrbp.py`` runs on a CPU tensor.

The first three launch their hand-written CUDA kernels
(``csrc/pairwise.cu``, ``csrc/diffuse.cu``) on a CUDA tensor and run
their plain torch versions on a CPU tensor.  Both sum the energy and
log|psi| per particle first, ``E_L = sum_i (kin_i - drift_i^2 +
pot_i)``, in the order of the Pallas kernel.
"""
import math

import torch

from . import _build, prng, trig
from .pbc import min_image_bounded, recast_to_supercell, sign

__all__ = ["PARAMS_SIZE", "LogPsiAndEnergy", "diffuse_energy_drift",
           "diffuse_energy_drift_plain", "energy_and_drift",
           "energy_and_drift_params_vjp", "energy_and_drift_params_vjp_plain",
           "energy_and_drift_plain", "obd_grid", "pack_params"]

#: Packed-parameter layout.  Slots 0-12 are those of the JAX package's
#: ``pack_params``; slot 13 holds the Hamiltonian's lattice depth, which
#: the potential uses off the defects (slot 0 is the trial orbital's);
#: slot 14 the one-body orbital's well amplitude
#: ``cf = sqrt(1 + v0/e0 sinh^2(sqrt(v0 - e0) z_b / 2))`` (0 for a free
#: gas), which the log|psi| variant needs.
PARAMS_SIZE = 16
(P_V0, P_E0, P_K1, P_KP1, P_ZA, P_ZB, P_L, P_RM, P_K2, P_BETA, P_ROFF,
 P_AM, P_V0D, P_V0M, P_CF) = range(15)

#: Largest particle count of the kernel: one thread per particle.
MAX_NOP = 1024


def pack_params(cfc, dtype: torch.dtype = torch.float32,
                device="cuda") -> torch.Tensor:
    """Pack the mrbp ``CFCParams`` into the ``(PARAMS_SIZE,)`` vector
    the kernel reads, on ``device`` (the card unless ``"cpu"`` is
    asked for).

    Leaves may be floats or tensors; with 0-d tensors already on
    ``device`` the packing is one device-side stack and copies nothing
    from the host.  Leaves with a batch shape (the optimizer's grid of
    parameters) broadcast together and give one vector per element,
    ``(*batch, PARAMS_SIZE)``.  The packing is differentiable in the
    leaves.
    """
    mp_, obf, tbf = cfc.model_params, cfc.obf_params, cfc.tbf_params
    entries = [obf.lattice_depth, obf.param_e0, obf.param_k1,
               obf.param_kp1, obf.well_width, obf.barrier_width,
               mp_.supercell_size, tbf.tbf_contact_cutoff,
               tbf.param_k2, tbf.param_beta, tbf.param_r_off,
               tbf.param_am, mp_.defect_magnitude, mp_.lattice_depth]
    vals = list(torch.broadcast_tensors(
        *(torch.as_tensor(e, dtype=dtype, device=device) for e in entries)))
    vals[P_RM] = vals[P_RM].abs()
    v0, e0, z_b = vals[P_V0], vals[P_E0], vals[P_ZB]
    # The expression of models/mrbp.py::_one_body; 0 for a free gas
    # (e0 = 0), whose unselected branch is kept finite, gradient included.
    free = e0 == 0
    e0_s, v0_s = torch.where(free, 1.0, e0), torch.where(free, 2.0, v0)
    cf = torch.sqrt(1 + v0_s / e0_s * torch.sinh(
        0.5 * torch.sqrt(v0_s - e0_s) * z_b) ** 2)
    vals.append(torch.where(free, 0.0, cf))
    vals += [torch.zeros_like(vals[0])] * (PARAMS_SIZE - len(vals))
    return torch.stack(vals, dim=-1)


def energy_and_drift_plain(pos: torch.Tensor, params: torch.Tensor, *,
                           nop: int, is_free: bool, is_ideal: bool,
                           defects_sep: int = 1, with_log_psi: bool = False):
    """Plain torch version of the kernel: ``(energy (W,), drift (W, N))``,
    or ``(log_psi (W,), energy, drift)`` with ``with_log_psi``.

    ``params`` is :func:`pack_params`' vector or a ``(R, PARAMS_SIZE)``
    table of them, one row per ``W / R`` consecutive walkers; a table
    runs row by row, so that each row's values are those of a call on
    its walkers alone, bit for bit (the CPU's vectorized loops round
    their tails with the scalar functions, so a batched call may differ
    in the last bit).  The pair block is a ``(W, N, N)`` tensor.  f32
    evaluates the rational tan polynomial, or with ``with_log_psi`` the
    sin/cos polynomials, f64 the library sin/cos, as the JAX package's
    XLA path does; the log path takes one log per pair, ``p log(x)``.
    The pair kinetic term is ``C (1 + v^2)`` either way.
    """
    if params.dim() == 2:
        outs = [energy_and_drift_plain(
            rows, row, nop=nop, is_free=is_free, is_ideal=is_ideal,
            defects_sep=defects_sep, with_log_psi=with_log_psi)
            for rows, row in zip(pos.chunk(params.shape[0]), params)]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    p = params
    drift = torch.zeros_like(pos)
    kin_rows = torch.zeros_like(pos)
    pot = torch.zeros_like(pos)
    log_rows = torch.zeros_like(pos)

    if not is_free:
        v0, e0, k1, kp1 = p[P_V0], p[P_E0], p[P_K1], p[P_KP1]
        z_a, z_b = p[P_ZA], p[P_ZB]
        n_cell = torch.floor(pos)
        z_cell = pos - n_cell
        in_barrier = z_a < z_cell
        arg_b = kp1 * (z_cell - 1.0 + 0.5 * z_b)
        arg_w = k1 * (z_cell - 0.5 * z_a)
        ob_ldz = torch.where(in_barrier, kp1 * torch.tanh(arg_b),
                             -k1 * torch.tan(arg_w))
        ob_d2 = torch.where(in_barrier, v0 - e0, -e0)
        if defects_sep == 1:
            barrier_v = p[P_V0D].expand_as(pos)
        else:
            on_defect = torch.remainder(n_cell, defects_sep) == 0
            barrier_v = torch.where(on_defect, p[P_V0D], p[P_V0M])
        pot = torch.where(in_barrier, barrier_v, 0.0)
        drift = ob_ldz
        kin_rows = -ob_d2 + ob_ldz * ob_ldz
        if with_log_psi:
            f1 = torch.where(in_barrier, torch.cosh(arg_b),
                             p[P_CF] * torch.cos(arg_w))
            log_rows = f1.abs().log()

    if not is_ideal:
        L, rm, k2 = p[P_L], p[P_RM], p[P_K2]
        beta, r_off = p[P_BETA], p[P_ROFF]
        d = min_image_bounded(pos[:, :, None] - pos[:, None, :], L)
        off = ~torch.eye(nop, dtype=torch.bool, device=pos.device)
        r = torch.where(off, d.abs(), 0.25 * L)
        in_cut = r < rm
        pref = math.pi / L
        arg = (torch.where(in_cut, k2, pref) * r
               + torch.where(in_cut, -k2 * r_off, 0.0))
        if pos.dtype != torch.float32:
            s, c = torch.sin(arg), torch.cos(arg)
        elif with_log_psi:
            s, c = trig.sincos_poly32(arg)
        else:
            s, c = trig.tancot_poly32(arg)
        v = torch.where(in_cut, s, c) / torch.where(in_cut, c, s)
        ldz = torch.where(in_cut, -k2, pref * beta) * v
        kin = torch.where(in_cut, k2 * k2, pref * pref * beta) \
            * (1.0 + v * v)
        drift = drift + torch.where(off, ldz * sign(d), 0.0).sum(dim=-1)
        kin_rows = kin_rows + torch.where(off, kin, 0.0).sum(dim=-1)
        if with_log_psi:
            log_f2 = torch.where(in_cut, 1.0, beta) * torch.log(
                torch.where(in_cut, p[P_AM].abs() * c, s))
            log_rows = log_rows + 0.5 * torch.where(off, log_f2,
                                                    0.0).sum(dim=-1)

    energy = (kin_rows - drift * drift + pot).sum(dim=-1)
    if with_log_psi:
        return log_rows.sum(dim=-1), energy, drift
    return energy, drift


def _check_params(pos: torch.Tensor, params: torch.Tensor, nop: int,
                  defects_sep: int, table: bool = False) -> None:
    """The checks common to the kernels' wrappers; ``table`` admits a
    ``(R, PARAMS_SIZE)`` table whose R divides the walkers."""
    if pos.device.type != "cuda":
        raise ValueError(f"no kernel for device {pos.device}")
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    if pos.dim() != 2 or pos.shape[1] != nop or not 0 < nop <= MAX_NOP:
        raise ValueError(f"pos must be (W, nop) with 0 < nop <= "
                         f"{MAX_NOP}, got {tuple(pos.shape)}, nop={nop}")
    is_table = (table and params.dim() == 2 and params.shape[0] > 0
                and params.shape[1] == PARAMS_SIZE
                and pos.shape[0] % params.shape[0] == 0)
    if (params.shape != (PARAMS_SIZE,) and not is_table) \
            or params.dtype != pos.dtype or params.device != pos.device:
        raise ValueError("params must be pack_params' vector in pos' "
                         "dtype on pos' device"
                         + (", or a table of R such rows, R dividing the "
                            "walkers" if table else ""))
    if not (pos.is_contiguous() and params.is_contiguous()):
        raise ValueError("pos and params must be contiguous")
    if defects_sep < 1:
        raise ValueError(f"defects_sep must be positive, got {defects_sep}")


def energy_and_drift(pos: torch.Tensor, params: torch.Tensor, *,
                     nop: int, is_free: bool, is_ideal: bool,
                     defects_sep: int = 1, with_log_psi: bool = False):
    """Fused ``(energy (W,), drift (W, N))`` for walkers ``pos (W, N)``,
    or ``(log_psi (W,), energy, drift)`` with ``with_log_psi``, in the
    order of ``energy_and_drift_pallas``.

    ``params`` is :func:`pack_params`' vector, or for the rows of a fused
    parameter sweep a ``(R, PARAMS_SIZE)`` table: the ``W / R``
    consecutive walkers of row ``r`` take row ``r`` of the table, with
    the arithmetic of a launch on that row alone.

    A CUDA tensor launches the kernel of ``csrc/pairwise.cu`` (f32 or
    f64, any ``N <= 1024``, free and ideal gases included; each
    unordered pair once, the positions wrapped into ``[0, L)`` for the
    pair terms); a CPU tensor runs :func:`energy_and_drift_plain`.  ``params`` is
    :func:`pack_params`' vector in ``pos``'s dtype, on ``pos``'s device.
    Each launch adds one to ``energy_and_drift.launch_count`` (forward)
    or ``energy_and_drift.log_psi_launch_count`` (log|psi|); with a
    table, to ``table_launch_count`` or ``log_psi_table_launch_count``.
    """
    if pos.device.type == "cpu":
        return energy_and_drift_plain(pos, params, nop=nop,
                                      is_free=is_free, is_ideal=is_ideal,
                                      defects_sep=defects_sep,
                                      with_log_psi=with_log_psi)
    _check_params(pos, params, nop, defects_sep, table=True)
    num_walkers = pos.shape[0]
    energy = pos.new_empty(num_walkers)
    drift = torch.empty_like(pos)
    log_psi = torch.empty_like(energy) if with_log_psi else None
    if num_walkers == 0:
        return (energy, drift) if log_psi is None else (log_psi, energy,
                                                        drift)
    suffix = "f32" if pos.dtype == torch.float32 else "f64"
    per_row = num_walkers // params.shape[0] if params.dim() == 2 \
        else num_walkers
    args = (num_walkers, per_row, nop, int(is_free), int(is_ideal),
            defects_sep)
    if with_log_psi:
        fn = _build.functions()[f"qmc_pair_logpsi_energy_drift_{suffix}"]
        _build.call(fn, pos.device, pos.data_ptr(), params.data_ptr(),
                    log_psi.data_ptr(), energy.data_ptr(), drift.data_ptr(),
                    *args)
        if params.dim() == 2:
            energy_and_drift.log_psi_table_launch_count += 1
        else:
            energy_and_drift.log_psi_launch_count += 1
        return log_psi, energy, drift
    _build.call(_build.functions()[f"qmc_pair_energy_drift_{suffix}"],
                pos.device, pos.data_ptr(), params.data_ptr(),
                energy.data_ptr(), drift.data_ptr(), *args)
    if params.dim() == 2:
        energy_and_drift.table_launch_count += 1
    else:
        energy_and_drift.launch_count += 1
    return energy, drift


#: Kernel launches since the last reset (set them to 0 to reset): the
#: forward variant, the log|psi| variant, each with one parameter vector
#: and with a sweep's table of rows, and the parameter VJP of the
#: log|psi| variant (:func:`energy_and_drift_params_vjp`).
energy_and_drift.launch_count = 0
energy_and_drift.log_psi_launch_count = 0
energy_and_drift.table_launch_count = 0
energy_and_drift.log_psi_table_launch_count = 0
energy_and_drift.params_vjp_launch_count = 0


# -- the parameter VJP of the log|psi| variant ---------------------------------

def energy_and_drift_params_vjp_plain(pos, params, drift, g_lp, g_e, *,
                                      nop: int, is_free: bool, is_ideal: bool,
                                      defects_sep: int = 1) -> torch.Tensor:
    """Plain torch version of the parameter VJP: autograd of
    :func:`energy_and_drift_plain` (``with_log_psi=True``),
    ``sum_w (g_lp[w] dlog_psi_w/dp + g_e[w] dE_w/dp)`` as a
    ``(PARAMS_SIZE,)`` vector.  ``drift`` is the forward's; this
    version recomputes it."""
    del drift
    with torch.enable_grad():
        p = params.detach().requires_grad_()
        log_psi, energy, _ = energy_and_drift_plain(
            pos.detach(), p, nop=nop, is_free=is_free, is_ideal=is_ideal,
            defects_sep=defects_sep, with_log_psi=True)
        out = (log_psi * g_lp).sum() + (energy * g_e).sum()
        if not out.requires_grad:  # a free ideal gas reads no parameter
            return torch.zeros_like(params)
        grad, = torch.autograd.grad(out, p, allow_unused=True)
    return torch.zeros_like(params) if grad is None else grad


def energy_and_drift_params_vjp(pos, params, drift, g_lp, g_e, *, nop: int,
                                is_free: bool, is_ideal: bool,
                                defects_sep: int = 1) -> torch.Tensor:
    """``sum_w (g_lp[w] dlog_psi_w/dp + g_e[w] dE_w/dp)``: the
    vector-Jacobian product of :func:`energy_and_drift`'s log|psi|
    variant with respect to the packed parameters ``params``, a
    ``(PARAMS_SIZE,)`` vector in ``pos``' dtype.

    ``drift (W, N)`` is the forward's drift at ``pos``, ``g_lp`` and
    ``g_e`` the upstream gradients ``(W,)`` of log|psi| and of the
    energy.  A CUDA tensor launches the kernel of ``csrc/pairwise.cu``
    (one row of the product per walker, summed here by one torch
    reduction; each launch adds one to
    ``energy_and_drift.params_vjp_launch_count``); a CPU tensor runs
    :func:`energy_and_drift_params_vjp_plain`.  The kernel differentiates
    the forward as the kernels compute it, positions in ``[0, L)``:
    there it equals the plain version.
    """
    kw = dict(nop=nop, is_free=is_free, is_ideal=is_ideal,
              defects_sep=defects_sep)
    if pos.device.type == "cpu":
        return energy_and_drift_params_vjp_plain(pos, params, drift, g_lp,
                                                 g_e, **kw)
    _check_params(pos, params, nop, defects_sep)
    num_walkers = pos.shape[0]
    for name, t, shape in (("drift", drift, pos.shape),
                           ("g_lp", g_lp, (num_walkers,)),
                           ("g_e", g_e, (num_walkers,))):
        if t.shape != shape or t.dtype != pos.dtype \
                or t.device != pos.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor in pos' dtype on pos' device")
    rows = pos.new_empty((num_walkers, PARAMS_SIZE))
    if num_walkers == 0:
        return rows.sum(dim=0)
    suffix = "f32" if pos.dtype == torch.float32 else "f64"
    _build.call(_build.functions()[f"qmc_pair_logpsi_params_vjp_{suffix}"],
                pos.device, pos.data_ptr(), params.data_ptr(),
                drift.data_ptr(), g_lp.data_ptr(), g_e.data_ptr(),
                rows.data_ptr(), num_walkers, nop, int(is_free),
                int(is_ideal), defects_sep)
    energy_and_drift.params_vjp_launch_count += 1
    return rows.sum(dim=0)


class LogPsiAndEnergy(torch.autograd.Function):
    """``(log_psi (W,), energy (W,))`` of :func:`energy_and_drift`'s
    log|psi| variant, differentiable with respect to ``params``: the
    forward launches the kernel (or, on the CPU, runs the plain version)
    and keeps its drift; the backward is
    :func:`energy_and_drift_params_vjp`.  ``kernel_kw`` holds ``nop``,
    ``is_free``, ``is_ideal`` and ``defects_sep``.  ``pos`` gets no
    gradient: it must not require one."""

    @staticmethod
    def forward(ctx, pos, params, kernel_kw):
        if pos.requires_grad:
            raise ValueError("LogPsiAndEnergy differentiates with respect "
                             "to params only")
        log_psi, energy, drift = energy_and_drift(pos, params,
                                                  with_log_psi=True,
                                                  **kernel_kw)
        ctx.kernel_kw = kernel_kw
        ctx.save_for_backward(pos, params, drift)
        return log_psi, energy

    @staticmethod
    def backward(ctx, g_lp, g_e):
        pos, params, drift = ctx.saved_tensors
        grad = energy_and_drift_params_vjp(
            pos, params, drift, g_lp.contiguous(), g_e.contiguous(),
            **ctx.kernel_kw)
        return None, grad, None


# -- the fused diffusion step ------------------------------------------------

def diffuse_energy_drift_plain(cpos, cdrift, cenergy, params, dt: float,
                               sigma: float, e_ref, rng_seed: int, step: int,
                               *, xi=None, nop: int, is_free: bool,
                               is_ideal: bool, defects_sep: int = 1):
    """Plain torch version of the fused diffusion kernel:
    :func:`~phd_qmclib_torch.ops.prng.normal_plain` (unless ``xi`` is
    given), the move, the recast, :func:`energy_and_drift_plain` and the
    weight, in the order of the DMC step
    (``phd_qmclib_torch.samplers.dmc.Sampling.diffuse``)."""
    if xi is None:
        xi = prng.normal_plain(rng_seed, step, cpos.shape, cpos.dtype,
                               cpos.device)
    npos = recast_to_supercell(cpos + 2.0 * cdrift * dt + sigma * xi, 0.0,
                               params[P_L])
    nenergy, ndrift = energy_and_drift_plain(
        npos, params, nop=nop, is_free=is_free, is_ideal=is_ideal,
        defects_sep=defects_sep)
    nweight = torch.exp(-dt * (0.5 * (nenergy + cenergy) - e_ref))
    return npos, nenergy, ndrift, nweight


def diffuse_energy_drift(cpos, cdrift, cenergy, params, dt: float,
                         sigma: float, e_ref, rng_seed: int, step: int, *,
                         xi=None, nop: int, is_free: bool, is_ideal: bool,
                         defects_sep: int = 1):
    """One fused DMC diffusion step of the cloned parents
    ``cpos, cdrift (W, N)``, ``cenergy (W,)``:
    ``z' = recast(z + 2 F dt + sigma xi)``, the forward terms at ``z'``
    and the weight ``exp(-dt ((E' + E) / 2 - e_ref))``.

    ``xi`` is the Philox normal stream of
    :func:`~phd_qmclib_torch.ops.prng.normal` for ``(rng_seed, step)``,
    or the injected ``xi (W, N)`` (unit normals, scaled here by
    ``sigma``).  ``e_ref`` is a 0-d tensor of ``cpos``' dtype on its
    device.  Returns ``(npos (W, N), nenergy (W,), ndrift (W, N),
    nweight (W,))``, as ``diffuse_energy_drift_pallas`` does.

    A CUDA tensor launches the kernel of ``csrc/diffuse.cu``; a CPU
    tensor runs :func:`diffuse_energy_drift_plain`.
    """
    kw = dict(nop=nop, is_free=is_free, is_ideal=is_ideal,
              defects_sep=defects_sep)
    if cpos.device.type == "cpu":
        return diffuse_energy_drift_plain(cpos, cdrift, cenergy, params, dt,
                                          sigma, e_ref, rng_seed, step,
                                          xi=xi, **kw)
    _check_params(cpos, params, nop, defects_sep)
    num_walkers = cpos.shape[0]
    inputs = [("cdrift", cdrift, cpos.shape),
              ("cenergy", cenergy, (num_walkers,)), ("e_ref", e_ref, ())]
    if xi is not None:
        inputs.append(("xi", xi, cpos.shape))
    for name, t, shape in inputs:
        if t.shape != shape or t.dtype != cpos.dtype \
                or t.device != cpos.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor in cpos' dtype on cpos' device")
    npos = torch.empty_like(cpos)
    ndrift = torch.empty_like(cpos)
    nenergy = cpos.new_empty(num_walkers)
    nweight = torch.empty_like(nenergy)
    if num_walkers == 0:
        return npos, nenergy, ndrift, nweight
    suffix = "f32" if cpos.dtype == torch.float32 else "f64"
    _build.call(
        _build.functions()[f"qmc_diffuse_energy_drift_{suffix}"],
        cpos.device, cpos.data_ptr(), cdrift.data_ptr(), cenergy.data_ptr(),
        params.data_ptr(), None if xi is None else xi.data_ptr(),
        e_ref.data_ptr(), float(dt), float(sigma),
        *prng.check_key(rng_seed, step), npos.data_ptr(),
        nenergy.data_ptr(), ndrift.data_ptr(), nweight.data_ptr(),
        num_walkers, nop, int(is_free), int(is_ideal), defects_sep)
    diffuse_energy_drift.launch_count += 1
    return npos, nenergy, ndrift, nweight


#: Kernel launches since the last reset (set it to 0 to reset).
diffuse_energy_drift.launch_count = 0


# -- the one-body density matrix on a grid of offsets --------------------------

def obd_grid(offsets: torch.Tensor, pos: torch.Tensor, params: torch.Tensor,
             *, nop: int, is_free: bool, is_ideal: bool) -> torch.Tensor:
    """The OBDM ``(W, M)`` of walkers ``pos (W, N)`` at the offsets
    ``(M,)``: for each walker and offset ``s``, the mean over particles
    of the trial function's ratio with that particle moved by ``s``.

    ``params`` is :func:`pack_params`' vector with ``offsets (M,)``, or
    for the rows of a fused parameter sweep a ``(R, PARAMS_SIZE)`` table
    with ``offsets (R, M)``: the ``W / R`` consecutive walkers of row
    ``r`` take row ``r`` of both, with the arithmetic of a launch on that
    row alone.  Launches the kernel of ``csrc/obd.cu`` (f32 or f64, any
    ``N <= 1024``, free and ideal gases included); there is no CPU
    version here: ``models/mrbp.py`` runs ``models/jastrow.py``'s plain
    ``one_body_density_grid`` on a CPU tensor.  Each launch adds one to
    ``obd_grid.launch_count``, or with a table to
    ``obd_grid.table_launch_count``.
    """
    _check_params(pos, params, nop, 1, table=True)
    want = params.shape[:-1] + (offsets.shape[-1],)
    if offsets.dim() != params.dim() or tuple(offsets.shape) != want \
            or offsets.shape[-1] == 0 or offsets.dtype != pos.dtype \
            or offsets.device != pos.device or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous (M,) tensor, or (R, "
                         "M) beside a table of R rows, M > 0, in pos' dtype "
                         "on pos' device")
    num_walkers, num_pos = pos.shape[0], offsets.shape[-1]
    out = pos.new_empty((num_walkers, num_pos))
    if num_walkers == 0:
        return out
    per_row = num_walkers // params.shape[0] if params.dim() == 2 \
        else num_walkers
    suffix = "f32" if pos.dtype == torch.float32 else "f64"
    _build.call(_build.functions()[f"qmc_obd_grid_{suffix}"], pos.device,
                pos.data_ptr(), params.data_ptr(), offsets.data_ptr(),
                out.data_ptr(), num_walkers, per_row, nop, num_pos,
                int(is_free), int(is_ideal))
    if params.dim() == 2:
        obd_grid.table_launch_count += 1
    else:
        obd_grid.launch_count += 1
    return out


#: Kernel launches since the last reset (set them to 0 to reset): with one
#: parameter vector, and with a sweep's table of rows.
obd_grid.launch_count = 0
obd_grid.table_launch_count = 0
