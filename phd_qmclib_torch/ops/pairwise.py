"""Fused Bijl-Jastrow local energy and drift: the DMC hot op.

Counterpart of ``phd_qmclib_tpu.ops.pairwise.energy_and_drift_pallas``
(forward variant).  For every walker, O(N^2) minimum-image pair terms
reduce to a per-particle drift and a per-walker local energy, plus the
one-body Kronig-Penney terms.

:func:`energy_and_drift` launches the hand-written CUDA kernel of
``csrc/pairwise.cu`` on a CUDA tensor and runs
:func:`energy_and_drift_plain` on a CPU tensor.  Both sum the energy per
particle first, ``E_L = sum_i (kin_i - drift_i^2 + pot_i)``, in the
order of the Pallas kernel.
"""
import math

import torch

from . import _build, trig
from .pbc import min_image_bounded, sign

__all__ = ["PARAMS_SIZE", "energy_and_drift", "energy_and_drift_plain",
           "pack_params"]

#: Packed-parameter layout.  Slots 0-12 are those of the JAX package's
#: ``pack_params``; slot 13 holds the Hamiltonian's lattice depth, which
#: the potential uses off the defects (slot 0 is the trial orbital's).
PARAMS_SIZE = 16
(P_V0, P_E0, P_K1, P_KP1, P_ZA, P_ZB, P_L, P_RM, P_K2, P_BETA, P_ROFF,
 P_AM, P_V0D, P_V0M) = range(14)

#: Largest particle count of the kernel: one thread per particle.
MAX_NOP = 1024


def pack_params(cfc, dtype: torch.dtype = torch.float32,
                device="cpu") -> torch.Tensor:
    """Pack the mrbp ``CFCParams`` into the ``(PARAMS_SIZE,)`` vector
    the kernel reads.

    Leaves may be floats or 0-d tensors; with 0-d tensors already on
    ``device`` the packing is one device-side stack and copies nothing
    from the host.
    """
    mp_, obf, tbf = cfc.model_params, cfc.obf_params, cfc.tbf_params
    entries = [obf.lattice_depth, obf.param_e0, obf.param_k1,
               obf.param_kp1, obf.well_width, obf.barrier_width,
               mp_.supercell_size, tbf.tbf_contact_cutoff,
               tbf.param_k2, tbf.param_beta, tbf.param_r_off,
               tbf.param_am, mp_.defect_magnitude, mp_.lattice_depth]
    vals = [torch.as_tensor(e, dtype=dtype, device=device).reshape(())
            for e in entries]
    vals[P_RM] = vals[P_RM].abs()
    vals += [torch.zeros_like(vals[0])] * (PARAMS_SIZE - len(vals))
    return torch.stack(vals)


def energy_and_drift_plain(pos: torch.Tensor, params: torch.Tensor, *,
                           nop: int, is_free: bool, is_ideal: bool,
                           defects_sep: int = 1):
    """Plain torch version of the kernel: ``(energy (W,), drift (W, N))``.

    The pair block is a ``(W, N, N)`` tensor.  f32 evaluates the
    rational tan polynomial, f64 the library sin/cos, as the JAX
    package's XLA path does.
    """
    p = params
    drift = torch.zeros_like(pos)
    kin_rows = torch.zeros_like(pos)
    pot = torch.zeros_like(pos)

    if not is_free:
        v0, e0, k1, kp1 = p[P_V0], p[P_E0], p[P_K1], p[P_KP1]
        z_a, z_b = p[P_ZA], p[P_ZB]
        n_cell = torch.floor(pos)
        z_cell = pos - n_cell
        in_barrier = z_a < z_cell
        ob_ldz = torch.where(
            in_barrier, kp1 * torch.tanh(kp1 * (z_cell - 1.0 + 0.5 * z_b)),
            -k1 * torch.tan(k1 * (z_cell - 0.5 * z_a)))
        ob_d2 = torch.where(in_barrier, v0 - e0, -e0)
        if defects_sep == 1:
            barrier_v = p[P_V0D].expand_as(pos)
        else:
            on_defect = torch.remainder(n_cell, defects_sep) == 0
            barrier_v = torch.where(on_defect, p[P_V0D], p[P_V0M])
        pot = torch.where(in_barrier, barrier_v, 0.0)
        drift = ob_ldz
        kin_rows = -ob_d2 + ob_ldz * ob_ldz

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
        if pos.dtype == torch.float32:
            s, c = trig.tancot_poly32(arg)
        else:
            s, c = torch.sin(arg), torch.cos(arg)
        v = torch.where(in_cut, s, c) / torch.where(in_cut, c, s)
        ldz = torch.where(in_cut, -k2, pref * beta) * v
        kin = torch.where(in_cut, k2 * k2, pref * pref * beta) \
            * (1.0 + v * v)
        drift = drift + torch.where(off, ldz * sign(d), 0.0).sum(dim=-1)
        kin_rows = kin_rows + torch.where(off, kin, 0.0).sum(dim=-1)

    energy = (kin_rows - drift * drift + pot).sum(dim=-1)
    return energy, drift


def energy_and_drift(pos: torch.Tensor, params: torch.Tensor, *,
                     nop: int, is_free: bool, is_ideal: bool,
                     defects_sep: int = 1):
    """Fused ``(energy (W,), drift (W, N))`` for walkers ``pos (W, N)``.

    A CUDA tensor launches the kernel of ``csrc/pairwise.cu`` (f32 or
    f64, any ``N <= 1024``); a CPU tensor runs
    :func:`energy_and_drift_plain`.  ``params`` is :func:`pack_params`'s
    vector in ``pos``'s dtype, on ``pos``'s device.
    """
    if pos.device.type == "cpu":
        return energy_and_drift_plain(pos, params, nop=nop,
                                      is_free=is_free, is_ideal=is_ideal,
                                      defects_sep=defects_sep)
    if pos.device.type != "cuda":
        raise ValueError(f"no kernel for device {pos.device}")
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    if pos.dim() != 2 or pos.shape[1] != nop or not 0 < nop <= MAX_NOP:
        raise ValueError(f"pos must be (W, nop) with 0 < nop <= "
                         f"{MAX_NOP}, got {tuple(pos.shape)}, nop={nop}")
    if params.shape != (PARAMS_SIZE,) or params.dtype != pos.dtype \
            or params.device != pos.device:
        raise ValueError("params must be pack_params' vector in pos' "
                         "dtype on pos' device")
    if not (pos.is_contiguous() and params.is_contiguous()):
        raise ValueError("pos and params must be contiguous")
    if defects_sep < 1:
        raise ValueError(f"defects_sep must be positive, got {defects_sep}")
    num_walkers = pos.shape[0]
    energy = torch.empty(num_walkers, dtype=pos.dtype, device=pos.device)
    drift = torch.empty_like(pos)
    if num_walkers == 0:
        return energy, drift
    lib = _build.library()
    launch = (lib.qmc_pair_energy_drift_f32 if pos.dtype == torch.float32
              else lib.qmc_pair_energy_drift_f64)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(launch(pos.data_ptr(), params.data_ptr(),
                            energy.data_ptr(), drift.data_ptr(),
                            num_walkers, nop, int(is_free), int(is_ideal),
                            defects_sep, stream),
                     "pair energy/drift kernel")
    energy_and_drift.launch_count += 1
    return energy, drift


#: Kernel launches since the last reset (set it to 0 to reset).
energy_and_drift.launch_count = 0
