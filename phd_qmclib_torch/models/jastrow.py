"""Generic Bijl-Jastrow pair-product wavefunction functions.

Counterpart of ``phd_qmclib_tpu.models.jastrow``.  The trial
wavefunction is ``psi(z) = prod_i f1(z_i) * prod_{i<j} f2(|z_ij|)`` for
model-supplied one-body (``f1``) and two-body (``f2``) functions; every
function here is a batched torch function over positions of shape
``(..., N)``, with the pair loops written as ``(..., N, N)`` tensors.

Naming carried over from the JAX package: the ``*_log_dz`` callables
return the log-derivative ``f'/f`` while the ``*_log_dz2`` callables
return the bare second-derivative ratio ``f''/f``.  With that
convention the local energy is::

    E_L = sum_t (-f_t''/f_t + (f_t'/f_t)^2) - sum_i drift_i^2 + V
        = -(laplacian psi)/psi + V
"""
import math
import typing as t
from types import SimpleNamespace

import torch

from ..ops import histogram
from ..ops.pbc import min_image, min_image_bounded, sign

__all__ = ["CFCParams", "build_core_funcs", "SysConfSlot"]


class SysConfSlot:
    """Slots of a packed ``(2, N)`` system configuration."""
    pos: int = 0
    drift: int = 1


class CFCParams(t.NamedTuple):
    """Continuous core-function parameters.

    Concrete models define the ``model_params`` / ``obf_params`` /
    ``tbf_params`` groups; their leaves are Python floats or 0-d
    tensors.
    """
    model_params: t.Any
    obf_params: t.Any
    tbf_params: t.Any


def _pair_axis(cfc: CFCParams) -> CFCParams:
    """``cfc`` for the ``(..., N, N)`` pair tensors: a leaf with a row
    axis (a fused sweep's ``(R, 1, 1)``, for ``(R, W, N)`` positions)
    gains one trailing axis; a 0-d leaf stays as it is."""
    def widen(x):
        return x[..., None] if isinstance(x, torch.Tensor) and x.dim() \
            else x

    return CFCParams(*(type(group)(*(widen(x) for x in group))
                       for group in cfc))


def build_core_funcs(*,
                     one_body,
                     one_body_log_dz,
                     one_body_log_dz2,
                     two_body_pair_terms,
                     potential,
                     is_free: bool,
                     is_ideal: bool,
                     boson_number: int) -> SimpleNamespace:
    """Build the Jastrow function namespace for a concrete model.

    Every model callable has signature ``(x, cfc: CFCParams) -> value``
    and is vectorized over ``x``.  ``two_body_pair_terms(r, cfc,
    need_log, need_derivs, need_kin)`` returns the fused
    ``(log|f2|, f2'/f2, third)`` pair terms, where ``third`` is the
    per-pair kinetic term ``-f2''/f2 + (f2'/f2)^2`` with ``need_kin``
    and ``f2''/f2`` otherwise.  ``is_free`` / ``is_ideal`` drop the
    corresponding terms when the functions are built.

    Returns a namespace with ``log_psi``, ``drift``, ``energy``,
    ``energy_and_drift`` and ``log_psi_and_energy``, the
    single-configuration ``wf_abs``, ``delta_log_psi_move`` and
    ``delta_drift_move``, ``one_body_density`` (the OBDM at one
    displacement), and the estimator functions ``fourier_density`` and ``fourier_density_parts`` (S(k) at
    explicit momenta), ``fourier_density_parts_harmonics`` (S(k)),
    ``one_body_density_grid`` (OBDM) and ``pair_dist_histogram`` (g2).
    """
    nop = boson_number

    def _pair_geometry(pos, cfc):
        """Minimum-image pair displacements, distances and the
        off-diagonal mask.

        Diagonal distances are replaced by a safe value (L/4) before the
        two-body functions see them, so masked-out entries never produce
        inf/NaN values.
        """
        sc = cfc.model_params.supercell_size
        d = pos[..., :, None] - pos[..., None, :]
        # Positions live in [0, L): differences are bounded by (-L, L),
        # so the cheap round-based minimum image applies.
        d = min_image_bounded(d, sc)
        off_diag = ~torch.eye(nop, dtype=torch.bool, device=pos.device)
        r = torch.where(off_diag, d.abs(), 0.25 * sc)
        return d, r, off_diag

    def _masked_sum(x, mask, dim):
        return torch.where(mask, x, 0.0).sum(dim=dim)

    def log_psi(pos, cfc: CFCParams):
        """log|psi| for configurations ``pos`` of shape ``(..., N)``."""
        total = torch.zeros(pos.shape[:-1], dtype=pos.dtype,
                            device=pos.device)
        if not is_free:
            total = total + one_body(pos, cfc).abs().log().sum(dim=-1)
        if not is_ideal:
            _, r, off_diag = _pair_geometry(pos, cfc)
            log_tb, _, _ = two_body_pair_terms(r, cfc, need_log=True,
                                               need_derivs=False)
            total = total + 0.5 * _masked_sum(log_tb, off_diag, (-1, -2))
        return total

    def drift(pos, cfc: CFCParams):
        """Drift force ``F_i = d(log|psi|)/dz_i``, shape ``(..., N)``."""
        out = torch.zeros_like(pos)
        if not is_free:
            out = out + one_body_log_dz(pos, cfc)
        if not is_ideal:
            d, r, off_diag = _pair_geometry(pos, cfc)
            _, tb_ldz, _ = two_body_pair_terms(r, cfc, need_log=False,
                                               need_derivs=True)
            out = out + _masked_sum(tb_ldz * sign(d), off_diag, -1)
        return out

    def _one_body_terms(pos, cfc):
        ob_ldz = one_body_log_dz(pos, cfc)
        ob_ldz2 = one_body_log_dz2(pos, cfc)
        kin = (-ob_ldz2 + ob_ldz ** 2).sum(dim=-1)
        pot = potential(pos, cfc).sum(dim=-1)
        return ob_ldz, kin, pot

    def energy_and_drift(pos, cfc: CFCParams):
        """Fused local energy and drift - the DMC hot function.

        Returns ``(energy (...,), drift (..., N))``.
        """
        batch_shape = pos.shape[:-1]
        zeros = torch.zeros(batch_shape, dtype=pos.dtype,
                            device=pos.device)
        kin, pot, drift_v = zeros, zeros, torch.zeros_like(pos)
        if not is_free:
            drift_v, kin, pot = _one_body_terms(pos, cfc)
        if not is_ideal:
            d, r, off_diag = _pair_geometry(pos, cfc)
            _, tb_ldz, tb_kin = two_body_pair_terms(
                r, cfc, need_log=False, need_derivs=True, need_kin=True)
            kin = kin + _masked_sum(tb_kin, off_diag, (-1, -2))
            drift_v = drift_v + _masked_sum(tb_ldz * sign(d), off_diag,
                                            -1)
        energy_v = kin - (drift_v ** 2).sum(dim=-1) + pot
        return energy_v, drift_v

    def energy(pos, cfc: CFCParams):
        """Local energy ``E_L``."""
        return energy_and_drift(pos, cfc)[0]

    def log_psi_and_energy(pos, cfc: CFCParams):
        """Fused ``(log|psi|, E_L)`` - the VMC hot function."""
        batch_shape = pos.shape[:-1]
        zeros = torch.zeros(batch_shape, dtype=pos.dtype,
                            device=pos.device)
        lp, kin, pot, drift_v = zeros, zeros, zeros, torch.zeros_like(pos)
        if not is_free:
            lp = one_body(pos, cfc).abs().log().sum(dim=-1)
            drift_v, kin, pot = _one_body_terms(pos, cfc)
        if not is_ideal:
            d, r, off_diag = _pair_geometry(pos, cfc)
            log_tb, tb_ldz, tb_kin = two_body_pair_terms(
                r, cfc, need_log=True, need_derivs=True, need_kin=True)
            lp = lp + 0.5 * _masked_sum(log_tb, off_diag, (-1, -2))
            kin = kin + _masked_sum(tb_kin, off_diag, (-1, -2))
            drift_v = drift_v + _masked_sum(tb_ldz * sign(d), off_diag,
                                            -1)
        energy_v = kin - (drift_v ** 2).sum(dim=-1) + pot
        return lp, energy_v

    # -- single-particle moves and the single-offset OBDM --------------------

    def _pair_log(r, cfc):
        """``log f2(r)``."""
        return two_body_pair_terms(r, cfc, need_log=True,
                                   need_derivs=False)[0]

    def _pair_log_dz(r, cfc):
        """``f2'/f2`` at the distance ``r``."""
        return two_body_pair_terms(r, cfc, need_log=False,
                                   need_derivs=True)[1]

    def wf_abs(pos, cfc: CFCParams):
        """``|psi|``."""
        return torch.exp(log_psi(pos, cfc))

    def delta_log_psi_move(k: int, z_k_delta, pos, cfc: CFCParams):
        """Change of ``log|psi|`` after moving particle ``k`` by
        ``z_k_delta`` (an O(N) update).  ``pos`` is a single
        configuration of shape ``(N,)``."""
        sc = cfc.model_params.supercell_size
        z_k = pos[k]
        z_k_upd = z_k + z_k_delta
        delta = torch.zeros((), dtype=pos.dtype, device=pos.device)
        if not is_free:
            delta = delta + (one_body(z_k_upd, cfc)
                             / one_body(z_k, cfc)).abs().log()
        if not is_ideal:
            others = torch.arange(nop, device=pos.device) != k
            # The particle's own slot takes a safe distance, as the
            # diagonal does in the pair functions.
            r_ki = torch.where(others, min_image(z_k - pos, sc).abs(),
                               0.25 * sc)
            r_ki_upd = torch.where(others,
                                   min_image(z_k_upd - pos, sc).abs(),
                                   0.25 * sc)
            delta = delta + _masked_sum(
                _pair_log(r_ki_upd, cfc) - _pair_log(r_ki, cfc), others, -1)
        return delta

    def delta_drift_move(i: int, k: int, z_k_delta, pos, cfc: CFCParams):
        """Change of the ``i``-th drift component after moving particle
        ``k`` by ``z_k_delta`` (an O(N) update).  ``pos`` is a single
        configuration of shape ``(N,)``."""
        sc = cfc.model_params.supercell_size
        z_k = pos[k]
        z_k_upd = z_k + z_k_delta

        def signed_log_dz(d):
            return _pair_log_dz(d.abs(), cfc) * sign(d)

        if i != k:
            # Only the (i, k) pair term changes; the drift seen from i
            # takes the displacement z_k - z_i with a minus sign.
            if is_ideal:
                return torch.zeros((), dtype=pos.dtype, device=pos.device)
            z_i = pos[i]
            return -(signed_log_dz(min_image(z_k_upd - z_i, sc))
                     - signed_log_dz(min_image(z_k - z_i, sc)))
        delta = torch.zeros((), dtype=pos.dtype, device=pos.device)
        if not is_free:
            delta = delta + (one_body_log_dz(z_k_upd, cfc)
                             - one_body_log_dz(z_k, cfc))
        if not is_ideal:
            others = torch.arange(nop, device=pos.device) != k
            d = torch.where(others, min_image(z_k - pos, sc), 0.25 * sc)
            d_upd = torch.where(others, min_image(z_k_upd - pos, sc),
                                0.25 * sc)
            delta = delta + _masked_sum(
                signed_log_dz(d_upd) - signed_log_dz(d), others, -1)
        return delta

    def one_body_density(sz, pos, cfc: CFCParams):
        """OBDM ``n1(sz)`` at one displacement: the average over
        particles of the wavefunction ratio with particle ``i`` moved by
        ``sz``.  ``pos (..., N)``, ``sz`` a scalar; returns ``(...)``."""
        log_ratio = torch.zeros_like(pos)
        if not is_free:
            log_ratio = log_ratio + (one_body(pos + sz, cfc).log()
                                     - one_body(pos, cfc).log())
        if not is_ideal:
            sc = cfc.model_params.supercell_size
            off_diag = ~torch.eye(nop, dtype=torch.bool, device=pos.device)
            d = min_image(pos[..., :, None] - pos[..., None, :], sc)
            d_sft = min_image((pos + sz)[..., :, None] - pos[..., None, :],
                              sc)
            r = torch.where(off_diag, d.abs(), 0.25 * sc)
            r_sft = torch.where(off_diag, d_sft.abs(), 0.25 * sc)
            log_ratio = log_ratio + _masked_sum(
                _pair_log(r_sft, cfc) - _pair_log(r, cfc), off_diag, -1)
        return torch.exp(log_ratio).sum(dim=-1) / nop

    # -- estimators -----------------------------------------------------------

    def one_body_density_grid(szs, pos, cfc: CFCParams):
        """OBDM ``n1`` at a grid of displacements: ``szs (M,)``, ``pos
        (..., N)`` -> ``(..., M)``; the average over particles of the
        wavefunction ratio with particle ``i`` moved by ``sz``.

        The unshifted per-particle log sums (one-body orbital plus the
        row sums of the pair matrix) are shared by every offset, so each
        offset costs one pair-log pass over the shifted distances
        ``|z_ij + sz|``.  The offsets run one after the other: one
        ``(..., N, N)`` pass is live at a time.
        """
        out_shape = pos.shape[:-1] + (szs.shape[0],)
        if is_free and is_ideal:
            return torch.ones(out_shape, dtype=pos.dtype, device=pos.device)
        # A fused sweep's rows: (M, R, 1, 1) offsets and (R, 1, 1)
        # leaves for (R, W, N) positions; the pair terms take them with
        # one more axis.
        pair_cfc = _pair_axis(cfc)
        sc = pair_cfc.model_params.supercell_size
        base = torch.zeros_like(pos)
        d0 = off_diag = None
        if not is_free:
            base = base + one_body(pos, cfc).abs().log()
        if not is_ideal:
            # Raw differences (bounded by (-L, L)); the minimum image
            # applies per offset after the shift.
            d0 = pos[..., :, None] - pos[..., None, :]
            off_diag = ~torch.eye(nop, dtype=torch.bool, device=pos.device)
            r = torch.where(off_diag, min_image_bounded(d0, sc).abs(),
                            0.25 * sc)
            log_tb, _, _ = two_body_pair_terms(r, pair_cfc, need_log=True,
                                               need_derivs=False)
            base = base + _masked_sum(log_tb, off_diag, -1)

        columns = []
        for sz in szs:
            num = torch.zeros_like(pos)
            if not is_free:
                num = num + one_body(pos + sz, cfc).abs().log()
            if not is_ideal:
                sz_pair = sz[..., None] if sz.dim() else sz
                r_s = torch.where(off_diag,
                                  min_image(d0 + sz_pair, sc).abs(),
                                  0.25 * sc)
                log_tb_s, _, _ = two_body_pair_terms(
                    r_s, pair_cfc, need_log=True, need_derivs=False)
                num = num + _masked_sum(log_tb_s, off_diag, -1)
            columns.append(torch.exp(num - base).sum(dim=-1) / nop)
        return torch.stack(columns, dim=-1)

    def fourier_density(kz, pos, cfc: CFCParams):
        """Fourier component of the density, ``rho_k = sum_i e^{i k
        z_i}``, for the momenta ``kz (M,)`` and ``pos (..., N)``:
        complex ``(..., M)``."""
        phase = pos[..., :, None] * kz  # (..., N, M)
        return torch.complex(torch.cos(phase).sum(dim=-2),
                             torch.sin(phase).sum(dim=-2))

    def fourier_density_parts(kz, pos, cfc: CFCParams):
        """S(k) parts ``(|rho_k|^2, Re rho_k, Im rho_k)`` for explicit
        momenta ``kz (M,)``, shape ``(..., M, 3)``: the VMC sampler seeds
        its carried parts with them."""
        phase = pos[..., :, None] * kz
        re = torch.cos(phase).sum(dim=-2)
        im = torch.sin(phase).sum(dim=-2)
        return torch.stack([re ** 2 + im ** 2, re, im], dim=-1)

    def _harmonics_reim(num_modes: int, pos, cfc: CFCParams):
        """``(Re rho_k, Im rho_k)`` for the harmonic momenta ``k_j = j 2
        pi / L``, ``j = 0..num_modes-1``, as the pair of ``(num_modes,
        ...)`` tensors both harmonics estimators build on.

        One sincos on ``(..., N)``, then the Chebyshev recurrence
        ``cos((j+1)t) = 2 cos t cos(jt) - cos((j-1)t)`` (the same for
        sin) for the other modes, with the JAX package's operation
        order.  The modes of cos and sin stack into one ``(M, 2, ...,
        N)`` buffer, two launches per mode, and reduce over the
        particles in one sum.
        """
        sc = cfc.model_params.supercell_size
        theta = (torch.full_like(sc, 2 * math.pi) / sc) * pos
        buf = torch.empty((num_modes, 2) + pos.shape, dtype=pos.dtype,
                          device=pos.device)
        buf[0, 0] = 1.0
        buf[0, 1] = 0.0
        if num_modes > 1:
            torch.cos(theta, out=buf[1, 0])
            torch.sin(theta, out=buf[1, 1])
            two_c1 = 2 * buf[1, 0]
        for j in range(2, num_modes):
            torch.sub(two_c1 * buf[j - 1], buf[j - 2], out=buf[j])
        return buf.sum(dim=-1).unbind(1)

    def fourier_density_parts_harmonics(num_modes: int, pos,
                                        cfc: CFCParams):
        """S(k) parts ``(|rho_k|^2, Re rho_k, Im rho_k)`` for the
        harmonic momenta ``k_j = j 2 pi / L``, ``j = 0..num_modes-1``,
        shape ``(..., num_modes, 3)``, by the Chebyshev recurrence of
        :func:`_harmonics_reim`."""
        re, im = _harmonics_reim(num_modes, pos, cfc)
        parts = torch.stack([re ** 2 + im ** 2, re, im], dim=-1)
        return torch.movedim(parts, 0, -2)

    def fourier_density_reim_harmonics(num_modes: int, pos,
                                       cfc: CFCParams):
        """Per-configuration ``(Re rho_k, Im rho_k)`` for the harmonic
        momenta, shape ``(..., num_modes, 2)``: the amplitude the
        imaginary-time correlation estimator tags each walker with.
        The same recurrence and particle sum as
        :func:`fourier_density_parts_harmonics`, so the pair equals that
        function's slots 1-2 bit for bit."""
        re, im = _harmonics_reim(num_modes, pos, cfc)
        return torch.movedim(torch.stack([re, im], dim=-1), 0, -2)

    def pair_dist_histogram(num_bins: int, pos, cfc: CFCParams):
        """Per-walker histogram of the unordered-pair minimum-image
        distances over ``num_bins`` uniform bins spanning ``[0, L/2]``:
        ``(..., num_bins)`` exact counts, each unordered pair once, so
        that ``g2(r) = <counts(r)> L / (N (N-1) dr)``.

        Bins the ``(..., N, N)`` distance matrix row by row with
        :func:`phd_qmclib_torch.ops.histogram.walker_histogram` (the
        CUDA kernel on a CUDA tensor), sums over ``i``, takes the N
        exact-zero diagonal entries out of bin 0 and halves: all exact.
        """
        if nop < 2:
            return torch.zeros(pos.shape[:-1] + (num_bins,),
                               dtype=pos.dtype, device=pos.device)
        # A fused sweep's (R, 1, 1) supercells bin their rows' pairs
        # with their own widths (one table entry per row).
        sc = _pair_axis(cfc).model_params.supercell_size
        r = min_image_bounded(pos[..., :, None] - pos[..., None, :],
                              sc).abs()  # diagonal exactly 0
        bin_size = 0.5 * sc / torch.full_like(sc, num_bins)
        hist = histogram.walker_histogram(r, bin_size, num_bins).sum(dim=-2)
        hist[..., 0] -= nop
        return 0.5 * hist

    return SimpleNamespace(log_psi=log_psi, drift=drift, energy=energy,
                           energy_and_drift=energy_and_drift,
                           log_psi_and_energy=log_psi_and_energy,
                           wf_abs=wf_abs,
                           delta_log_psi_move=delta_log_psi_move,
                           delta_drift_move=delta_drift_move,
                           one_body_density=one_body_density,
                           one_body_density_grid=one_body_density_grid,
                           fourier_density=fourier_density,
                           fourier_density_parts=fourier_density_parts,
                           fourier_density_parts_harmonics=(
                               fourier_density_parts_harmonics),
                           fourier_density_reim_harmonics=(
                               fourier_density_reim_harmonics),
                           pair_dist_histogram=pair_dist_histogram)
