"""The multi-rod Bloch-phonon model in plain PyTorch, for judging.

A 1D Bose gas in a Kronig-Penney lattice with a Bijl-Jastrow trial
function ``psi = prod_i f1(z_i) prod_{i<j} f2(|z_ij|)``: ``f1`` the
lattice's band-bottom orbital, ``f2`` ``am cos(k2 (r - r_off))`` inside
the cutoff ``rm`` and ``sin(pi r / L)^beta`` outside.  The equations are
those of the port's plain versions (``models/mrbp.py``,
``models/jastrow.py``, ``ideal.py`` of ``phd_qmclib_torch``), written
out again here with library trigonometry in whatever dtype the caller
passes (float64 to judge, a lower one for the control).  Nothing of the
program is imported: the parameters are solved here from the
configuration's numbers.
"""
import math
import typing as t

import numpy as np
import torch
from scipy.optimize import brentq

__all__ = ["Model", "ModelParams"]


class ModelParams(t.NamedTuple):
    """The numbers every function needs, solved from a configuration."""
    nop: int
    length: float
    v0: float           # lattice depth (barrier height)
    v0_defect: float    # barrier height on a defect site
    defects_sep: int
    well: float         # well width, 1 / (1 + r)
    barrier: float      # barrier width, r / (1 + r)
    e0: float
    k1: float
    kp1: float
    rm: float
    k2: float
    beta: float
    r_off: float
    am: float


def _kp_relation(v0: float, r: float, ez: float) -> float:
    """The Kronig-Penney dispersion relation at zero quasi-momentum."""
    if ez == 0:
        return (1 / (2 * (1 + r)) * math.sqrt(v0)
                * math.sinh(r / (1 + r) * math.sqrt(v0))
                + math.cosh(r / (1 + r) * math.sqrt(v0)) - 1.0)
    if ez == v0:
        return (-r * math.sqrt(v0) / (2 * (1 + r))
                * math.sin(math.sqrt(v0) / (1 + r))
                + math.cos(math.sqrt(v0) / (1 + r)) - 1.0)
    return ((v0 - 2 * ez) / (2 * math.sqrt(ez * (v0 - ez)))
            * math.sinh(r / (1 + r) * math.sqrt(v0 - ez))
            * math.sin(math.sqrt(ez) / (1 + r))
            + math.cosh(r / (1 + r) * math.sqrt(v0 - ez))
            * math.cos(math.sqrt(ez) / (1 + r)) - 1.0)


def solve_params(model: dict) -> ModelParams:
    """The orbital's band energy and the pair function's matching
    (``k2, beta, r_off, am``) from the configuration's ``model_spec``."""
    v0 = float(model["lattice_depth"])
    r = float(model["lattice_ratio"])
    gn = float(model["interaction_strength"])
    nop = int(model["boson_number"])
    length = float(model["supercell_size"])
    rm_abs = float(model["tbf_contact_cutoff"])
    num_defects = int(model.get("num_defects") or 0)
    v0_defect = float(model.get("defect_magnitude") or v0) \
        if num_defects else v0
    defects_sep = 1 if not num_defects \
        else int(math.ceil(length)) // num_defects
    upper = min(v0, (1 + r) ** 2 * math.pi ** 2)
    e0 = brentq(lambda ez: _kp_relation(v0, r, ez), 0.0, upper,
                xtol=1e-15, rtol=1e-15)
    lgm = 0.5 * (length / nop) ** 2 * gn
    rm = rm_abs / length
    a1d = 2.0 / (lgm * nop)
    tan, sin, cos, pi = math.tan, math.sin, math.cos, math.pi

    def beta_rm_of(k2rm):
        if k2rm == 0:
            return tan(pi * rm) / pi
        return (k2rm / pi * (rm - k2rm * a1d * tan(k2rm)) * tan(pi * rm)
                / (k2rm * a1d + rm * tan(k2rm)))

    def matching(k2rm):
        beta_rm = beta_rm_of(k2rm)
        return ((k2rm * sin(pi * rm)) ** 2
                + (pi * beta_rm * cos(pi * rm)) ** 2
                - pi ** 2 * beta_rm * rm)

    k2rm = brentq(matching, 0.0, pi / 2)
    k2 = k2rm / rm
    k2r_off = math.atan(1 / (k2 * a1d))
    beta = beta_rm_of(k2rm) / rm
    am = sin(pi * rm) ** beta / cos(k2rm - k2r_off)
    return ModelParams(
        nop=nop, length=length, v0=v0, v0_defect=v0_defect,
        defects_sep=defects_sep, well=1 / (1 + r), barrier=r / (1 + r),
        e0=e0, k1=math.sqrt(e0), kp1=math.sqrt(v0 - e0), rm=rm_abs,
        k2=k2 / length, beta=beta, r_off=k2r_off / k2 * length, am=am)


class Model:
    """The model's functions over walker batches ``pos (W, N)`` in the
    dtype of ``pos``, evaluated ``chunk`` walkers at a time so that the
    ``(chunk, N, N)`` pair tensors fit beside whatever is on the card."""

    def __init__(self, model_spec: dict, chunk: int = 512):
        self.p = solve_params(model_spec)
        self.chunk = chunk

    # -- one-body terms ------------------------------------------------------

    def _cell(self, z):
        return torch.remainder(z, 1.0)

    def f1_log(self, z):
        p = self.p
        zc = self._cell(z)
        barrier = torch.cosh(p.kp1 * (zc - 1.0 + 0.5 * p.barrier))
        cf = math.sqrt(1 + p.v0 / p.e0
                       * math.sinh(0.5 * math.sqrt(p.v0 - p.e0)
                                   * p.barrier) ** 2)
        well = cf * torch.cos(p.k1 * (zc - 0.5 * p.well))
        return torch.where(p.well < zc, barrier, well).abs().log()

    def f1_dz(self, z):
        p = self.p
        zc = self._cell(z)
        barrier = p.kp1 * torch.tanh(p.kp1 * (zc - 1.0 + 0.5 * p.barrier))
        well = -p.k1 * torch.tan(p.k1 * (zc - 0.5 * p.well))
        return torch.where(p.well < zc, barrier, well)

    def f1_dz2(self, z):
        p = self.p
        zc = self._cell(z)
        return torch.where(p.well < zc, torch.full_like(z, p.v0 - p.e0),
                           torch.full_like(z, -p.e0))

    def potential(self, z):
        p = self.p
        n_cell = torch.floor(z)
        in_barrier = p.well < z - n_cell
        if p.defects_sep == 1:
            height = torch.full_like(z, p.v0_defect)
        else:
            height = torch.where(torch.remainder(n_cell, p.defects_sep) == 0,
                                 p.v0_defect, p.v0)
        return torch.where(in_barrier, height, torch.zeros_like(z))

    # -- pair terms -------------------------------------------------------------

    def _min_image(self, d):
        return d - self.p.length * torch.round(d / self.p.length)

    def _pair_arg(self, r):
        p = self.p
        in_cut = r < abs(p.rm)
        arg = torch.where(in_cut, p.k2 * (r - p.r_off),
                          math.pi / p.length * r)
        return in_cut, arg

    def f2_log(self, r):
        p = self.p
        in_cut, arg = self._pair_arg(r)
        inside = torch.log(abs(p.am) * torch.cos(torch.where(in_cut, arg,
                                                             0.0)))
        outside = p.beta * torch.log(torch.sin(torch.where(in_cut, 1.0,
                                                           arg)))
        return torch.where(in_cut, inside, outside)

    def f2_terms(self, r):
        """``(f2'/f2, -f2''/f2 + (f2'/f2)^2)`` per pair."""
        p = self.p
        in_cut, arg = self._pair_arg(r)
        pref = math.pi / p.length
        tan_in = torch.tan(torch.where(in_cut, arg, 0.0))
        cot_out = 1.0 / torch.tan(torch.where(in_cut, 1.0, arg))
        v = torch.where(in_cut, tan_in, cot_out)
        ldz = torch.where(in_cut, -p.k2 * v, pref * p.beta * v)
        kin = torch.where(in_cut, p.k2 ** 2 * (1 + v * v),
                          pref ** 2 * p.beta * (1 + v * v))
        return ldz, kin

    def _geometry(self, pos):
        nop = pos.shape[-1]
        d = self._min_image(pos[:, :, None] - pos[:, None, :])
        off = ~torch.eye(nop, dtype=torch.bool, device=pos.device)
        r = torch.where(off, d.abs(), 0.25 * self.p.length)
        return d, r, off

    def _chunks(self, pos):
        return pos.split(self.chunk)

    # -- walker functions -------------------------------------------------------

    def energy_drift(self, pos):
        """Local energy ``(W,)`` and drift ``(W, N)``."""
        energies, drifts = [], []
        for x in self._chunks(pos):
            d, r, off = self._geometry(x)
            ldz, kin = self.f2_terms(r)
            sgn = torch.where(d >= 0, 1.0, -1.0).to(x.dtype)
            drift = self.f1_dz(x) + torch.where(off, ldz * sgn, 0.0).sum(-1)
            one = (-self.f1_dz2(x) + self.f1_dz(x) ** 2).sum(-1)
            pair = torch.where(off, kin, 0.0).sum((-1, -2))
            energies.append(one + pair - (drift ** 2).sum(-1)
                            + self.potential(x).sum(-1))
            drifts.append(drift)
        return torch.cat(energies), torch.cat(drifts)

    def log_psi(self, pos):
        out = []
        for x in self._chunks(pos):
            _, r, off = self._geometry(x)
            out.append(self.f1_log(x).sum(-1)
                       + 0.5 * torch.where(off, self.f2_log(r), 0.0)
                       .sum((-1, -2)))
        return torch.cat(out)

    # -- estimators (per walker) ------------------------------------------------

    def density_hist(self, pos, num_bins: int):
        """``(W, num_bins)`` counts of the particles over ``[0, L)``."""
        size = self.p.length / num_bins
        ids = torch.clamp(torch.floor(pos / size), 0, num_bins - 1).long()
        out = torch.zeros(pos.shape[0], num_bins, dtype=pos.dtype,
                          device=pos.device)
        return out.scatter_add_(1, ids, torch.ones_like(pos))

    def ssf_reim(self, pos, num_modes: int):
        """``(W, M, 2)``: ``Re, Im`` of ``rho_k = sum_i exp(i k z_i)`` at
        ``k_j = 2 pi j / L``."""
        k = (2 * math.pi / self.p.length) * torch.arange(
            num_modes, dtype=pos.dtype, device=pos.device)
        out = []
        for x in self._chunks(pos):
            phase = x[:, :, None] * k
            out.append(torch.stack([torch.cos(phase).sum(1),
                                    torch.sin(phase).sum(1)], -1))
        return torch.cat(out)

    def ssf_parts(self, pos, num_modes: int):
        """``(W, M, 3)``: ``|rho_k|^2, Re rho_k, Im rho_k``."""
        reim = self.ssf_reim(pos, num_modes)
        re, im = reim[..., 0], reim[..., 1]
        return torch.stack([re * re + im * im, re, im], -1)

    def obd_grid(self, pos, num_pos: int):
        """``(W, num_pos)``: the mean over particles of ``psi`` with that
        particle moved by ``sz`` over ``psi``, ``sz`` on ``num_pos``
        points over ``[0, L/2]``."""
        offsets = np.linspace(0.0, 0.5 * self.p.length, num_pos)
        out = []
        for x in self._chunks(pos):
            d0 = x[:, :, None] - x[:, None, :]
            _, r, off = self._geometry(x)
            base = self.f1_log(x) + torch.where(off, self.f2_log(r),
                                                0.0).sum(-1)
            cols = []
            for sz in offsets:
                r_s = torch.where(off, self._min_image(d0 + sz).abs(),
                                  0.25 * self.p.length)
                num = self.f1_log(x + sz) + torch.where(
                    off, self.f2_log(r_s), 0.0).sum(-1)
                cols.append(torch.exp(num - base).mean(-1))
            out.append(torch.stack(cols, -1))
        return torch.cat(out)

    def pair_hist(self, pos, num_bins: int):
        """``(W, num_bins)`` counts of the unordered pairs' minimum-image
        distances over ``[0, L/2]``."""
        size = 0.5 * self.p.length / num_bins
        iu = torch.triu_indices(pos.shape[1], pos.shape[1], 1,
                                device=pos.device)
        out = []
        for x in self._chunks(pos):
            r = self._min_image(x[:, iu[0]] - x[:, iu[1]]).abs()
            ids = torch.clamp(torch.floor(r / size), 0, num_bins - 1).long()
            hist = torch.zeros(x.shape[0], num_bins, dtype=x.dtype,
                               device=x.device)
            out.append(hist.scatter_add_(1, ids, torch.ones_like(r)))
        return torch.cat(out)

    def walker_estimator(self, name: str, pos, spec: dict):
        """Per-walker values of a VMC estimator by its spec's name: the
        S(k) parts ``ssf``, the OBDM grid ``obd`` or the g2 counts
        ``g2``."""
        if name == "ssf":
            return self.ssf_parts(pos, int(spec["num_modes"]))
        if name == "obd":
            return self.obd_grid(pos, int(spec["num_pos"]))
        if name == "g2":
            return self.pair_hist(pos, int(spec["num_bins"]))
        raise KeyError(f"no estimator {name!r}")
