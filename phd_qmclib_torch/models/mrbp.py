"""Multi-rod Bloch-phonon (mrbp) QMC model.

Counterpart of ``phd_qmclib_tpu.models.mrbp``.  A 1D Bose gas with
repulsive contact interactions in a multi-rod (Kronig-Penney) optical
lattice, with a Bijl-Jastrow trial wavefunction:

* one-body factor: the exact single-particle KP band-bottom orbital
  (piecewise cos in the wells / cosh in the barriers),
* two-body factor: the phonon-like pair function ``am*cos(k2(r-r_off))``
  inside a variational cutoff ``rm`` matched to ``sin(pi r/L)^beta``
  outside.

The spec is a frozen host-side dataclass (NumPy/SciPy, copied from the
JAX package); the functions are batched torch functions.  The fused
energy and drift, and the fused log|psi| and energy, of :func:`core_funcs`
run through :func:`phd_qmclib_torch.ops.pairwise.energy_and_drift`,
which launches the hand-written CUDA kernel on a CUDA tensor, the OBDM
grid through :func:`phd_qmclib_torch.ops.pairwise.obd_grid` there, and
the S(k) harmonics through :func:`phd_qmclib_torch.ops.ssf.ssf_harmonics`.
"""
import functools
import math
import typing as t
from dataclasses import dataclass, replace
from enum import Enum
from functools import cached_property

import numpy as np
import torch
from scipy.optimize import brentq

from .. import ideal
from ..ops import pairwise, ssf, trig
from ..ops.pbc import recast_to_supercell
from ..utils import tracing
from . import jastrow
from .jastrow import CFCParams, SysConfSlot

__all__ = [
    "CFCParams",
    "ModelParams",
    "OBFParams",
    "PhysicalFuncs",
    "Spec",
    "StaticSpec",
    "SysConfDistType",
    "SysConfSlot",
    "TBFParams",
    "cast_params",
    "cfc_params_device",
    "cfc_params_from_numpy",
    "core_funcs",
    "obf_params_device",
    "recast",
    "tbf_params_device",
    "DIST_RAND",
    "DIST_REGULAR",
]


class SysConfDistType(Enum):
    """Initial-configuration arrangements."""
    RANDOM = "random"
    REGULAR = "regular"


DIST_RAND = SysConfDistType.RANDOM
DIST_REGULAR = SysConfDistType.REGULAR


class ModelParams(t.NamedTuple):
    """Continuous model parameters."""
    lattice_depth: float
    lattice_ratio: float
    interaction_strength: float
    supercell_size: float
    tbf_contact_cutoff: float
    defect_magnitude: float
    well_width: float
    barrier_width: float


class OBFParams(t.NamedTuple):
    """One-body function parameters."""
    lattice_depth: float
    lattice_ratio: float
    well_width: float
    barrier_width: float
    param_e0: float
    param_k1: float
    param_kp1: float


class TBFParams(t.NamedTuple):
    """Two-body function parameters."""
    supercell_size: float
    tbf_contact_cutoff: float
    param_k2: float
    param_beta: float
    param_r_off: float
    param_am: float


class StaticSpec(t.NamedTuple):
    """Model structure that selects the code path of the functions."""
    boson_number: int
    defects_sep: int
    is_free: bool
    is_ideal: bool


@dataclass(frozen=True)
class Spec:
    """The parameters of the Bloch-Phonon QMC model.

    Copy of ``phd_qmclib_tpu.models.mrbp.Spec``, including the defect
    handling in the post-init stage and the domain validators.
    """
    #: The lattice depth of the potential.
    lattice_depth: float
    #: The ratio of the barriers width between the wells width.
    lattice_ratio: float
    #: The magnitude of the interaction strength between two bosons.
    interaction_strength: float
    #: The number of bosons.
    boson_number: int
    #: The size of the QMC simulation box.
    supercell_size: float
    #: The variational parameter of the two-body functions.
    tbf_contact_cutoff: float
    #: Number of defects, evenly spaced.
    num_defects: t.Optional[int] = None
    #: Magnitude for all the defects.
    defect_magnitude: t.Optional[float] = None
    #: Variational trial-orbital lattice depth: the one-body Bloch
    #: orbital solves the KP band problem at this depth while the
    #: Hamiltonian keeps ``lattice_depth``.  ``None`` (default) ties the
    #: orbital to the physical depth.
    obf_lattice_depth: t.Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "lattice_depth", float(self.lattice_depth))
        object.__setattr__(self, "lattice_ratio", float(self.lattice_ratio))
        object.__setattr__(self, "interaction_strength",
                           float(self.interaction_strength))
        object.__setattr__(self, "boson_number", int(self.boson_number))
        object.__setattr__(self, "supercell_size",
                           float(self.supercell_size))
        object.__setattr__(self, "tbf_contact_cutoff",
                           float(self.tbf_contact_cutoff))

        if not abs(self.tbf_contact_cutoff) <= abs(self.supercell_size / 2):
            raise ValueError("tbf_contact_cutoff (rm) lies outside its allowed range")

        if self.obf_lattice_depth is not None:
            v0b = float(self.obf_lattice_depth)
            object.__setattr__(self, "obf_lattice_depth", v0b)
            if self.is_free:
                raise ValueError(
                    "obf_lattice_depth needs a finite lattice (the "
                    "free-gas trial orbital is flat)")
            if v0b <= 0:
                raise ValueError("obf_lattice_depth must be positive")

        lattice_depth = self.lattice_depth
        num_defects = self.num_defects
        defect_magnitude = self.defect_magnitude
        if defect_magnitude is None and num_defects is None:
            object.__setattr__(self, "defect_magnitude", lattice_depth)
            object.__setattr__(self, "num_defects", 0)
        else:
            if num_defects is None:
                num_defects = 0
                defect_magnitude = lattice_depth
            else:
                num_defects = int(num_defects)
                defect_magnitude = (float(defect_magnitude)
                                    if num_defects and
                                    defect_magnitude is not None
                                    else lattice_depth)
            if num_defects < 0:
                raise ValueError("num_defects must be zero or positive")
            num_sites = int(math.ceil(self.supercell_size))
            if num_defects and (num_sites % num_defects):
                raise ValueError(
                    f"num_defects ({num_defects:d}) does not divide the "
                    f"lattice into equal defect spacings")
            if defect_magnitude > lattice_depth:
                raise ValueError("defect_magnitude must not exceed "
                                 "lattice_depth")
            object.__setattr__(self, "defect_magnitude", defect_magnitude)
            object.__setattr__(self, "num_defects", num_defects)

    # -- derived geometry ---------------------------------------------------

    @property
    def boundaries(self) -> t.Tuple[float, float]:
        return 0.0, 1.0 * self.supercell_size

    @property
    def well_width(self) -> float:
        r = self.lattice_ratio
        return 1 / (1 + r)

    @property
    def barrier_width(self) -> float:
        r = self.lattice_ratio
        return r / (1 + r)

    @property
    def is_free(self) -> bool:
        """Free system: vanishing lattice."""
        return self.lattice_depth <= 1e-10 or self.lattice_ratio <= 1e-10

    @property
    def is_ideal(self) -> bool:
        """Ideal system: vanishing interaction."""
        return self.interaction_strength <= 1e-10

    @property
    def defects_sep(self) -> int:
        num_sites = int(math.ceil(self.supercell_size))
        num_defects = self.num_defects
        return 1 if not num_defects else int(num_sites // num_defects)

    @property
    def sys_conf_shape(self) -> t.Tuple[int, int]:
        """Shape of a packed (pos, drift) configuration buffer."""
        return 2, self.boson_number

    def get_sys_conf_buffer(self) -> np.ndarray:
        return np.zeros(self.sys_conf_shape, dtype=np.float64)

    def init_get_sys_conf(self, dist_type=DIST_RAND, offset=None,
                          rng: t.Optional[np.random.Generator] = None) \
            -> np.ndarray:
        """Initial particle configuration, random or regular."""
        nop = self.boson_number
        sc_size = self.supercell_size
        z_min, _ = self.boundaries
        sys_conf = self.get_sys_conf_buffer()
        offset = offset or 0.0

        if dist_type is DIST_RAND:
            rng = rng if rng is not None else np.random.default_rng()
            spread = sc_size * rng.random(nop)
        elif dist_type is DIST_REGULAR:
            spread = np.linspace(0, sc_size, nop, endpoint=False)
        else:
            raise ValueError(f"unrecognized '{dist_type}' dist_type")

        sys_conf[SysConfSlot.pos, :] = z_min + (offset + spread) % sc_size
        return sys_conf

    # -- derived parameters ---------------------------------------------------

    @property
    def static_spec(self) -> StaticSpec:
        return StaticSpec(self.boson_number, self.defects_sep,
                          self.is_free, self.is_ideal)

    @property
    def params(self) -> ModelParams:
        return ModelParams(self.lattice_depth,
                           self.lattice_ratio,
                           self.interaction_strength,
                           self.supercell_size,
                           self.tbf_contact_cutoff,
                           self.defect_magnitude,
                           self.well_width,
                           self.barrier_width)

    @cached_property
    def obf_params(self) -> OBFParams:
        """One-body orbital parameters: solves the ideal KP band problem
        at ``obf_lattice_depth`` when one is set, else at
        ``lattice_depth``."""
        v0 = (self.obf_lattice_depth
              if self.obf_lattice_depth is not None
              else self.lattice_depth)
        r = self.lattice_ratio
        if self.is_free:
            e0 = 0.0
            k1, kp1 = 0.0, 0.0
        else:
            e0 = float(ideal.eigen_energy(v0, r))
            k1, kp1 = math.sqrt(e0), math.sqrt(v0 - e0)
        return OBFParams(v0,
                         self.lattice_ratio,
                         self.well_width,
                         self.barrier_width,
                         param_e0=e0,
                         param_k1=k1,
                         param_kp1=kp1)

    @cached_property
    def tbf_params(self) -> TBFParams:
        """Two-body function parameters.

        Maps the interaction strength to the Lieb-Liniger gamma, solves
        the transcendental local-energy matching condition at the cutoff
        ``rm`` with ``brentq``, and derives ``k2, beta, r_off, am``.
        """
        gn = self.interaction_strength
        nop = self.boson_number
        sc_size = self.supercell_size
        rm = self.tbf_contact_cutoff

        if not abs(rm) <= abs(sc_size / 2):
            raise ValueError("tbf_contact_cutoff (rm) lies outside its allowed range")

        if gn == 0:
            return TBFParams(sc_size, rm, param_k2=0.0, param_beta=0.0,
                             param_r_off=0.5 * sc_size, param_am=1.0)

        # Interaction energy -> Lieb gamma.
        lgm = 0.5 * (sc_size / nop) ** 2 * gn
        # Following equations use rm in simulation-box units.
        rm = rm / sc_size
        # One-dimensional scattering length (the factor 2 keeps
        # consistency with Lieb-Liniger theory).
        a1d = 2.0 / (lgm * nop)

        tan, sin, cos, pi = math.tan, math.sin, math.cos, math.pi

        def _nonlinear_equation(k2rm: float) -> float:
            if k2rm == 0:
                beta_rm = tan(pi * rm) / pi
            else:
                beta_rm = (k2rm / pi * (rm - k2rm * a1d * tan(k2rm))
                           * tan(pi * rm)
                           / (k2rm * a1d + rm * tan(k2rm)))
            # Equality of the local energy at ``rm``.
            return ((k2rm * sin(pi * rm)) ** 2
                    + (pi * beta_rm * cos(pi * rm)) ** 2
                    - pi ** 2 * beta_rm * rm)

        k2rm: float = brentq(_nonlinear_equation, 0, pi / 2)

        beta_rm = (k2rm / pi * (rm - k2rm * a1d * tan(k2rm)) * tan(pi * rm)
                   / (k2rm * a1d + rm * tan(k2rm)))

        k2 = k2rm / rm
        k2r_off = math.atan(1 / (k2 * a1d))
        beta = beta_rm / rm
        r_off = k2r_off / k2
        am = sin(pi * rm) ** beta / cos(k2rm - k2r_off)

        # Momentum and length returned in lattice-period units.
        return TBFParams(sc_size,
                         self.tbf_contact_cutoff,
                         param_k2=k2 / sc_size,
                         param_beta=beta,
                         param_r_off=r_off * sc_size,
                         param_am=am)

    @property
    def cfc_params(self) -> CFCParams:
        return CFCParams(self.params, self.obf_params, self.tbf_params)

    def evolve(self, **changes) -> "Spec":
        """A new spec with the given fields replaced."""
        return replace(self, **changes)


# ---------------------------------------------------------------------------
# Differentiable parameter solves.  The host-side ``Spec.tbf_params`` and
# ``Spec.obf_params`` go through ``scipy.optimize.brentq``, which blocks
# gradients; these solve the same conditions by fixed-count bisection in
# torch, and give the implicit-function-theorem derivative, so that the
# correlated-sampling variance differentiates with respect to ``rm`` and
# the trial orbital's depth (``phd_qmclib_torch.wf_opt.GradCSWFOptimizer``).
# Every argument may carry a leading batch shape: each element is solved
# on its own, elementwise.
# ---------------------------------------------------------------------------

def _bisect(fn, lo: torch.Tensor, hi: torch.Tensor,
            num_iters: int) -> torch.Tensor:
    """The midpoint of ``[lo, hi]`` after ``num_iters`` halvings that keep
    a sign change of ``fn`` inside."""
    f_lo = fn(lo)
    for _ in range(num_iters):
        mid = 0.5 * (lo + hi)
        f_mid = fn(mid)
        same = torch.sign(f_mid) == torch.sign(f_lo)
        lo, hi, f_lo = (torch.where(same, mid, lo), torch.where(same, hi, mid),
                        torch.where(same, f_mid, f_lo))
    return 0.5 * (lo + hi)


class _ImplicitRoot(torch.autograd.Function):
    """``x(theta)`` with ``residual(x, theta) = 0``, ``x`` and ``theta`` of
    one shape: bisection on ``[lo, hi]`` forward, and backward the
    implicit-function-theorem derivative ``dx/dtheta = -(dr/dtheta) /
    (dr/dx)`` at the root, both partials from ``torch.autograd.grad`` of
    the residual (the ``tangent_solve`` of the JAX package's
    ``lax.custom_root``)."""

    @staticmethod
    def forward(ctx, residual, lo, hi, num_iters, theta):
        root = _bisect(lambda x: residual(x, theta), lo, hi, num_iters)
        ctx.residual = residual
        ctx.save_for_backward(root, theta)
        return root

    @staticmethod
    def backward(ctx, grad_root):
        root, theta = ctx.saved_tensors
        with torch.enable_grad():
            x = root.detach().requires_grad_()
            th = theta.detach().requires_grad_()
            dr_dx, dr_dth = torch.autograd.grad(ctx.residual(x, th).sum(),
                                                (x, th))
        return None, None, None, None, -grad_root * dr_dth / dr_dx


def _tbf_matching_residual(k2rm, rm_frac, a1d):
    """Local-energy matching condition at the cutoff, in box units: the
    equation of ``Spec.tbf_params``, in torch ops."""
    pi = math.pi
    tan_k = torch.tan(k2rm)
    beta_rm = (k2rm / pi * (rm_frac - k2rm * a1d * tan_k)
               * torch.tan(pi * rm_frac)
               / (k2rm * a1d + rm_frac * tan_k))
    return ((k2rm * torch.sin(pi * rm_frac)) ** 2
            + (pi * beta_rm * torch.cos(pi * rm_frac)) ** 2
            - pi ** 2 * beta_rm * rm_frac)


def tbf_params_device(rm, interaction_strength, boson_number,
                      supercell_size) -> TBFParams:
    """Differentiable ``rm -> TBFParams`` in ``rm``'s dtype, on its
    device (a float becomes a float32 tensor).

    Bisection (100 halvings in float64, 40 in float32) solves the
    matching condition on ``(eps, pi/2 - eps)``, as the host ``brentq``
    of ``Spec.tbf_params`` does on ``(0, pi/2)``; the derivative is the
    implicit one (:class:`_ImplicitRoot`).  Needs
    ``interaction_strength > 0``.
    """
    rm = torch.as_tensor(rm)
    dtype, device = rm.dtype, rm.device
    gn = torch.as_tensor(interaction_strength, dtype=dtype, device=device)
    sc_size = torch.as_tensor(supercell_size, dtype=dtype, device=device)
    nop = boson_number

    pi = math.pi
    lgm = 0.5 * (sc_size / nop) ** 2 * gn
    rm_frac = rm / sc_size
    a1d = 2.0 / (lgm * nop)

    f64 = dtype == torch.float64
    eps = torch.full_like(rm_frac, 1e-9 if f64 else 1e-5)
    k2rm = _ImplicitRoot.apply(
        lambda x, frac: _tbf_matching_residual(x, frac, a1d),
        eps, pi / 2 - eps, 100 if f64 else 40, rm_frac)

    tan_k = torch.tan(k2rm)
    beta_rm = (k2rm / pi * (rm_frac - k2rm * a1d * tan_k)
               * torch.tan(pi * rm_frac)
               / (k2rm * a1d + rm_frac * tan_k))
    k2 = k2rm / rm_frac
    k2r_off = torch.arctan(1.0 / (k2 * a1d))
    beta = beta_rm / rm_frac
    r_off = k2r_off / k2
    am = torch.sin(pi * rm_frac) ** beta / torch.cos(k2rm - k2r_off)
    return TBFParams(sc_size, rm,
                     param_k2=k2 / sc_size,
                     param_beta=beta,
                     param_r_off=r_off * sc_size,
                     param_am=am)


def _kp_band_residual(ez, v0, rr_frac, inv_1pr):
    """KP band-bottom dispersion relation ``f(E; k = 0) = 0`` (the
    ``0 < E < v0`` branch of :func:`phd_qmclib_torch.ideal.energy_relation`),
    in torch ops."""
    root_e = torch.sqrt(ez)
    root_d = torch.sqrt(v0 - ez)
    return ((v0 - 2.0 * ez) / (2.0 * root_e * root_d)
            * torch.sinh(rr_frac * root_d) * torch.sin(root_e * inv_1pr)
            + torch.cosh(rr_frac * root_d) * torch.cos(root_e * inv_1pr)
            - 1.0)


def obf_params_device(obf_lattice_depth, spec: Spec) -> OBFParams:
    """Differentiable ``v0_orbital -> OBFParams`` in the depth's dtype,
    on its device.

    The band bottom ``e0(v0)`` solves by bisection (100 halvings in
    float64, 40 in float32) on ``(eps, 1 - eps) * min(v0, (1+r)^2 pi^2)``,
    as the host ``brentq`` of :func:`phd_qmclib_torch.ideal.eigen_energy`
    does; the derivative is the implicit one (:class:`_ImplicitRoot`).
    Needs a finite lattice.
    """
    v0 = torch.as_tensor(obf_lattice_depth)
    dtype, device = v0.dtype, v0.device
    r = spec.lattice_ratio
    rr_frac = torch.as_tensor(r / (1.0 + r), dtype=dtype, device=device)
    inv_1pr = torch.as_tensor(1.0 / (1.0 + r), dtype=dtype, device=device)

    f64 = dtype == torch.float64
    eps = torch.full_like(v0, 1e-12 if f64 else 1e-6)
    with torch.no_grad():
        upper = torch.minimum(v0, torch.as_tensor(
            (1.0 + r) ** 2 * math.pi ** 2, dtype=dtype, device=device))
    e0 = _ImplicitRoot.apply(
        lambda ez, depth: _kp_band_residual(ez, depth, rr_frac, inv_1pr),
        eps * upper, (1.0 - eps) * upper, 100 if f64 else 40, v0)

    def const(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return OBFParams(v0, const(r), const(spec.well_width),
                     const(spec.barrier_width),
                     param_e0=e0,
                     param_k1=torch.sqrt(e0),
                     param_kp1=torch.sqrt(v0 - e0))


def cfc_params_device(rm, spec: Spec, obf_lattice_depth=None) -> CFCParams:
    """``CFCParams`` with the variational cutoff ``rm`` (and, given
    ``obf_lattice_depth``, the trial orbital's depth) live, in ``rm``'s
    dtype on its device: the two-body parameters always re-solved by
    :func:`tbf_params_device`, the one-body ones by
    :func:`obf_params_device` when a depth is given, else the host spec's.
    """
    rm = torch.as_tensor(rm)
    dtype, device = rm.dtype, rm.device

    def cast(group):
        return type(group)(*(torch.as_tensor(x, dtype=dtype, device=device)
                             for x in group))

    model_params = cast(spec.params)._replace(tbf_contact_cutoff=rm)
    if obf_lattice_depth is None:
        obf = cast(spec.obf_params)
    else:
        obf = obf_params_device(
            torch.as_tensor(obf_lattice_depth, dtype=dtype, device=device),
            spec)
    tbf = tbf_params_device(rm, spec.interaction_strength,
                            spec.boson_number, spec.supercell_size)
    return CFCParams(model_params, obf, tbf)


def cfc_params_from_numpy(cfc) -> CFCParams:
    """The port's ``CFCParams`` (float leaves) from the JAX package's
    ``spec.cfc_params``, or from any object with the same field names
    whose leaves are floats or numpy scalars/arrays."""
    groups = ((ModelParams, cfc.model_params), (OBFParams, cfc.obf_params),
              (TBFParams, cfc.tbf_params))
    return CFCParams(*(
        cls(*(float(np.asarray(getattr(src, name)))
              for name in cls._fields))
        for cls, src in groups))


def cast_params(cfc: CFCParams, dtype: torch.dtype,
                device) -> CFCParams:
    """``cfc`` with every leaf a 0-d tensor of ``dtype`` on ``device``.

    Leaves that already are such tensors pass through untouched, so a
    sampler casts once and the per-step calls copy nothing to the
    device."""
    def cast(group):
        return type(group)(*(torch.as_tensor(x, dtype=dtype, device=device)
                             for x in group))

    return CFCParams(*(cast(group) for group in cfc))


# ---------------------------------------------------------------------------
# Analytic functions, vectorized over ``z``/``rz``; the parameter leaves
# are 0-d tensors (see :func:`cast_params`).
# ---------------------------------------------------------------------------

def _one_body(z, cfc: CFCParams):
    """Piecewise KP band-bottom orbital."""
    obf = cfc.obf_params
    v0, e0 = obf.lattice_depth, obf.param_e0
    k1, kp1 = obf.param_k1, obf.param_kp1
    z_a, z_b = obf.well_width, obf.barrier_width
    z_cell = torch.remainder(z, 1.0)
    barrier = torch.cosh(kp1 * (z_cell - 1.0 + 0.5 * z_b))
    cf = torch.sqrt(1 + v0 / e0
                    * torch.sinh(0.5 * torch.sqrt(v0 - e0) * z_b) ** 2)
    well = cf * torch.cos(k1 * (z_cell - 0.5 * z_a))
    return torch.where(z_a < z_cell, barrier, well)


def _one_body_log_dz(z, cfc: CFCParams):
    """``f1'/f1``."""
    obf = cfc.obf_params
    k1, kp1 = obf.param_k1, obf.param_kp1
    z_a, z_b = obf.well_width, obf.barrier_width
    z_cell = torch.remainder(z, 1.0)
    barrier = kp1 * torch.tanh(kp1 * (z_cell - 1.0 + 0.5 * z_b))
    well = -k1 * torch.tan(k1 * (z_cell - 0.5 * z_a))
    return torch.where(z_a < z_cell, barrier, well)


def _one_body_log_dz2(z, cfc: CFCParams):
    """``f1''/f1``: ``v0 - e0`` in barriers, ``-e0`` in wells."""
    obf = cfc.obf_params
    v0, e0 = obf.lattice_depth, obf.param_e0
    z_cell = torch.remainder(z, 1.0)
    return torch.where(obf.well_width < z_cell, v0 - e0, -e0)


def _two_body_pair_terms(rz, cfc: CFCParams, need_log: bool = True,
                         need_derivs: bool = True,
                         need_kin: bool = False):
    """Fused ``(log|f2|, f2'/f2, f2''/f2)`` with one sin/cos (or one
    rational tan in the f32 forward path) per pair.

    With ``need_kin`` the third slot is the per-pair kinetic term
    ``-f2''/f2 + (f2'/f2)^2 = C (1 + v^2)``, with ``v`` the tan inside
    the cutoff and the cot outside, and one branch-selected constant
    ``C``.  The argument never leaves ``(-pi/2, pi/2]``: inside,
    ``|k2(r - r_off)| < k2 rm < pi/2``; outside, ``pi r/L`` with ``r``
    in ``[rm, L/2]``.
    """
    tbf = cfc.tbf_params
    sc_size, rm = tbf.supercell_size, tbf.tbf_contact_cutoff
    k2, beta = tbf.param_k2, tbf.param_beta
    r_off, am = tbf.param_r_off, tbf.param_am

    in_cut = rz < rm.abs()
    arg_a = torch.where(in_cut, k2, math.pi / sc_size)
    arg_b = torch.where(in_cut, -k2 * r_off, 0.0)
    arg = arg_a * rz + arg_b
    one = torch.ones_like(rz)
    pref = math.pi / sc_size

    if need_derivs and not need_log:
        # Forward path (the DMC hot loop): only the ratio of the trig
        # factors is needed, so f32 takes the rational tan; f64 keeps
        # the library sin/cos.
        if rz.dtype == torch.float32:
            s, c = trig.tancot_poly32(arg)
        else:
            s, c = torch.sin(arg), torch.cos(arg)
        v = torch.where(in_cut, s, c) / torch.where(in_cut, c, s)
        ldz = torch.where(in_cut, -k2, pref * beta) * v
        if need_kin:
            kin_c = torch.where(in_cut, k2 * k2 * one,
                                pref ** 2 * beta * one)
            return None, ldz, kin_c * (1.0 + v * v)
        ldz2 = torch.where(in_cut, -k2 * k2 * one,
                           pref ** 2 * beta * ((beta - 1) * v * v - 1))
        return None, ldz, ldz2

    if rz.dtype == torch.float32:
        s, c = trig.sincos_poly32(arg)
    else:
        s, c = torch.sin(arg), torch.cos(arg)

    # Branch-local safe views: the unselected branch never divides by
    # zero or takes the log of a non-positive number.
    s_o = torch.where(in_cut, one, s)
    c_o = torch.where(in_cut, one, c)
    s_i = torch.where(in_cut, s, torch.zeros_like(rz))
    c_i = torch.where(in_cut, c, one)

    ldz = ldz2 = log_f2 = None
    if need_derivs:
        v = torch.where(in_cut, s_i, c_o) / torch.where(in_cut, c_i, s_o)
        ldz = torch.where(in_cut, -k2, pref * beta) * v
        if need_kin:
            kin_c = torch.where(in_cut, k2 * k2 * one,
                                pref ** 2 * beta * one)
            ldz2 = kin_c * (1.0 + v * v)
        else:
            ldz2 = torch.where(in_cut, -k2 * k2 * one,
                               pref ** 2 * beta
                               * ((beta - 1) * v * v - 1))
    if need_log:
        # One log per pair: inside x = |am| cos, p = 1; outside
        # x = sin, p = beta.
        x = torch.where(in_cut, am.abs() * c_i, s_o)
        p = torch.where(in_cut, one, beta)
        log_f2 = p * torch.log(x)
    return log_f2, ldz, ldz2


def _make_potential(defects_sep: int):
    def _potential(z, cfc: CFCParams):
        """External KP potential with periodic defects."""
        mp = cfc.model_params
        v0, v0d = mp.lattice_depth, mp.defect_magnitude
        n_cell = torch.floor(z)
        in_barrier = mp.well_width < z - n_cell
        if defects_sep == 1:
            # Every site is a "defect" (regular lattice has v0d == v0).
            barrier_v = v0d * torch.ones_like(z)
        else:
            on_defect = torch.remainder(n_cell, defects_sep) == 0
            barrier_v = torch.where(on_defect, v0d, v0)
        return torch.where(in_barrier, barrier_v, torch.zeros_like(z))

    return _potential


def core_funcs(spec_or_static) -> "jastrow.SimpleNamespace":
    """The mrbp function namespace for a spec (or a StaticSpec).

    The functions take ``(pos, cfc)`` with ``pos`` of shape ``(..., N)``
    and ``cfc`` a :class:`CFCParams` whose leaves are floats or 0-d
    tensors; the estimator functions take a leading argument (the S(k)
    mode count, the OBDM offsets, the g2 bin count).
    ``energy_and_drift`` and ``log_psi_and_energy`` run through
    :func:`phd_qmclib_torch.ops.pairwise.energy_and_drift` (the forward
    and the log|psi| variant) and
    ``pair_dist_histogram`` through
    :func:`phd_qmclib_torch.ops.histogram.walker_histogram`: the CUDA
    kernels on a CUDA tensor, their plain torch versions on a CPU one.
    ``one_body_density_grid`` launches
    :func:`phd_qmclib_torch.ops.pairwise.obd_grid` on a CUDA tensor (one
    launch an evaluation, a fused sweep's rows included) and runs
    :mod:`.jastrow`'s plain version, kept as
    ``one_body_density_grid_plain``, on a CPU tensor.
    ``fourier_density_parts_harmonics`` and
    ``fourier_density_reim_harmonics`` launch
    :func:`phd_qmclib_torch.ops.ssf.ssf_harmonics` on a CUDA tensor (one
    launch an evaluation, a fused sweep's rows included; the pair is
    slots 1-2 of the parts) and run :mod:`.jastrow`'s plain recurrence,
    kept as ``fourier_density_parts_harmonics_plain``, on a CPU tensor.
    Where a gradient with respect to the parameters is wanted (grad mode
    on and ``params`` requiring grad) on a CUDA tensor,
    ``log_psi_and_energy`` runs through
    :class:`phd_qmclib_torch.ops.pairwise.LogPsiAndEnergy` (the kernel
    forward, its parameter VJP kernel backward); on a CPU tensor autograd
    runs through the plain version.
    The first two take an optional third argument, and
    ``one_body_density_grid`` an optional fourth, the kernel's parameter
    vector ``pairwise.pack_params(cfc)`` (or a fused sweep's table of
    rows) in ``pos``' dtype on its device: the samplers pack it once per
    run, since packing costs more host time per call than the kernel's
    launch.  The plain versions on a CPU tensor take no notice of it.
    """
    static = (spec_or_static.static_spec
              if isinstance(spec_or_static, Spec) else spec_or_static)
    return _core_funcs_cached(static)


@functools.lru_cache(maxsize=64)
def _core_funcs_cached(static: StaticSpec) -> "jastrow.SimpleNamespace":
    """One namespace per model structure; the continuous parameters
    travel as arguments."""
    funcs = jastrow.build_core_funcs(
        one_body=_one_body,
        one_body_log_dz=_one_body_log_dz,
        one_body_log_dz2=_one_body_log_dz2,
        two_body_pair_terms=_two_body_pair_terms,
        potential=_make_potential(static.defects_sep),
        is_free=static.is_free,
        is_ideal=static.is_ideal,
        boson_number=static.boson_number,
    )
    nop = static.boson_number
    kernel_kw = dict(nop=nop, is_free=static.is_free,
                     is_ideal=static.is_ideal,
                     defects_sep=static.defects_sep)

    def energy_and_drift(pos, cfc, params=None):
        if params is None:
            params = pairwise.pack_params(cfc, pos.dtype, pos.device)
        energy, drift = pairwise.energy_and_drift(
            pos.reshape(-1, nop).contiguous(), params, **kernel_kw)
        return energy.reshape(pos.shape[:-1]), drift.reshape(pos.shape)

    def log_psi_and_energy(pos, cfc, params=None):
        if params is None:
            params = pairwise.pack_params(cfc, pos.dtype, pos.device)
        flat = pos.reshape(-1, nop).contiguous()
        if (pos.device.type != "cpu" and params.requires_grad
                and torch.is_grad_enabled()):
            log_psi, energy = pairwise.LogPsiAndEnergy.apply(
                flat, params, kernel_kw)
        else:
            log_psi, energy, _ = pairwise.energy_and_drift(
                flat, params, with_log_psi=True, **kernel_kw)
        return (log_psi.reshape(pos.shape[:-1]),
                energy.reshape(pos.shape[:-1]))

    def with_cast(fn):
        @functools.wraps(fn)
        def wrapped(*args):
            *lead, pos, cfc = args
            return fn(*lead, pos, cast_params(cfc, pos.dtype, pos.device))
        return wrapped

    for name in ("log_psi", "drift", "wf_abs", "delta_log_psi_move",
                 "delta_drift_move", "one_body_density",
                 "one_body_density_grid", "fourier_density_parts_harmonics",
                 "pair_dist_histogram"):
        setattr(funcs, name, with_cast(getattr(funcs, name)))
    obd_plain = funcs.one_body_density_grid
    obd_kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal)

    @functools.wraps(obd_plain)
    def one_body_density_grid(szs, pos, cfc, params=None):
        if pos.device.type == "cpu":
            return obd_plain(szs, pos, cfc)
        with tracing.span(tracing.OBD):
            if params is None:
                params = pairwise.pack_params(
                    cast_params(cfc, pos.dtype, pos.device), pos.dtype,
                    pos.device)
            params, offsets = _obd_tables(szs, params, pos.dtype, pos.device)
            out = pairwise.obd_grid(offsets, pos.reshape(-1, nop).contiguous(),
                                    params, **obd_kw)
            return out.reshape(pos.shape[:-1] + out.shape[-1:])

    funcs.one_body_density_grid = one_body_density_grid
    funcs.one_body_density_grid_plain = obd_plain

    ssf_plain = funcs.fourier_density_parts_harmonics
    reim_plain = funcs.fourier_density_reim_harmonics

    def ssf_launch(num_modes, pos, cfc):
        sc = torch.as_tensor(cfc.model_params.supercell_size,
                             dtype=pos.dtype, device=pos.device)
        out = ssf.ssf_harmonics(pos.reshape(-1, nop).contiguous(),
                                _ssf_lengths(sc, pos), num_modes=num_modes)
        return out.reshape(pos.shape[:-1] + out.shape[-2:])

    @functools.wraps(ssf_plain)
    def fourier_density_parts_harmonics(num_modes, pos, cfc):
        if pos.device.type == "cpu":
            return ssf_plain(num_modes, pos, cfc)
        with tracing.span(tracing.SSF):
            return ssf_launch(num_modes, pos, cfc)

    @functools.wraps(reim_plain)
    def fourier_density_reim_harmonics(num_modes, pos, cfc):
        if pos.device.type == "cpu":
            return reim_plain(num_modes, pos, cfc)
        return ssf_launch(num_modes, pos, cfc)[..., 1:3]

    funcs.fourier_density_parts_harmonics = fourier_density_parts_harmonics
    funcs.fourier_density_parts_harmonics_plain = ssf_plain
    funcs.fourier_density_reim_harmonics = fourier_density_reim_harmonics
    funcs.energy_and_drift = energy_and_drift
    funcs.log_psi_and_energy = log_psi_and_energy
    funcs.energy = lambda pos, cfc: energy_and_drift(pos, cfc)[0]
    funcs.static_spec = static
    return funcs


def _ssf_lengths(sc: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The S(k) kernel's ``(R,)`` table of supercell sizes from ``sc``: a
    0-d tensor (one row), or a fused sweep's ``(R, 1, ..., 1)`` beside
    positions ``(R, ..., N)`` of as many axes (a view: no launch)."""
    if sc.dim() and (sc.dim() != pos.dim() or sc.shape[0] != pos.shape[0]
                     or sc.numel() != sc.shape[0]):
        raise ValueError(f"a supercell table of shape {tuple(sc.shape)} "
                         f"does not give rows to positions of shape "
                         f"{tuple(pos.shape)}")
    return sc.reshape(-1)


def _obd_tables(szs, params: torch.Tensor, dtype: torch.dtype, device):
    """The OBDM kernel's ``(params, offsets)`` for the grid ``szs``
    (``(M,)``, or a fused sweep's ``(M, R, 1, 1)``) and the packed
    parameters ``params`` (:func:`pairwise.pack_params`' vector, or a
    sweep's ``(R, 1, 1, PARAMS_SIZE)`` or ``(R, PARAMS_SIZE)``): the
    vector and ``(M,)`` for one row, else an ``(R, PARAMS_SIZE)`` table
    and ``(R, M)``, a row shared by every row repeated."""
    params = params.reshape(-1, pairwise.PARAMS_SIZE)
    offsets = torch.as_tensor(szs, dtype=dtype, device=device)
    offsets = offsets.reshape(offsets.shape[0], -1).T
    rows = max(params.shape[0], offsets.shape[0])
    if rows == 1:
        return params[0].contiguous(), offsets[0].contiguous()
    return (params.expand(rows, -1).contiguous(),
            offsets.expand(rows, -1).contiguous())


@dataclass(frozen=True)
class PhysicalFuncs:
    """Batch evaluation of the main physical properties for a model
    spec: binds the spec's parameters to the functions of
    :func:`core_funcs`.

    Inputs may be single configurations ``(N,)``, packed ``(2, N)``
    buffers, or batches with leading axes, as arrays or tensors.  An
    array goes to ``device``; a tensor stays where it is.  The results
    are tensors on the input's device.
    """
    spec: Spec
    device: t.Union[str, torch.device] = "cuda"

    @classmethod
    def from_model_spec(cls, model_spec: Spec,
                        device="cuda") -> "PhysicalFuncs":
        return cls(model_spec, device)

    @cached_property
    def _funcs(self):
        return core_funcs(self.spec)

    @cached_property
    def _cfc(self):
        return self.spec.cfc_params

    def _pos(self, sys_conf):
        if not isinstance(sys_conf, torch.Tensor):
            sys_conf = torch.as_tensor(np.asarray(sys_conf),
                                       device=self.device)
        nop = self.spec.boson_number
        if sys_conf.dim() >= 2 and sys_conf.shape[-2] == 2 \
                and sys_conf.shape[-1] == nop:
            return sys_conf[..., SysConfSlot.pos, :]
        return sys_conf

    def wf_abs_log(self, sys_conf):
        return self._funcs.log_psi(self._pos(sys_conf), self._cfc)

    def energy(self, sys_conf):
        return self._funcs.energy(self._pos(sys_conf), self._cfc)

    def drift(self, sys_conf):
        return self._funcs.drift(self._pos(sys_conf), self._cfc)

    def one_body_density(self, sz, sys_conf):
        return self._funcs.one_body_density(sz, self._pos(sys_conf),
                                            self._cfc)

    def fourier_density(self, kz_set, sys_conf):
        pos = self._pos(sys_conf)
        kz = torch.as_tensor(np.asarray(kz_set), dtype=pos.dtype,
                             device=pos.device)
        return self._funcs.fourier_density(kz, pos, self._cfc)


def recast(z, cfc: CFCParams):
    """Wrap positions into the supercell ``[0, L)``."""
    sc_size = cfc.model_params.supercell_size
    return recast_to_supercell(z, 0.0, sc_size)
