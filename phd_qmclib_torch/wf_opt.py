"""Trial-wavefunction optimization by correlated-sampling variance
minimization.

Counterpart of ``phd_qmclib_tpu.wf_opt``, after the upstream library's
optimizer: a fixed set of configurations sampled from the initial trial
wavefunction is reweighted by ``exp(2 (ln psi_new - ln psi_ini))`` for
each candidate variational parameter, and the weighted variance of the
local energy is minimized.

* :class:`CSWFOptimizer`: ``scipy.optimize.differential_evolution`` over
  the host spec's parameters; each evaluation is one launch of K1's
  log|psi| variant over the whole configuration set.
* :class:`GradCSWFOptimizer`: a grid over the bounds (all grid points
  solved in one batched call of :func:`~phd_qmclib_torch.models.mrbp.
  cfc_params_device`, then K1 log once per point), then L-BFGS-B with
  the exact gradient: the parameter solves differentiate implicitly and
  K1 log backward is its parameter VJP kernel
  (:class:`~phd_qmclib_torch.ops.pairwise.LogPsiAndEnergy`).
* :class:`WFOptProc`: the last ``num_sys_confs`` configurations of a VMC
  sampling into one of them.

The configurations and the initial log|psi| may be numpy arrays or
tensors; they go to ``device`` (the card unless ``"cpu"`` is asked for)
in their own dtype, and the evaluations run there.
"""
import typing as t
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch
from scipy.optimize import differential_evolution, minimize

from .models import mrbp
from .ops import pairwise
from .qmc_exec.logging import exec_logger

__all__ = ["CSWFOptimizer", "GradCSWFOptimizer", "WFOptProc",
           "weighed_variance"]


def weighed_variance(weights_log_set: np.ndarray,
                     energy_set: np.ndarray) -> float:
    """Weighted variance of the local energy."""
    rel_weights = np.exp(weights_log_set - weights_log_set.max())
    weight_sum = rel_weights.sum()
    ref_energy = (rel_weights * energy_set).sum() / weight_sum
    e_diff = rel_weights * (energy_set - ref_energy) ** 2
    return float(e_diff.sum() / weight_sum)


def _weighed_variance_torch(wlog: torch.Tensor,
                            energy: torch.Tensor) -> torch.Tensor:
    """:func:`weighed_variance` in torch ops (differentiable)."""
    rel_w = torch.exp(wlog - wlog.max())
    w_sum = rel_w.sum()
    e_ref = (rel_w * energy).sum() / w_sum
    return (rel_w * (energy - e_ref) ** 2).sum() / w_sum


def _on_device(values, device) -> torch.Tensor:
    """``values`` (an array or a tensor) on ``device``, in its dtype."""
    if isinstance(values, torch.Tensor):
        return values.to(device)
    return torch.tensor(np.asarray(values), device=device)


@dataclass(frozen=True)
class CSWFOptimizer:
    """Correlated-sampling optimizer of ``tbf_contact_cutoff`` by
    differential evolution."""

    #: The spec of the model.
    spec: mrbp.Spec
    #: The system configurations used for the minimization process:
    #: ``(M, N)`` positions or ``(M, 2, N)`` packed buffers.
    sys_conf_set: t.Any
    #: The initial wavefunction values (to calculate the weights).
    ini_wf_abs_log_set: t.Any
    #: Reference energy (unused by the variance functional, kept for API
    #: parity with the upstream library).
    ref_energy: t.Optional[float] = None
    #: Display log messages.
    verbose: bool = False
    #: Jointly optimize the trial orbital's lattice depth
    #: (``Spec.obf_lattice_depth``) alongside ``rm``.  Needs a finite
    #: lattice.
    opt_obf_lattice_depth: bool = False
    #: Where the evaluations run.
    device: t.Union[str, torch.device] = "cuda"

    def __post_init__(self):
        pos = _on_device(self.sys_conf_set, self.device)
        nop = self.spec.boson_number
        if pos.dim() == 3 and pos.shape[-2] == 2:
            pos = pos[:, mrbp.SysConfSlot.pos, :]
        if pos.shape[-1] != nop:
            raise ValueError("sys_conf_set does not match the model's "
                             "configuration layout")
        object.__setattr__(self, "sys_conf_set", pos.contiguous())
        object.__setattr__(self, "ini_wf_abs_log_set",
                           _on_device(self.ini_wf_abs_log_set, self.device))

    @cached_property
    def _funcs(self):
        return mrbp.core_funcs(self.spec)

    @cached_property
    def _ini_log_f64(self) -> np.ndarray:
        return np.asarray(self.ini_wf_abs_log_set.cpu(), dtype=np.float64)

    def update_spec(self, tbf_contact_cutoff: float,
                    obf_lattice_depth: t.Optional[float] = None) \
            -> mrbp.Spec:
        """The model spec with updated variational parameter(s)."""
        changes = {"tbf_contact_cutoff": float(tbf_contact_cutoff)}
        if obf_lattice_depth is not None:
            changes["obf_lattice_depth"] = float(obf_lattice_depth)
        return self.spec.evolve(**changes)

    def wf_abs_log_and_energy_set(self, cfc_params: mrbp.CFCParams):
        """log|psi| and the local energy of every configuration, as
        float64 arrays."""
        pos = self.sys_conf_set
        with torch.no_grad():
            lp, e = self._funcs.log_psi_and_energy(pos, cfc_params)
        return (np.asarray(lp.cpu(), dtype=np.float64),
                np.asarray(e.cpu(), dtype=np.float64))

    def principal_function(self, params) -> float:
        """The weighted variance as a function of the variational
        parameter vector, ``[rm]`` or ``[rm, obf_lattice_depth]``."""
        params = np.atleast_1d(np.asarray(params, dtype=np.float64))
        v0b = float(params[1]) if params.size > 1 else None
        upd_spec = self.update_spec(float(params[0]), v0b)
        wf_abs_log_set, energies_set = \
            self.wf_abs_log_and_energy_set(upd_spec.cfc_params)
        weights_log_set = 2 * (wf_abs_log_set - self._ini_log_f64)
        return weighed_variance(weights_log_set, energies_set)

    @property
    def principal_function_bounds(self):
        """Variational-parameter bounds; with the joint-orbital mode a
        second row bounds the trial depth to ``(v0/8, 4 v0)`` around the
        physical one."""
        sc_size = self.spec.supercell_size
        bounds = [(5e-2, (0.5 - 5e-3) * sc_size)]
        if self.opt_obf_lattice_depth:
            if self.spec.is_free:
                raise ValueError(
                    "opt_obf_lattice_depth needs a finite lattice "
                    "(the free-gas trial orbital is flat)")
            v0 = self.spec.lattice_depth
            bounds.append((v0 / 8.0, 4.0 * v0))
        return bounds

    def exec(self) -> mrbp.Spec:
        """Run the variance minimization; returns the spec evolved with
        the optimal variational parameter(s)."""
        opt_params = differential_evolution(
            self.principal_function,
            bounds=self.principal_function_bounds,
            disp=self.verbose, seed=1)
        opt_rm = float(opt_params.x[0])
        opt_v0b = float(opt_params.x[1]) \
            if self.opt_obf_lattice_depth else None
        if self.verbose:
            extra = (f", orbital v0 = {opt_v0b:.6G}"
                     if opt_v0b is not None else "")
            exec_logger.info(f"optimal rm = {opt_rm:.6G}{extra} "
                             f"(variance {opt_params.fun:.6G}, "
                             f"{opt_params.nfev} evaluations)")
        return self.update_spec(opt_rm, opt_v0b)


@dataclass(frozen=True)
class GradCSWFOptimizer(CSWFOptimizer):
    """Gradient-based correlated-sampling optimizer.

    Differentiates the variance through the parameter solves
    (:func:`~phd_qmclib_torch.models.mrbp.cfc_params_device`) and, on
    the card, through K1 log's parameter VJP kernel.  Strategy: the
    variance on a ``num_grid`` grid over the bounds (``num_grid`` x 16
    when joint), then L-BFGS-B with the analytic gradient from the best
    grid point.
    """

    #: Grid resolution of the global scan stage.
    num_grid: int = 64

    @cached_property
    def _ini_log(self) -> torch.Tensor:
        return self.ini_wf_abs_log_set.to(self.sys_conf_set.dtype)

    def _variance_of_packed(self, params: torch.Tensor) -> torch.Tensor:
        """The weighted variance at the packed parameter vector."""
        lp, energy = self._funcs.log_psi_and_energy(self.sys_conf_set, None,
                                                    params)
        return _weighed_variance_torch(2.0 * (lp - self._ini_log), energy)

    def _packed(self, params: torch.Tensor) -> torch.Tensor:
        """The kernels' parameter vector(s) at ``[..., rm]`` or ``[...,
        rm, orbital v0]``, solved on the device in ``params``' dtype."""
        cfc = mrbp.cfc_params_device(
            params[..., 0], self.spec,
            obf_lattice_depth=(params[..., 1] if self.opt_obf_lattice_depth
                               else None))
        return pairwise.pack_params(cfc, params.dtype, params.device)

    def _variance_fn(self, params) -> torch.Tensor:
        """``params -> weighted variance`` (a 0-d tensor, differentiable in
        ``params``; a bare rm or the parameter vector)."""
        pos = self.sys_conf_set
        params = torch.atleast_1d(torch.as_tensor(params, dtype=pos.dtype,
                                                  device=pos.device))
        return self._variance_of_packed(self._packed(params))

    def _grid_values(self, grid) -> np.ndarray:
        """The variance at every row of ``grid`` ``(B, P)``: the parameter
        solves of all rows in one batched call, then K1 log once per
        row."""
        pos = self.sys_conf_set
        grid = torch.as_tensor(grid, dtype=pos.dtype, device=pos.device)
        with torch.no_grad():
            packed = self._packed(grid)
            values = torch.stack([self._variance_of_packed(row)
                                  for row in packed])
        return np.asarray(values.cpu(), dtype=np.float64)

    def _value_and_grad_fn(self, params):
        """``(variance, d variance / d params)`` as 0-d and ``(P,)``
        tensors."""
        pos = self.sys_conf_set
        params = torch.as_tensor(params, dtype=pos.dtype,
                                 device=pos.device).detach()
        params.requires_grad_(True)
        value = self._variance_fn(params)
        grad, = torch.autograd.grad(value, params)
        return value.detach(), grad

    def exec(self) -> mrbp.Spec:
        """Grid scan + gradient polish; returns the evolved spec."""
        if self.spec.interaction_strength <= 0:
            # The device solve needs gn > 0; the free gas has no
            # two-body parameter to optimize anyway.
            return super().exec()
        bounds = self.principal_function_bounds
        dtype = self.sys_conf_set.dtype
        axes = [torch.linspace(*bounds[0], self.num_grid, dtype=dtype)]
        if len(bounds) > 1:
            # The rm axis keeps the full 1-D resolution (its bounds span
            # half the box); the orbital-depth axis is smooth and
            # unimodal around the physical depth, so 16 points suffice.
            axes.append(torch.linspace(*bounds[1], 16, dtype=dtype))
        grid = torch.stack([g.ravel() for g in
                            torch.meshgrid(*axes, indexing="ij")], dim=-1)
        values = self._grid_values(grid)
        best = int(np.nanargmin(values))
        x0 = np.asarray(grid[best], dtype=np.float64)
        if self.verbose:
            exec_logger.info(f"grid stage: x0 = {x0} "
                             f"(variance {values[best]:.6G})")

        def fun_and_jac(x):
            v, g = self._value_and_grad_fn(x)
            return float(v), np.asarray(g.cpu(), dtype=np.float64)

        res = minimize(fun_and_jac, x0, jac=True,
                       method="L-BFGS-B", bounds=bounds)
        opt_rm = float(res.x[0])
        opt_v0b = float(res.x[1]) if len(bounds) > 1 else None
        if self.verbose:
            extra = (f", orbital v0 = {opt_v0b:.6G}"
                     if opt_v0b is not None else "")
            exec_logger.info(f"optimal rm = {opt_rm:.6G}{extra} "
                             f"(variance {res.fun:.6G}, "
                             f"{res.nfev} grad evals)")
        return self.update_spec(opt_rm, opt_v0b)


@dataclass(frozen=True)
class WFOptProc:
    """Wavefunction-optimization procedure: feeds the last
    ``num_sys_confs`` configurations of a VMC sampling into the
    correlated-sampling optimizer."""

    #: Number of configurations from the sampling to use.
    num_sys_confs: int = 128
    #: The energy of reference to minimize the variance.
    ref_energy: t.Optional[float] = None
    verbose: bool = False
    #: ``"de"`` = differential evolution (the upstream library's),
    #: ``"grad"`` = grid scan + implicit-differentiation L-BFGS polish.
    method: str = "de"
    #: Jointly optimize the trial-orbital lattice depth alongside ``rm``.
    opt_obf_lattice_depth: bool = False

    def exec(self, model_spec: mrbp.Spec, sys_conf_set,
             ini_wf_abs_log_set, device="cuda") -> mrbp.Spec:
        """Optimize on ``device``; the configurations and log|psi| may be
        arrays or tensors."""
        num = self.num_sys_confs
        if self.method not in ("de", "grad"):
            raise ValueError(f"unknown wf-opt method {self.method!r}")
        cls = GradCSWFOptimizer if self.method == "grad" else CSWFOptimizer
        optimizer = cls(model_spec, sys_conf_set[-num:],
                        ini_wf_abs_log_set[-num:], self.ref_energy,
                        self.verbose,
                        opt_obf_lattice_depth=self.opt_obf_lattice_depth,
                        device=device)
        return optimizer.exec()
