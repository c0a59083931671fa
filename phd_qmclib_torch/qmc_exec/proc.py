"""Abstract QMC procedure lifecycle.

Copy of ``phd_qmclib_tpu.qmc_exec.proc``, after the upstream library's
``qmc_exec/proc.py``.  That library splits a model-agnostic layer (L4) from concrete mrbp bindings (L5,
``mrbp_qmc/{vmc,dmc}_exec``); here both collapse into
``qmc_exec.{vmc,dmc}`` because the genericity already lives in the
model-kernel factory (``models/jastrow.py``) - there is no numba
indirection to hide behind an extra layer.
"""
import typing as t
from abc import ABCMeta, abstractmethod
from dataclasses import dataclass

__all__ = [
    "DensityEstSpec",
    "ModelSysConfSpec",
    "Proc",
    "ProcInput",
    "ProcInputError",
    "ProcResult",
    "SSFEstSpec",
]

#: Type tag for model-generated inputs (reference
#: ``mrbp_qmc/dmc_exec/proc.py:20``).
MODEL_SYS_CONF_TYPE = "MODEL_SYS_CONF"


@dataclass(frozen=True)
class ModelSysConfSpec:
    """Spec to build fresh inputs from model configurations
    (``qmc_exec/proc.py:17-24``)."""
    dist_type: str = "RANDOM"
    num_sys_conf: t.Optional[int] = None
    type: str = MODEL_SYS_CONF_TYPE

    @classmethod
    def from_config(cls, config: t.Mapping):
        return cls(**dict(config))


@dataclass(frozen=True)
class DensityEstSpec:
    """Density estimator config (``mrbp_qmc/dmc_exec/proc.py:70-79``).

    ``pfw_num_time_steps``: pure-estimator forward-walking window in
    time steps, up to one block; ``None`` uses a whole block.  The
    reference silently discards this key and always pins the window to
    one block (``mrbp_qmc/dmc_exec/proc.py:274, 337``) — but longer
    windows within the block budget measurably reduce the residual
    mixed-estimator bias (the Tonks-Girardeau S(k) study of
    ``BASELINE.md``), so it is a real knob here.
    """
    num_bins: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None


@dataclass(frozen=True)
class SSFEstSpec:
    """S(k) estimator config (``mrbp_qmc/dmc_exec/proc.py:82-91``).
    See :class:`DensityEstSpec` for ``pfw_num_time_steps``."""
    num_modes: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None


@dataclass(frozen=True)
class OBDEstSpec:
    """One-body density matrix estimator config (beyond the reference,
    which stubs the OBDM machinery out - ``qmc_base/vmc.py:444-450``).
    See :class:`DensityEstSpec` for ``pfw_num_time_steps``.

    ``est_every_mult`` evaluates the ``num_pos``-offset grid only every
    ``est_every * est_every_mult``-th step: the grid costs ``num_pos``
    shifted pair passes — tens of whole QMC steps — while the OBDM
    samples it yields are strongly correlated, so a sparse OBDM cadence
    recovers nearly all of the cost at negligible statistical price.
    The dynamics and the other estimators are bit-identical for any
    value."""
    num_pos: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None
    est_every_mult: int = 1


@dataclass(frozen=True)
class PairCorrEstSpec:
    """Direct pair-correlation ``g2(r)`` estimator config: a histogram
    of unordered-pair minimum-image distances on ``num_bins`` uniform
    bins over ``[0, L/2]``.  Beyond the reference, which has no direct
    pair-correlation estimator (there g2 is only reachable by
    Fourier-inverting the truncated S(k)).

    See :class:`DensityEstSpec` for ``pfw_num_time_steps`` and
    :class:`OBDEstSpec` for ``est_every_mult`` (the binning pass costs
    about one extra O(N^2) pairwise pass per measured step).
    ``as_pure_est``/``pfw_num_time_steps`` apply to DMC only.
    """
    num_bins: int
    as_pure_est: bool = True
    pfw_num_time_steps: t.Optional[int] = None
    est_every_mult: int = 1


@dataclass(frozen=True)
class ITCEstSpec:
    """Imaginary-time density-density correlation (intermediate
    scattering function) ``F(k, tau)`` estimator config — DMC only
    (VMC chain steps are Metropolis updates, not imaginary-time
    evolution, so the two-time correlator has no meaning there).  No
    reference analog.

    ``num_lags`` sets the ring-buffer depth and ``est_every_mult``
    (OBDM-style cadence multiplier) the lag spacing: lags reach
    ``num_lags * est_every * est_every_mult * time_step`` in
    imaginary time, so the multiplier buys deep tau at FIXED buffer
    memory and per-step transport cost.

    ``as_pure_est=True`` forward-walks the two-time products through
    the branching ancestry (descendant weighting — in the long-
    projection limit both insertions become interior and the
    amplitudes lose their ``O(psi_T - phi_0)`` trial bias); the
    default stays the mixed estimator, whose decay RATES are already
    exact and whose lag 0 is bit-identical to the mixed S(k)
    numerator.  ``pfw_num_time_steps`` has the same forward-walking
    window semantics as :class:`DensityEstSpec`.  See
    :class:`phd_qmclib_torch.samplers.dmc.ITCEstSpec`.
    """
    num_modes: int
    num_lags: int
    est_every_mult: int = 1
    as_pure_est: bool = False
    pfw_num_time_steps: t.Optional[int] = None


@dataclass(frozen=True)
class CMDiffusionEstSpec:
    """Center-of-mass imaginary-time diffusion (superfluid fraction /
    effective mass) estimator config.  No reference analog.

    ``window_blocks``: measurement-window length in blocks (the CM
    accumulator persists across block boundaries within a window, so
    ``tau`` reaches ``window_blocks * num_time_steps_block *
    time_step``); ``None`` (or 0, the HDF5-attrs encoding) = one
    window spanning the whole run.
    """
    window_blocks: t.Optional[int] = 1

    def __post_init__(self):
        if self.window_blocks is not None:
            wb = int(self.window_blocks)
            object.__setattr__(self, "window_blocks",
                               wb if wb > 0 else None)


class ProcInputError(ValueError):
    """Flags an invalid input for a QMC procedure."""


class ProcInput(metaclass=ABCMeta):
    """Input of a QMC procedure: a sampler state."""
    state: t.Any

    @classmethod
    @abstractmethod
    def from_model_sys_conf_spec(cls, sys_conf_spec: ModelSysConfSpec,
                                 proc: "Proc"):
        ...

    @classmethod
    @abstractmethod
    def from_result(cls, proc_result: "ProcResult", proc: "Proc"):
        ...


class ProcResult(metaclass=ABCMeta):
    """Result of a QMC procedure: last state + proc + data."""
    state: t.Any
    proc: "Proc"
    data: t.Any


class Proc(metaclass=ABCMeta):
    """QMC procedure spec and runner (``qmc_exec/proc.py:70-139``)."""

    @classmethod
    @abstractmethod
    def from_config(cls, config: t.Mapping):
        ...

    @abstractmethod
    def as_config(self) -> dict:
        """The procedure as a plain config mapping."""
        ...

    @property
    def should_eval_density(self) -> bool:
        return getattr(self, "density_spec", None) is not None

    @property
    def should_eval_ssf(self) -> bool:
        return getattr(self, "ssf_spec", None) is not None

    @property
    def should_eval_obd(self) -> bool:
        return getattr(self, "obd_spec", None) is not None

    @property
    def should_eval_pair_corr(self) -> bool:
        return getattr(self, "pair_corr_spec", None) is not None

    @property
    def should_eval_itc(self) -> bool:
        return getattr(self, "itc_spec", None) is not None

    @abstractmethod
    def describe_model_spec(self):
        ...

    @abstractmethod
    def build_result(self, state, sampling_data) -> ProcResult:
        ...

    def checkpoint(self):
        """Mid-procedure checkpoint hook (stub in the reference,
        ``qmc_exec/proc.py:127-129``)."""

    @abstractmethod
    def exec(self, proc_input: ProcInput) -> ProcResult:
        ...
