"""DMC results data model: weighted block statistics.

Copy of ``phd_qmclib_tpu.qmc_exec.data.dmc`` on the port's own
``stats.reblock`` (the upstream library's ``qmc_exec/data/dmc.py`` is
the model of both): block totals feed mergeable reblocking tables;
weighted means are ratios of reblocked totals with full covariance
ratio-of-means error propagation; everything round-trips through HDF5
groups with the reference's dataset layout.
"""
import typing as t
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np

from ...stats import reblock

__all__ = [
    "CMDiffusionBlocks",
    "DensityBlocks",
    "EnergyBlocks",
    "ITCBlocks",
    "NumWalkersBlocks",
    "OBDBlocks",
    "PairCorrBlocks",
    "PropBlock",
    "PropBlocks",
    "PropsData",
    "PropsDataBlocks",
    "PropsDataSeries",
    "SamplingData",
    "SSFBlocks",
    "SSFPartBlocks",
    "UnWeightedPropBlocks",
    "WeightBlocks",
]

#: S(k) accumulator slots (reference ``qmc_base/dmc.py:77-88``).
FDK_SQR_ABS, FDK_REAL, FDK_IMAG = 0, 1, 2


def _rel_var(rb) -> np.ndarray:
    """Relative variance of a reblocked series' mean:
    ``var / (mean^2 * n_eff)``.

    Zero-mean series (e.g. ``Im rho_k`` of a symmetric density) have no
    defined RELATIVE error — the delta method returns NaN there, which
    downstream consumers (``analysis.density_from_ssf``,
    ``pair_correlation_from_ssf``) treat as "no contribution"; the
    spurious divide warning is suppressed.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        return rb.var / (rb.mean ** 2 * rb.eff_size)


def _ratio_mean_error(ratio, num_rb, den_rb, cross_rb) -> np.ndarray:
    """Delta-method (first-order Taylor) error of ``<num>/<den>``.

    For correlated series the relative variance of the ratio is the sum
    of the numerator and denominator relative variances minus twice
    their relative covariance, each taken from its own reblocking so
    autocorrelation is integrated out.  The covariance enters through
    the reblocked ``num*den`` series: ``cov_rel = (<num*den> -
    <num><den>) / (<num><den> n_eff)``.  Numerically identical to the
    reference's propagation (``qmc_exec/data/dmc.py:41-75``).

    With no denominator (``den_rb is None``) this reduces to the plain
    standard error of the numerator mean.
    """
    rel = _rel_var(num_rb)
    if den_rb is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            cov_rel = ((cross_rb.mean - num_rb.mean * den_rb.mean)
                       / (num_rb.mean * den_rb.mean
                          * cross_rb.eff_size))
        rel = rel + _rel_var(den_rb) - 2.0 * cov_rel
        # Near-perfectly correlated num/den (e.g. an estimator bin
        # whose counts track the walker count) can push the noisy
        # bracket slightly NEGATIVE; the true variance is nonnegative,
        # so clamp — the error is then statistically indistinguishable
        # from zero at this precision.  NaN (zero-mean series, a
        # deliberate "no relative error defined" marker) propagates
        # through the maximum untouched.
        rel = np.maximum(rel, 0.0)
    with np.errstate(invalid="ignore"):
        return np.abs(ratio) * np.sqrt(rel)


class PropsData(t.NamedTuple):
    """Per-block (or per-step) DMC properties, host-side arrays."""
    energy: np.ndarray
    weight: np.ndarray
    num_walkers: np.ndarray
    ref_energy: np.ndarray
    accum_energy: np.ndarray


@dataclass(frozen=True)
class PropBlock:
    """A single block of data."""
    total: float
    weight: t.Optional[float] = None


@dataclass(frozen=True)
class PropBlocks(Mapping):
    """A series of weighted data blocks.

    ``mean = <O> / <W>`` over reblocked totals; the error uses the full
    ratio-of-means covariance propagation (reference
    ``qmc_exec/data/dmc.py:41-75``).
    """
    totals: np.ndarray
    weight_totals: t.Optional[np.ndarray]

    @property
    def mean(self):
        if self.weight_reblock is None:
            return self.reblock.mean
        return self.reblock.mean / self.weight_reblock.mean

    @property
    def mean_error(self):
        return _ratio_mean_error(self.mean, self.reblock,
                                 self.weight_reblock,
                                 self.cross_weight_reblock)

    @property
    def reblock(self):
        return reblock.OTFObject.from_non_obj_data(self.totals)

    @property
    def weight_reblock(self):
        if self.weight_totals is None:
            return None
        return reblock.OTFObject.from_non_obj_data(self.weight_totals)

    @property
    def cross_weight_reblock(self):
        if self.weight_totals is None:
            return None
        return reblock.OTFObject.from_non_obj_data(
            self.totals * self.weight_totals)

    def hdf5_export(self, group: "h5py.Group"):
        group.create_dataset("totals", data=self.totals)
        group.create_dataset("weight_totals", data=self.weight_totals)

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        return cls(totals=group.get("totals")[()],
                   weight_totals=group.get("weight_totals")[()])

    def __getitem__(self, index):
        if isinstance(index, tuple):
            if len(index) > 1:
                raise TypeError("index tuples of length one are the only accepted form")
        if isinstance(index, int):
            return PropBlock(self.totals[index],
                             weight=self.weight_totals[index])
        return PropBlocks(self.totals[index], self.weight_totals[index])

    def __len__(self) -> int:
        return len(self.totals)

    def __iter__(self):
        for index, total in enumerate(self.totals):
            yield PropBlock(total, weight=self.weight_totals[index])

    def __add__(self, other):
        """Concatenate with blocks from another (restarted) run."""
        if not isinstance(other, PropBlocks):
            return NotImplemented
        try:
            totals = np.concatenate([self.totals, other.totals], axis=0)
        except ValueError as e:
            raise ValueError("the two objects' totals shapes do not "
                             "match for concatenation") from e
        try:
            weight_totals = np.concatenate(
                [self.weight_totals, other.weight_totals], axis=0)
        except ValueError as e:
            raise ValueError("the two objects' weight_totals shapes do "
                             "not match for concatenation") from e
        return type(self)(totals, weight_totals)


@dataclass(frozen=True)
class UnWeightedPropBlocks(Mapping):
    """A series of unweighted data blocks
    (``qmc_exec/data/dmc.py:171-245``)."""
    totals: np.ndarray

    @property
    def mean(self):
        return self.reblock.mean

    @property
    def mean_error(self):
        return self.reblock.mean_eff_error

    @property
    def reblock(self):
        return reblock.OTFObject.from_non_obj_data(self.totals)

    def hdf5_export(self, group: "h5py.Group"):
        group.create_dataset("totals", data=self.totals)

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        return cls(totals=group.get("totals")[()])

    def __getitem__(self, index):
        if isinstance(index, tuple):
            if len(index) > 1:
                raise TypeError("index tuples of length one are the only accepted form")
        if isinstance(index, int):
            return PropBlock(self.totals[index])
        return UnWeightedPropBlocks(self.totals[index])

    def __len__(self) -> int:
        return len(self.totals)

    def __iter__(self):
        for total in self.totals:
            yield PropBlock(total)

    def __add__(self, other):
        if not isinstance(other, UnWeightedPropBlocks):
            return NotImplemented
        try:
            totals = np.concatenate([self.totals, other.totals], axis=0)
        except ValueError as e:
            raise ValueError("the two objects' totals shapes do not "
                             "match for concatenation") from e
        return type(self)(totals)


@dataclass(frozen=True)
class NumWalkersBlocks(UnWeightedPropBlocks):
    """Number-of-walkers data in blocks."""
    totals: np.ndarray

    @classmethod
    def from_data(cls, data: PropsData, reduce_data: bool = True):
        num_walkers = np.asarray(data.num_walkers)
        totals = num_walkers.sum(axis=1) if reduce_data else num_walkers
        return cls(totals)


@dataclass(frozen=True)
class WeightBlocks(UnWeightedPropBlocks):
    """Weight data in blocks."""
    totals: np.ndarray

    @classmethod
    def from_data(cls, data: PropsData, reduce_data: bool = True):
        weight = np.asarray(data.weight)
        totals = weight.sum(axis=1) if reduce_data else weight
        return cls(totals)


@dataclass(frozen=True)
class EnergyBlocks(PropBlocks):
    """Energy data in blocks (weighted by ensemble weights)."""
    totals: np.ndarray
    weight_totals: np.ndarray

    @classmethod
    def from_data(cls, data: PropsData, reduce_data: bool = True):
        energy = np.asarray(data.energy)
        weight = np.asarray(data.weight)
        if reduce_data:
            return cls(energy.sum(axis=1), weight.sum(axis=1))
        return cls(energy, weight)


def _pure_aware_totals(num_time_steps_block: int, est_data: np.ndarray,
                       props_data: PropsData, reduce_data: bool,
                       as_pure_est: bool,
                       pure_est_reduce_factor: t.Optional[np.ndarray],
                       est_every: int = 1,
                       est_weight_totals: t.Optional[np.ndarray] = None):
    """Shared estimator-totals logic (``qmc_exec/data/dmc.py:329-374``).

    For pure (forward-walking) estimators, ONLY the end-of-block value
    is a statistical sample: within the forward-walking window the
    per-step values are nested partial sums (maximally correlated, and
    the early ones are still mixed-like under-projected estimates).
    The reference's ``keep_iter_data`` path instead reblocks the whole
    3-D per-step series with per-step weights faked by
    ``pure_est_reduce_factor`` (reference ``qmc_exec/data/dmc.py:
    360-370`` and ``dmc/proc.py:319-320``) - which both biases the mean
    with unprojected early-window values and feeds non-samples to the
    reblocking.  Here both modes reduce to the same statistic: the
    final step's accumulated estimate weighted by the final step's
    walker COUNT (which is what the sampler's per-walker sum is
    normalized by), so ``keep_iter_data`` on/off yield identical block
    statistics (tested in
    ``tests/qmc_exec/test_series_statistics.py``).
    """
    nts_block = num_time_steps_block
    weight_data = np.asarray(props_data.weight)
    est_data = np.asarray(est_data)
    if not as_pure_est:
        # With a measurement cadence (``est_every > 1``) the estimator
        # series holds one entry per MEASURED step, and its weighted
        # mean must be normalized by the weights of those same steps.
        if reduce_data:
            totals = est_data.sum(axis=1)
            weight_totals = (weight_data[:, est_every - 1::est_every]
                             .sum(axis=1) if est_every > 1
                             else weight_data.sum(axis=1))
        else:
            totals = est_data
            weight_totals = weight_data if est_weight_totals is None \
                else np.asarray(est_weight_totals,
                                dtype=weight_data.dtype)
    else:
        # Pure (forward-walking) estimators with a ONE-block window:
        # one statistical sample per block — the end-of-block value
        # weighted by the block-final step's walker count.  Multi-block
        # windows never reach this function: the exec runner collects
        # their window-final samples in ``_BlockAccumulator.
        # pure_samples`` and builds the Blocks objects directly
        # (``qmc_exec/dmc.py`` ``package()``).
        if reduce_data:
            # Full per-step series available.
            totals = est_data[:, -1]
            weight_totals = np.asarray(
                props_data.num_walkers)[:, nts_block - 1].astype(
                    weight_data.dtype)
        else:
            # Block-reduced inputs: the runner stored only the
            # end-of-block reductions and ``pure_est_reduce_factor =
            # N_w(last)/sum(W)`` recovers the block-final step's
            # walker count exactly.
            totals = est_data
            weight_totals = weight_data * pure_est_reduce_factor
    return totals, weight_totals[..., np.newaxis]


@dataclass(frozen=True)
class DensityBlocks(PropBlocks):
    """Density-profile data in blocks; one reblocking per bin."""
    totals: np.ndarray
    weight_totals: np.ndarray

    @classmethod
    def from_data(cls, num_time_steps_block: int, density_data: np.ndarray,
                  props_data: PropsData, reduce_data: bool = True,
                  as_pure_est: bool = True,
                  pure_est_reduce_factor: np.ndarray = None,
                  est_every: int = 1, est_weight_totals=None):
        totals, weight_totals = _pure_aware_totals(
            num_time_steps_block, density_data, props_data, reduce_data,
            as_pure_est, pure_est_reduce_factor, est_every,
            est_weight_totals)
        return cls(totals, weight_totals)

    @property
    def reblock(self):
        return reblock.OTFSet.from_non_obj_data(self.totals)

    @property
    def weight_reblock(self):
        if self.weight_totals is None:
            return None
        return reblock.OTFSet.from_non_obj_data(self.weight_totals)

    @property
    def cross_weight_reblock(self):
        if self.weight_totals is None:
            return None
        return reblock.OTFSet.from_non_obj_data(
            self.totals * self.weight_totals)


@dataclass(frozen=True)
class OBDBlocks(DensityBlocks):
    """One-body density matrix ``n1(sz)`` data in blocks; one
    reblocking per displacement-grid point, weighted like the other
    walker-averaged estimators (beyond the reference, which has no DMC
    OBDM estimator)."""

    @classmethod
    def from_data(cls, num_time_steps_block: int, obd_data: np.ndarray,
                  props_data: PropsData, reduce_data: bool = True,
                  as_pure_est: bool = True,
                  pure_est_reduce_factor: np.ndarray = None,
                  est_every: int = 1, est_weight_totals=None):
        totals, weight_totals = _pure_aware_totals(
            num_time_steps_block, obd_data, props_data, reduce_data,
            as_pure_est, pure_est_reduce_factor, est_every,
            est_weight_totals)
        return cls(totals, weight_totals)


@dataclass(frozen=True)
class PairCorrBlocks(DensityBlocks):
    """Direct pair-correlation ``g2(r)`` data in blocks: per-walker
    histogram counts of unordered-pair minimum-image distances on
    uniform bins over ``[0, L/2]``, one reblocking per bin.  Beyond the
    reference (no direct pair-correlation estimator there; cf. the
    Fourier route ``SSFBlocks.pair_correlation``)."""

    @classmethod
    def from_data(cls, num_time_steps_block: int, g2_data: np.ndarray,
                  props_data: PropsData, reduce_data: bool = True,
                  as_pure_est: bool = True,
                  pure_est_reduce_factor: np.ndarray = None,
                  est_every: int = 1, est_weight_totals=None):
        totals, weight_totals = _pure_aware_totals(
            num_time_steps_block, g2_data, props_data, reduce_data,
            as_pure_est, pure_est_reduce_factor, est_every,
            est_weight_totals)
        return cls(totals, weight_totals)

    def pair_correlation(self, boson_number: int,
                         supercell_size: float):
        """``(r_centers, g2, g2_err)`` — the normalized radial pair
        correlation (see
        :func:`phd_qmclib_torch.analysis.pair_correlation_from_counts`)."""
        from ...analysis import pair_correlation_from_counts
        return pair_correlation_from_counts(
            self.mean, boson_number, supercell_size,
            counts_err=self.mean_error)


@dataclass(frozen=True)
class SSFPartBlocks(DensityBlocks):
    """One part (|rho_k|^2, Re, Im) of the S(k) data in blocks."""

    @classmethod
    def from_data(cls, num_time_steps_block: int, ssf_data: np.ndarray,
                  props_data: PropsData, reduce_data: bool = True,
                  as_pure_est: bool = True,
                  pure_est_reduce_factor: np.ndarray = None,
                  est_every: int = 1, est_weight_totals=None):
        totals, weight_totals = _pure_aware_totals(
            num_time_steps_block, ssf_data, props_data, reduce_data,
            as_pure_est, pure_est_reduce_factor, est_every,
            est_weight_totals)
        return cls(totals, weight_totals)


@dataclass(frozen=True)
class SSFBlocks:
    """Static structure factor blocks:
    ``S(k) = <|rho_k|^2> - <Re rho_k>^2 - <Im rho_k>^2``
    (``qmc_exec/data/dmc.py:477-621``)."""

    fdk_sqr_abs_part: SSFPartBlocks
    fdk_real_part: SSFPartBlocks
    fdk_imag_part: SSFPartBlocks

    @classmethod
    def from_data(cls, num_time_steps_block: int, ssf_data: np.ndarray,
                  props_data: PropsData, reduce_data: bool = True,
                  as_pure_est: bool = True,
                  pure_est_reduce_factor: np.ndarray = None,
                  est_every: int = 1, est_weight_totals=None):
        totals, weight_totals = _pure_aware_totals(
            num_time_steps_block, ssf_data, props_data, reduce_data,
            as_pure_est, pure_est_reduce_factor, est_every,
            est_weight_totals)
        return cls(
            SSFPartBlocks(totals[..., FDK_SQR_ABS], weight_totals),
            SSFPartBlocks(totals[..., FDK_REAL], weight_totals),
            SSFPartBlocks(totals[..., FDK_IMAG], weight_totals))

    @property
    def mean(self):
        return (self.fdk_sqr_abs_part.mean
                - self.fdk_real_part.mean ** 2
                - self.fdk_imag_part.mean ** 2)

    @property
    def mean_error(self):
        return (self.fdk_sqr_abs_part.mean_error
                + 2 * (np.abs(self.fdk_real_part.mean)
                       * self.fdk_real_part.mean_error
                       + np.abs(self.fdk_imag_part.mean)
                       * self.fdk_imag_part.mean_error))

    def pair_correlation(self, r_grid: np.ndarray, boson_number: int,
                         supercell_size: float):
        """``(g2, g2_err)`` on ``r_grid`` from the stored
        ``<|rho_k|^2>`` part (truncated Fourier inversion; see
        :func:`phd_qmclib_torch.analysis.pair_correlation_from_ssf`).

        The mode grid is implied by the stored data:
        ``k_j = 2 pi j / L`` for ``j = 0..M-1``.
        """
        from ...analysis import pair_correlation_from_ssf
        num_modes = self.fdk_sqr_abs_part.totals.shape[-1]
        momenta = np.arange(num_modes) * 2 * np.pi / supercell_size
        return pair_correlation_from_ssf(
            momenta, self.fdk_sqr_abs_part.mean, r_grid,
            boson_number, supercell_size,
            rho2_err=self.fdk_sqr_abs_part.mean_error)

    def density_profile(self, z_grid: np.ndarray, boson_number: int,
                        supercell_size: float):
        """``(n, n_err)`` on ``z_grid`` from the stored
        ``<Re rho_k>``/``<Im rho_k>`` parts (band-limited Fourier
        synthesis; see
        :func:`phd_qmclib_torch.analysis.density_from_ssf`) — a density
        profile at zero runtime cost from S(k)-only runs."""
        from ...analysis import density_from_ssf
        num_modes = self.fdk_real_part.totals.shape[-1]
        momenta = np.arange(num_modes) * 2 * np.pi / supercell_size
        return density_from_ssf(
            momenta, self.fdk_real_part.mean, self.fdk_imag_part.mean,
            z_grid, supercell_size, boson_number,
            re_err=self.fdk_real_part.mean_error,
            im_err=self.fdk_imag_part.mean_error)


    def feynman_spectrum(self, boson_number: int,
                         supercell_size: float):
        """``(k, omega, omega_err)`` — the Bijl-Feynman upper bound
        ``omega(k) = k^2 / (S(k)/N)`` on the excitation spectrum, a
        zero-cost observable of the stored S(k) (see
        :func:`phd_qmclib_torch.analysis.feynman_spectrum`)."""
        from ...analysis import feynman_spectrum
        num_modes = self.fdk_sqr_abs_part.totals.shape[-1]
        momenta = np.arange(num_modes) * 2 * np.pi / supercell_size
        return feynman_spectrum(momenta, self.mean / boson_number,
                                self.mean_error / boson_number)

    def sound_speed(self, boson_number: int, supercell_size: float,
                    num_modes: int = 3):
        """``(c, c_err)`` — sound speed from the ``k -> 0`` phonon
        slope of the Feynman spectrum (see
        :func:`phd_qmclib_torch.analysis.sound_speed_from_ssf`)."""
        from ...analysis import sound_speed_from_ssf
        total_modes = self.fdk_sqr_abs_part.totals.shape[-1]
        momenta = np.arange(total_modes) * 2 * np.pi / supercell_size
        return sound_speed_from_ssf(momenta, self.mean / boson_number,
                                    self.mean_error / boson_number,
                                    num_modes=num_modes)

    def hdf5_export(self, group: "h5py.Group"):
        self.fdk_sqr_abs_part.hdf5_export(
            group.require_group("fdk_sqr_abs"))
        self.fdk_real_part.hdf5_export(group.require_group("fdk_real"))
        self.fdk_imag_part.hdf5_export(group.require_group("fdk_imag"))

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        return cls(
            SSFPartBlocks.from_hdf5_data(group.get("fdk_sqr_abs")),
            SSFPartBlocks.from_hdf5_data(group.get("fdk_real")),
            SSFPartBlocks.from_hdf5_data(group.get("fdk_imag")))

    def __add__(self, other):
        if not isinstance(other, SSFBlocks):
            return NotImplemented
        return SSFBlocks(self.fdk_sqr_abs_part + other.fdk_sqr_abs_part,
                         self.fdk_real_part + other.fdk_real_part,
                         self.fdk_imag_part + other.fdk_imag_part)


@dataclass(frozen=True)
class CMDiffusionBlocks:
    """Center-of-mass imaginary-time diffusion windows.

    The DMC sampler accumulates each walker's ancestry-transported CM
    displacement ``W_cm`` over measurement windows of
    ``window_blocks * num_time_steps_block`` steps
    (``samplers.dmc.Sampling.cm_diffusion_est`` /
    ``cm_window_blocks``); this class stores the ensemble-averaged
    ``<W_cm^2>(tau)`` series of every window and derives the
    superfluid fraction / inverse effective mass ``m/m*`` from the
    long-``tau`` diffusion slope (exact targets:
    ``ideal.effective_mass_ratio`` for the ideal lattice gas; 1 for
    any gas without a lattice).  No reference analog — the reference
    has no transport observable at all.
    """
    #: ``(num_windows, window_len)`` ensemble ``<W_cm^2>`` per
    #: measured step.
    w2_series: np.ndarray
    #: Imaginary-time spacing between consecutive series entries
    #: (``est_every * time_step``).
    tau_step: float
    boson_number: int

    @property
    def num_windows(self) -> int:
        return self.w2_series.shape[0]

    @property
    def tau_grid(self) -> np.ndarray:
        """Imaginary times of the series entries."""
        n = self.w2_series.shape[1]
        return (np.arange(n) + 1.0) * self.tau_step

    def _slope(self, w2: np.ndarray, fit_fraction: float):
        tau = self.tau_grid
        start = int(round((1.0 - fit_fraction) * len(tau)))
        return np.polyfit(tau[start:], w2[start:], 1)[0]

    def effective_mass_ratio(self, fit_fraction: float = 0.5):
        """``(m/m*, err)`` from the mean-window diffusion slope:
        ``m/m* = N * d<W_cm^2>/dtau / 2``
        (see ``analysis.effective_mass_from_cm_diffusion``).

        With two or more windows the error is a delete-one-window
        jackknife of the slope — between-window scatter (equilibration
        transients, branching-ancestry noise) dominates the
        within-curve fit residuals that a plain ``polyfit`` covariance
        sees, so the fit error alone badly understates the
        uncertainty on long runs."""
        half_n = 0.5 * self.boson_number
        w2_mean = self.w2_series.mean(axis=0)
        slope = self._slope(w2_mean, fit_fraction)
        n_w = self.num_windows
        if n_w >= 2:
            loo = np.array([
                self._slope(np.delete(self.w2_series, i, axis=0)
                            .mean(axis=0), fit_fraction)
                for i in range(n_w)])
            err = np.sqrt((n_w - 1) / n_w
                          * ((loo - loo.mean()) ** 2).sum())
            return half_n * slope, half_n * float(err)
        tau = self.tau_grid
        start = int(round((1.0 - fit_fraction) * len(tau)))
        _, cov = np.polyfit(tau[start:], w2_mean[start:], 1, cov=True)
        return half_n * slope, half_n * float(np.sqrt(cov[0, 0]))

    def hdf5_export(self, group: "h5py.Group"):
        group.create_dataset("w2_series", data=np.asarray(self.w2_series))
        group.attrs["tau_step"] = self.tau_step
        group.attrs["boson_number"] = self.boson_number

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        return cls(group.get("w2_series")[()],
                   float(group.attrs["tau_step"]),
                   int(group.attrs["boson_number"]))

    def __add__(self, other: "CMDiffusionBlocks") -> "CMDiffusionBlocks":
        if not isinstance(other, CMDiffusionBlocks):
            raise TypeError("'other' must be a CMDiffusionBlocks")
        if other.w2_series.shape[1] != self.w2_series.shape[1] \
                or other.tau_step != self.tau_step:
            raise ValueError("cannot merge CM-diffusion data with "
                             "different window shapes")
        return CMDiffusionBlocks(
            np.concatenate([self.w2_series, other.w2_series]),
            self.tau_step, self.boson_number)


@dataclass(frozen=True)
class ITCBlocks:
    """Imaginary-time density-density correlation (intermediate
    scattering function) blocks:
    ``F(k, tau_l) = <rho_k(t + tau_l) rho_-k(t)> / N`` for the
    harmonic momenta ``k_j = 2 pi j / L`` at lags
    ``tau_l = l * tau_step``, ``l = 0..num_lags`` (lag 0 is the mixed
    S(k) numerator).  No reference analog — the reference has no
    two-time observables.

    Per-block totals are the walker-summed lag products; the lag
    counts discount the ring buffer's initial fill and weight the
    ratio-of-means estimate.  Errors are delete-one-block jackknives
    of the ratio (blocks are the decorrelation unit, as everywhere in
    this data layer).
    """
    #: ``(num_blocks, num_lags + 1, num_modes)`` walker-summed lag
    #: products per block.
    lag_sums: np.ndarray
    #: ``(num_blocks, num_lags + 1)`` contributing-walker counts.
    lag_counts: np.ndarray
    #: Imaginary-time spacing between consecutive lags
    #: (``est_every * est_every_mult * time_step``).
    tau_step: float
    boson_number: int
    supercell_size: float

    @property
    def num_modes(self) -> int:
        return self.lag_sums.shape[-1]

    @property
    def momenta(self) -> np.ndarray:
        return (np.arange(self.num_modes) * 2 * np.pi
                / self.supercell_size)

    @property
    def tau_grid(self) -> np.ndarray:
        """Imaginary-time lags ``tau_l``, one leading zero entry."""
        return np.arange(self.lag_sums.shape[1]) * self.tau_step

    def _ratio(self, sums: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Per-particle ratio of means; lags whose ring-buffer row
        NEVER filled (zero total counts — e.g. ``num_lags`` exceeding
        the run's measured steps) are NaN, not a silent 0 that the
        log-slope downstream would turn into garbage energies."""
        tot = counts.sum(axis=0)[:, None] * self.boson_number
        out = sums.sum(axis=0) / np.maximum(tot, 1.0)
        return np.where(tot > 0, out, np.nan)

    @property
    def mean(self) -> np.ndarray:
        """``(num_lags + 1, num_modes)`` per-particle ``F(k, tau)``."""
        return self._ratio(self.lag_sums, self.lag_counts)

    @property
    def mean_error(self) -> np.ndarray:
        n_b = self.lag_sums.shape[0]
        if n_b < 2:
            return np.full_like(self.mean, np.nan)
        loo = np.stack([
            self._ratio(np.delete(self.lag_sums, i, axis=0),
                        np.delete(self.lag_counts, i, axis=0))
            for i in range(n_b)])
        return np.sqrt((n_b - 1) / n_b
                       * ((loo - loo.mean(axis=0)) ** 2).sum(axis=0))

    @property
    def normalized(self) -> np.ndarray:
        """``F(k, tau) / F(k, 0)`` (1 at ``tau = 0`` by construction)."""
        f = self.mean
        return f / np.maximum(f[:1], 1e-300)

    def effective_energy(self):
        """``(tau_mid, omega, omega_err)`` — the effective excitation
        energy ``omega_eff(k, tau) = -d ln F / d tau`` on midpoints of
        consecutive lags, a ``tau``-dependent UPPER bound on the
        lowest excitation energy at ``k`` that tightens as ``tau``
        grows (single-mode saturation turns it flat; cf. the Feynman
        bound ``k^2 N / S(k)``, which equals the ``tau -> 0`` limit).
        Errors: delete-one-block jackknife of the log-slope.
        """
        tau = self.tau_grid
        tau_mid = 0.5 * (tau[1:] + tau[:-1])

        def _omega(sums, counts):
            f = self._ratio(sums, counts)
            with np.errstate(divide="ignore", invalid="ignore"):
                return -np.diff(np.log(np.maximum(f, 1e-300)),
                                axis=0) / self.tau_step

        omega = _omega(self.lag_sums, self.lag_counts)
        n_b = self.lag_sums.shape[0]
        if n_b < 2:
            return tau_mid, omega, np.full_like(omega, np.nan)
        loo = np.stack([
            _omega(np.delete(self.lag_sums, i, axis=0),
                   np.delete(self.lag_counts, i, axis=0))
            for i in range(n_b)])
        err = np.sqrt((n_b - 1) / n_b
                      * ((loo - loo.mean(axis=0)) ** 2).sum(axis=0))
        return tau_mid, omega, err

    def _decay_slopes(self, sums, counts, fit_fraction: float,
                      filled: np.ndarray) -> np.ndarray:
        """Per-mode large-tau decay rate: a linear fit of
        ``-ln F(k, tau)`` over the last ``fit_fraction`` of the FILLED
        lags (backing :meth:`excitation_fit`, which jackknifes it)."""
        tau = self.tau_grid
        f = self._ratio(sums, counts)
        out = np.full(f.shape[1], np.nan)
        for j in range(f.shape[1]):
            good = filled & np.isfinite(f[:, j]) & (f[:, j] > 0)
            idx = np.where(good)[0]
            if idx.size < 2:
                continue
            start = int(round((1.0 - fit_fraction) * idx.size))
            idx = idx[min(start, idx.size - 2):]
            out[j] = -np.polyfit(tau[idx], np.log(f[idx, j]), 1)[0]
        return out

    def excitation_fit(self, fit_fraction: float = 0.5):
        """``(omega, omega_err)`` per mode: a linear fit of
        ``-ln F(k, tau)`` over the last ``fit_fraction`` of the FILLED
        lags — the steadier estimate of the large-tau decay rate than
        the adjacent-lag :meth:`effective_energy` differences (which
        it averages), still an upper bound on the lowest excitation at
        ``k``.  Errors are delete-one-block jackknives of the slope;
        modes whose F touches zero/NaN in the fit window return NaN.
        """
        filled = self.lag_counts.sum(axis=0) > 0
        omega = self._decay_slopes(self.lag_sums, self.lag_counts,
                                   fit_fraction, filled)
        n_b = self.lag_sums.shape[0]
        if n_b < 2:
            return omega, np.full_like(omega, np.nan)
        loo = np.stack([
            self._decay_slopes(np.delete(self.lag_sums, i, axis=0),
                               np.delete(self.lag_counts, i, axis=0),
                               fit_fraction, filled)
            for i in range(n_b)])
        err = np.sqrt((n_b - 1) / n_b
                      * ((loo - loo.mean(axis=0)) ** 2).sum(axis=0))
        return omega, err

    def static_response(self, fit_fraction: float = 0.5,
                        ssf: t.Optional[np.ndarray] = None,
                        ssf_err: t.Optional[np.ndarray] = None):
        """Static (zero-frequency) density response
        ``chi(k) = -2 m_{-1}(k)`` from the inverse-first-moment sum
        rule (units ``hbar^2/2m = 1``)::

            m_{-1}(k) = int_0^inf S(k, omega)/omega domega
                      = int_0^inf F(k, tau) dtau

        The measured lags are integrated with exponential (log-linear)
        segment interpolation — exact for a single decaying pole and
        more faithful than a trapezoid for any decaying F — and the
        ``tau > tau_max`` remainder is completed analytically as
        ``F(tau_max) / omega_fit``, where ``omega_fit`` is a
        log-linear decay fit over the last ``fit_fraction`` of the
        SAME trusted prefix the integral uses (cf.
        :meth:`excitation_fit`).  Since ``omega_fit`` is an UPPER bound
        on the lowest excitation, the completed tail slightly
        under-fills ``m_{-1}``; the bias dies as
        ``omega_1 tau_max`` grows (same projection control as the tail
        fit itself).

        Derived diagnostics per mode:

        * ``sound_speed = 1/sqrt(m_{-1})`` — the compressibility sum
          rule ``m_{-1} -> 1/c^2`` as ``k -> 0`` (single phonon pole:
          ``S -> k/c``, ``omega -> c k``, consistent with the f-sum
          ``m1 = k^2`` these units carry), a THIRD route to
          the macroscopic sound speed, independent of the S(k) slope
          (Feynman) and of the dispersion-peak/tail fits;
        * ``omega_bound = m0 / m_{-1}`` with ``m0 = F(k, 0) = S(k)`` —
          an upper bound on the lowest excitation at ``k`` that is
          TIGHTER than the Feynman bound ``m1/m0`` by Cauchy-Schwarz
          (``m0^2 <= m1 m_{-1}``).

        Errors are delete-one-block jackknives of the full functional
        (each resample re-fits its own tail slope).  No reference
        analog — the reference has no two-time observables.

        **Amplitude bias and the hybrid rescale.**  The ITC is a
        mixed estimator: DMC renders its DECAY RATES exact while its
        overall amplitude ``F(k, 0) = S(k)_mixed`` carries
        ``O(psi_T - phi_0)`` trial bias (largest at small k).  The
        ``omega_bound = m0/m_{-1} = 1 / int (F/F(0)) dtau`` is a ratio
        of the same amplitude and is therefore amplitude-bias-FREE
        as-is; ``m_{-1}``, ``chi`` and the sound speed are not.  Pass
        the same run's PURE (forward-walked) structure factor as
        ``ssf`` (per-particle, mode-aligned, i.e.
        ``SSFBlocks.mean / N``) to rescale
        ``m_{-1} = S_pure(k) int (F/F(0)) dtau`` — decay shape from
        the mixed two-time measurement, amplitude from the unbiased
        one-time one.  ``ssf_err`` (same normalization) is folded into
        the errors in quadrature.

        :return: dict of per-mode arrays ``m_minus1``, ``chi``,
            ``omega_bound``, ``sound_speed`` and their ``*_err``
            companions (the ``k = 0`` mode and any unresolved mode are
            NaN).
        """
        tau = self.tau_grid
        filled = self.lag_counts.sum(axis=0) > 0

        def _eval(sums, counts):
            """(3, num_modes): m_{-1}, omega_bound, sound_speed."""
            f = self._ratio(sums, counts)
            out = np.full((3, f.shape[1]), np.nan)
            for j in range(1, f.shape[1]):
                good = filled & np.isfinite(f[:, j]) & (f[:, j] > 0)
                # Contiguous positive prefix: the ring buffer fills
                # shallow-first, and a noise-driven sign flip at depth
                # truncates the integral at the last trustworthy lag
                # (the analytic tail takes over from there).  The tail
                # slope is fitted INSIDE the same prefix — lags past
                # the first sign flip are noise and must not steer the
                # completion.
                n_pre = 0
                while n_pre < f.shape[0] and good[n_pre]:
                    n_pre += 1
                if n_pre < 3:
                    continue
                i0 = min(int(round((1.0 - fit_fraction) * n_pre)),
                         n_pre - 2)
                slope = -np.polyfit(tau[i0:n_pre],
                                    np.log(f[i0:n_pre, j]), 1)[0]
                if not np.isfinite(slope) or slope <= 0:
                    continue
                fj = f[:n_pre, j]
                logr = np.log(fj[1:] / fj[:-1])
                dtau = np.diff(tau[:n_pre])
                flat = np.abs(logr) < 1e-6
                # Exponential interpolation through (f_i, f_{i+1}):
                # integral = dtau (f_{i+1} - f_i) / ln(f_{i+1}/f_i),
                # trapezoid in the flat limit where the log vanishes.
                seg = np.where(
                    flat, 0.5 * dtau * (fj[1:] + fj[:-1]),
                    dtau * (fj[1:] - fj[:-1])
                    / np.where(flat, 1.0, logr))
                m = seg.sum() + fj[-1] / slope
                out[1, j] = fj[0] / m       # amplitude-bias-free
                if ssf is not None:
                    sj = float(np.asarray(ssf, dtype=np.float64)[j])
                    if not (np.isfinite(sj) and sj > 0):
                        continue
                    m *= sj / fj[0]         # hybrid rescale
                out[0, j] = m
                out[2, j] = 1.0 / np.sqrt(m)
            return out

        full = _eval(self.lag_sums, self.lag_counts)
        n_b = self.lag_sums.shape[0]
        if n_b < 2:
            err = np.full_like(full, np.nan)
        else:
            # NaN-aware jackknife: a resample whose noise-truncated
            # prefix or tail slope fails to resolve a mode drops out
            # of that mode's spread instead of poisoning it (>= 2
            # finite resamples required, else the error is NaN).
            loo = np.stack([
                _eval(np.delete(self.lag_sums, i, axis=0),
                      np.delete(self.lag_counts, i, axis=0))
                for i in range(n_b)])
            fin = np.isfinite(loo)
            cnt = fin.sum(axis=0).astype(np.float64)
            safe = np.maximum(cnt, 1.0)
            mu = np.where(fin, loo, 0.0).sum(axis=0) / safe
            var = (np.where(fin, (loo - mu) ** 2, 0.0)).sum(axis=0)
            err = np.where(cnt >= 2,
                           np.sqrt((safe - 1.0) / safe * var), np.nan)
        if ssf is not None and ssf_err is not None:
            # The pure-S(k) amplitude uncertainty enters m_{-1} (and
            # chi) linearly and the sound speed at half weight; the
            # omega_bound is amplitude-free and untouched.
            with np.errstate(invalid="ignore", divide="ignore"):
                rel = (np.asarray(ssf_err, dtype=np.float64)
                       / np.asarray(ssf, dtype=np.float64))
            rel = np.where(np.isfinite(rel), rel, 0.0)
            err[0] = np.sqrt(err[0] ** 2 + (full[0] * rel) ** 2)
            err[2] = np.sqrt(err[2] ** 2
                             + (0.5 * full[2] * rel) ** 2)
        return {"m_minus1": full[0], "m_minus1_err": err[0],
                "chi": -2.0 * full[0], "chi_err": 2.0 * err[0],
                "omega_bound": full[1], "omega_bound_err": err[1],
                "sound_speed": full[2], "sound_speed_err": err[2]}

    def spectral_function(self, num_omega: int = 64,
                          omega_max: t.Optional[np.ndarray] = None):
        """Per-mode dynamic structure factor ``S(k, omega)`` by
        regularized inverse Laplace of the measured ``F(k, tau)``
        (:func:`phd_qmclib_torch.analysis.spectral_function_from_itc`;
        discrepancy-principle smoothing, so sharp peaks broaden at the
        ``1/tau_max`` resolution — the moments are the trustworthy
        numbers).  The f-sum rule ``m1 = k^2`` is NOT enforced by the
        inversion, which makes it an independent closure check of the
        whole two-time pipeline.

        Errors on the moment functionals come from delete-one-block
        jackknives re-inverted at the full-data regularization weight
        (so resamples share the smoothing, not re-chosen per sample).

        :param num_omega: frequency-grid resolution per mode.
        :param omega_max: optional ``(num_modes,)`` support cutoffs;
            default ``8x`` each mode's first-lag decay rate.
        :return: dict with ``omega``/``s_omega`` ``(num_modes,
            num_omega)`` grids and spectra (NaN rows for the ``k = 0``
            mode and any mode whose F is unusable), and per-mode
            ``m0``, ``m1``, ``omega_mean``, ``omega_mean_err``,
            ``omega_peak``, ``omega_peak_err`` arrays plus the
            self-calibrated finite-resolution systematics
            ``omega_mean_sys``/``omega_peak_sys``/``m1_sys`` (see
            :func:`~phd_qmclib_torch.analysis.spectral_function_from_itc`
            — the statistical jackknife cannot see this bias; quote
            the moments as value +/- stat +/- sys).
        """
        from ...analysis import spectral_function_from_itc

        tau = self.tau_grid
        f_all = self.mean
        f_err_all = self.mean_error
        n_m = self.num_modes
        n_b = self.lag_sums.shape[0]
        out = {key: np.full(n_m, np.nan) for key in
               ("m0", "m1", "omega_mean", "omega_mean_err",
                "omega_mean_sys", "omega_peak", "omega_peak_err",
                "omega_peak_sys", "m1_sys")}
        out["omega"] = np.full((n_m, num_omega), np.nan)
        out["s_omega"] = np.full((n_m, num_omega), np.nan)
        for j in range(1, n_m):
            cap = None if omega_max is None else float(omega_max[j])
            try:
                om, s_om, info = spectral_function_from_itc(
                    tau, f_all[:, j], f_err_all[:, j],
                    omega_max=cap, num_omega=num_omega)
            except ValueError:
                continue
            out["omega"][j] = om
            out["s_omega"][j] = s_om
            for key in ("m0", "m1", "omega_mean", "omega_peak",
                        "omega_mean_sys", "omega_peak_sys",
                        "m1_sys"):
                out[key][j] = info[key]
            if n_b < 2:
                continue
            means, peaks = [], []
            for i in range(n_b):
                f_i = self._ratio(np.delete(self.lag_sums, i, axis=0),
                                  np.delete(self.lag_counts, i, axis=0))
                try:
                    _, _, info_i = spectral_function_from_itc(
                        tau, f_i[:, j], f_err_all[:, j],
                        omega_max=float(om[-1]), num_omega=num_omega,
                        reg=info["lambda"])
                except ValueError:
                    continue
                means.append(info_i["omega_mean"])
                peaks.append(info_i["omega_peak"])
            if len(means) == n_b:
                fac = (n_b - 1) / n_b
                mu = np.mean(means)
                out["omega_mean_err"][j] = np.sqrt(
                    fac * ((np.asarray(means) - mu) ** 2).sum())
                mu = np.mean(peaks)
                out["omega_peak_err"][j] = np.sqrt(
                    fac * ((np.asarray(peaks) - mu) ** 2).sum())
        return out

    def hdf5_export(self, group: "h5py.Group"):
        group.create_dataset("lag_sums", data=np.asarray(self.lag_sums))
        group.create_dataset("lag_counts",
                             data=np.asarray(self.lag_counts))
        group.attrs["tau_step"] = self.tau_step
        group.attrs["boson_number"] = self.boson_number
        group.attrs["supercell_size"] = self.supercell_size

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        return cls(group.get("lag_sums")[()],
                   group.get("lag_counts")[()],
                   float(group.attrs["tau_step"]),
                   int(group.attrs["boson_number"]),
                   float(group.attrs["supercell_size"]))

    def __add__(self, other: "ITCBlocks") -> "ITCBlocks":
        if not isinstance(other, ITCBlocks):
            raise TypeError("'other' must be an ITCBlocks")
        if other.lag_sums.shape[1:] != self.lag_sums.shape[1:] \
                or other.tau_step != self.tau_step:
            raise ValueError("cannot merge imaginary-time-correlation "
                             "data with different lag/mode grids")
        return ITCBlocks(
            np.concatenate([self.lag_sums, other.lag_sums]),
            np.concatenate([self.lag_counts, other.lag_counts]),
            self.tau_step, self.boson_number, self.supercell_size)


@dataclass(frozen=True)
class PropsDataSeries:
    """Full per-step data series (``keep_iter_data`` mode).

    Unlike the reference (whose HDF5 export of the series is an open
    TODO, ``qmc_exec/data/dmc.py:776-791``), the series round-trips
    through HDF5 under ``data/series``.
    """
    iter_props: PropsData  # arrays of shape (num_blocks, nts)
    ssf: t.Optional[np.ndarray] = None
    density: t.Optional[np.ndarray] = None
    obd: t.Optional[np.ndarray] = None
    #: ``(num_blocks, nts_measured, 2)`` raw per-step CM-diffusion
    #: accumulators ``[sum W^2, sum W]``.
    cmd: t.Optional[np.ndarray] = None
    #: ``(num_blocks, nts_measured, num_bins)`` pair-correlation
    #: histogram sums.
    g2: t.Optional[np.ndarray] = None
    #: ``(num_blocks, nts_itc_measured, num_lags + 1, num_modes)``
    #: imaginary-time-correlation lag sums (mixed estimator only —
    #: the pure estimator's per-step values are partial window
    #: accumulations, not samples) with their contributing-walker
    #: counts.
    itc: t.Optional[np.ndarray] = None
    itc_nw: t.Optional[np.ndarray] = None

    @property
    def energy(self):
        return np.asarray(self.iter_props.energy).reshape(-1)

    @property
    def weight(self):
        return np.asarray(self.iter_props.weight).reshape(-1)

    @property
    def num_walkers(self):
        return np.asarray(self.iter_props.num_walkers).reshape(-1)

    @property
    def ref_energy(self):
        return np.asarray(self.iter_props.ref_energy).reshape(-1)

    @property
    def accum_energy(self):
        return np.asarray(self.iter_props.accum_energy).reshape(-1)

    def hdf5_export(self, group: "h5py.Group"):
        props_group = group.require_group("props")
        for name in PropsData._fields:
            props_group.create_dataset(
                name, data=np.asarray(getattr(self.iter_props, name)))
        if self.ssf is not None:
            group.create_dataset("ss_factor", data=np.asarray(self.ssf))
        if self.density is not None:
            group.create_dataset("density", data=np.asarray(self.density))
        if self.obd is not None:
            group.create_dataset("one_body_dm", data=np.asarray(self.obd))
        if self.cmd is not None:
            group.create_dataset("cm_diffusion", data=np.asarray(self.cmd))
        if self.g2 is not None:
            group.create_dataset("pair_corr", data=np.asarray(self.g2))
        if self.itc is not None:
            group.create_dataset("itc", data=np.asarray(self.itc))
            group.create_dataset("itc_nw",
                                 data=np.asarray(self.itc_nw))

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        props_group = group.get("props")
        iter_props = PropsData(
            *(props_group.get(name)[()] for name in PropsData._fields))
        ssf_ds = group.get("ss_factor")
        density_ds = group.get("density")
        obd_ds = group.get("one_body_dm")
        cmd_ds = group.get("cm_diffusion")
        g2_ds = group.get("pair_corr")
        itc_ds = group.get("itc")
        itc_nw_ds = group.get("itc_nw")
        return cls(iter_props,
                   ssf=ssf_ds[()] if ssf_ds is not None else None,
                   density=density_ds[()]
                   if density_ds is not None else None,
                   obd=obd_ds[()] if obd_ds is not None else None,
                   cmd=cmd_ds[()] if cmd_ds is not None else None,
                   g2=g2_ds[()] if g2_ds is not None else None,
                   itc=itc_ds[()] if itc_ds is not None else None,
                   itc_nw=itc_nw_ds[()]
                   if itc_nw_ds is not None else None)


@dataclass(frozen=True)
class PropsDataBlocks:
    """Results of a DMC sampling grouped in block totals
    (``qmc_exec/data/dmc.py:673-757``)."""
    energy: EnergyBlocks
    weight: WeightBlocks
    num_walkers: NumWalkersBlocks
    density: t.Optional[DensityBlocks] = None
    ss_factor: t.Optional[SSFBlocks] = None
    one_body_dm: t.Optional[OBDBlocks] = None
    cm_diffusion: t.Optional[CMDiffusionBlocks] = None
    pair_corr: t.Optional[PairCorrBlocks] = None
    itc: t.Optional[ITCBlocks] = None

    def hdf5_export(self, group: "h5py.Group"):
        self.energy.hdf5_export(group.require_group("energy"))
        self.weight.hdf5_export(group.require_group("weight"))
        self.num_walkers.hdf5_export(group.require_group("num_walkers"))
        if self.density is not None:
            self.density.hdf5_export(group.require_group("density"))
        if self.ss_factor is not None:
            self.ss_factor.hdf5_export(group.require_group("ss_factor"))
        if self.one_body_dm is not None:
            self.one_body_dm.hdf5_export(
                group.require_group("one_body_dm"))
        if self.cm_diffusion is not None:
            self.cm_diffusion.hdf5_export(
                group.require_group("cm_diffusion"))
        if self.pair_corr is not None:
            self.pair_corr.hdf5_export(group.require_group("pair_corr"))
        if self.itc is not None:
            self.itc.hdf5_export(group.require_group("itc"))

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        energy = EnergyBlocks.from_hdf5_data(group.get("energy"))
        weight = WeightBlocks.from_hdf5_data(group.get("weight"))
        num_walkers = NumWalkersBlocks.from_hdf5_data(
            group.get("num_walkers"))
        density_group = group.get("density")
        density = DensityBlocks.from_hdf5_data(density_group) \
            if density_group is not None else None
        ssf_group = group.get("ss_factor")
        ss_factor = SSFBlocks.from_hdf5_data(ssf_group) \
            if ssf_group is not None else None
        obd_group = group.get("one_body_dm")
        one_body_dm = OBDBlocks.from_hdf5_data(obd_group) \
            if obd_group is not None else None
        cmd_group = group.get("cm_diffusion")
        cm_diffusion = CMDiffusionBlocks.from_hdf5_data(cmd_group) \
            if cmd_group is not None else None
        g2_group = group.get("pair_corr")
        pair_corr = PairCorrBlocks.from_hdf5_data(g2_group) \
            if g2_group is not None else None
        itc_group = group.get("itc")
        itc = ITCBlocks.from_hdf5_data(itc_group) \
            if itc_group is not None else None
        return cls(energy, weight, num_walkers, density, ss_factor,
                   one_body_dm, cm_diffusion, pair_corr, itc)

    def merge(self, other: "PropsDataBlocks") -> "PropsDataBlocks":
        """Concatenate block data from a continuation run."""
        if not isinstance(other, PropsDataBlocks):
            raise TypeError("merge requires another "
                            "'PropsDataBlocks'")
        density = self.density
        if density is None:
            density = other.density
        elif other.density is not None:
            density = density + other.density
        ssf = self.ss_factor
        if ssf is None:
            ssf = other.ss_factor
        elif other.ss_factor is not None:
            ssf = ssf + other.ss_factor
        obd = self.one_body_dm
        if obd is None:
            obd = other.one_body_dm
        elif other.one_body_dm is not None:
            obd = obd + other.one_body_dm
        cmd = self.cm_diffusion
        if cmd is None:
            cmd = other.cm_diffusion
        elif other.cm_diffusion is not None:
            cmd = cmd + other.cm_diffusion
        g2 = self.pair_corr
        if g2 is None:
            g2 = other.pair_corr
        elif other.pair_corr is not None:
            g2 = g2 + other.pair_corr
        itc = self.itc
        if itc is None:
            itc = other.itc
        elif other.itc is not None:
            itc = itc + other.itc
        return PropsDataBlocks(self.energy + other.energy,
                               self.weight + other.weight,
                               self.num_walkers + other.num_walkers,
                               density, ssf, obd, cmd, g2, itc)


@dataclass(frozen=True)
class SamplingData:
    """The data from a DMC sampling."""
    blocks: PropsDataBlocks
    series: t.Optional[PropsDataSeries] = None

    def hdf5_export(self, group: "h5py.Group"):
        self.blocks.hdf5_export(group.require_group("blocks"))
        if self.series is not None:
            self.series.hdf5_export(group.require_group("series"))

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        series_group = group.get("series")
        series = PropsDataSeries.from_hdf5_data(series_group) \
            if series_group is not None else None
        return cls(PropsDataBlocks.from_hdf5_data(group.get("blocks")),
                   series=series)
