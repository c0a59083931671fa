"""VMC results data model: unweighted block statistics.

Copy of ``phd_qmclib_tpu.qmc_exec.data.vmc`` on the port's own
``stats.reblock`` (the upstream library's ``qmc_exec/data/vmc.py`` is
the model of both): VMC blocks carry unweighted means, S(k) uses the three-part
decomposition ``S(k) = <|rho_k|^2> - <Re>^2 - <Im>^2``.
"""
import typing as t
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np

from ...stats import reblock

__all__ = [
    "EnergyBlocks",
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
]

FDK_SQR_ABS, FDK_REAL, FDK_IMAG = 0, 1, 2


class PropsData(t.NamedTuple):
    """Per-block (or per-step) VMC properties, host-side arrays."""
    wf_abs_log: np.ndarray
    energy: np.ndarray
    move_stat: np.ndarray


@dataclass(frozen=True)
class PropBlock:
    total: float


@dataclass(frozen=True)
class PropBlocks(Mapping):
    """A series of unweighted data blocks
    (``qmc_exec/data/vmc.py:23-99``)."""
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
        return PropBlocks(self.totals[index])

    def __len__(self):
        return len(self.totals)

    def __iter__(self):
        for total in self.totals:
            yield PropBlock(total)

    def __add__(self, other):
        if not isinstance(other, PropBlocks):
            return NotImplemented
        try:
            totals = np.concatenate([self.totals, other.totals], axis=0)
        except ValueError as e:
            raise ValueError("the two objects' totals shapes do not "
                             "match for concatenation") from e
        return type(self)(totals)


@dataclass(frozen=True)
class EnergyBlocks(PropBlocks):
    """Energy data in blocks (block means of step/walker means)."""
    totals: np.ndarray

    @classmethod
    def from_data(cls, data: PropsData, reduce_data: bool = True):
        energy = np.asarray(data.energy)
        totals = energy.mean(axis=1) if reduce_data else energy
        return cls(totals)


@dataclass(frozen=True)
class SSFPartBlocks(PropBlocks):
    """One part of the S(k) data in blocks; one reblocking per mode."""
    totals: np.ndarray

    @classmethod
    def from_data(cls, ssf_data: np.ndarray, reduce_data: bool = True):
        ssf_data = np.asarray(ssf_data)
        totals = ssf_data.mean(axis=1) if reduce_data else ssf_data
        return cls(totals)

    @property
    def reblock(self):
        return reblock.OTFSet.from_non_obj_data(self.totals)


@dataclass(frozen=True)
class OBDBlocks(PropBlocks):
    """One-body density matrix ``n1(sz)`` data in blocks; one
    reblocking per displacement-grid point.

    The reference declares OBDM estimator machinery but never wires it
    (``qmc_base/vmc.py:444-450`` returns stubs); this block type
    completes the data layer for it.
    """
    totals: np.ndarray

    @classmethod
    def from_data(cls, obd_data: np.ndarray, reduce_data: bool = True):
        obd_data = np.asarray(obd_data)
        totals = obd_data.mean(axis=1) if reduce_data else obd_data
        return cls(totals)

    @property
    def reblock(self):
        return reblock.OTFSet.from_non_obj_data(self.totals)


@dataclass(frozen=True)
class PairCorrBlocks(PropBlocks):
    """Direct pair-correlation ``g2(r)`` data in blocks: per-chain
    histogram counts of unordered-pair minimum-image distances on
    uniform bins over ``[0, L/2]``; one reblocking per bin.  Beyond
    the reference (no direct pair-correlation estimator there)."""
    totals: np.ndarray

    @classmethod
    def from_data(cls, g2_data: np.ndarray, reduce_data: bool = True):
        g2_data = np.asarray(g2_data)
        totals = g2_data.mean(axis=1) if reduce_data else g2_data
        return cls(totals)

    @property
    def reblock(self):
        return reblock.OTFSet.from_non_obj_data(self.totals)

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
class SSFBlocks:
    """Static structure factor blocks
    (``qmc_exec/data/vmc.py:173-289``)."""
    fdk_sqr_abs_part: SSFPartBlocks
    fdk_real_part: SSFPartBlocks
    fdk_imag_part: SSFPartBlocks

    @classmethod
    def from_data(cls, ssf_data: np.ndarray, reduce_data: bool = True):
        ssf_data = np.asarray(ssf_data)
        totals = ssf_data.mean(axis=1) if reduce_data else ssf_data
        return cls(SSFPartBlocks(totals[..., FDK_SQR_ABS]),
                   SSFPartBlocks(totals[..., FDK_REAL]),
                   SSFPartBlocks(totals[..., FDK_IMAG]))

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
        ``<|rho_k|^2>`` part (see
        :func:`phd_qmclib_torch.analysis.pair_correlation_from_ssf`)."""
        from ...analysis import pair_correlation_from_ssf
        num_modes = self.fdk_sqr_abs_part.totals.shape[-1]
        momenta = np.arange(num_modes) * 2 * np.pi / supercell_size
        return pair_correlation_from_ssf(
            momenta, self.fdk_sqr_abs_part.mean, r_grid,
            boson_number, supercell_size,
            rho2_err=self.fdk_sqr_abs_part.mean_error)

    def density_profile(self, z_grid: np.ndarray, boson_number: int,
                        supercell_size: float):
        """``(n, n_err)`` on ``z_grid`` from the stored Re/Im parts
        (see :func:`phd_qmclib_torch.analysis.density_from_ssf`) — VMC
        has no binned density estimator (matching the reference), so
        this is ITS density profile, free from the S(k) data."""
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
class PropsDataSeries:
    """Full per-step data series (``keep_iter_data`` mode)."""
    iter_props: PropsData
    ssf: t.Optional[np.ndarray] = None
    obd: t.Optional[np.ndarray] = None
    g2: t.Optional[np.ndarray] = None

    @property
    def energy(self):
        return np.asarray(self.iter_props.energy).reshape(
            -1, *np.asarray(self.iter_props.energy).shape[2:])

    @property
    def wf_abs_log(self):
        return np.asarray(self.iter_props.wf_abs_log).reshape(
            -1, *np.asarray(self.iter_props.wf_abs_log).shape[2:])

    def hdf5_export(self, group: "h5py.Group"):
        props_group = group.require_group("props")
        for name in PropsData._fields:
            props_group.create_dataset(
                name, data=np.asarray(getattr(self.iter_props, name)))
        if self.ssf is not None:
            group.create_dataset("ss_factor", data=np.asarray(self.ssf))
        if self.obd is not None:
            group.create_dataset("one_body_dm", data=np.asarray(self.obd))
        if self.g2 is not None:
            group.create_dataset("pair_corr", data=np.asarray(self.g2))

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        props_group = group.get("props")
        iter_props = PropsData(
            *(props_group.get(name)[()] for name in PropsData._fields))
        ssf_ds = group.get("ss_factor")
        obd_ds = group.get("one_body_dm")
        g2_ds = group.get("pair_corr")
        return cls(iter_props,
                   ssf=ssf_ds[()] if ssf_ds is not None else None,
                   obd=obd_ds[()] if obd_ds is not None else None,
                   g2=g2_ds[()] if g2_ds is not None else None)


@dataclass(frozen=True)
class PropsDataBlocks:
    """Results of a VMC sampling grouped in block totals."""
    energy: EnergyBlocks
    ss_factor: t.Optional[SSFBlocks] = None
    one_body_dm: t.Optional[OBDBlocks] = None
    pair_corr: t.Optional[PairCorrBlocks] = None

    def hdf5_export(self, group: "h5py.Group"):
        self.energy.hdf5_export(group.require_group("energy"))
        if self.ss_factor is not None:
            self.ss_factor.hdf5_export(group.require_group("ss_factor"))
        if self.one_body_dm is not None:
            self.one_body_dm.hdf5_export(
                group.require_group("one_body_dm"))
        if self.pair_corr is not None:
            self.pair_corr.hdf5_export(group.require_group("pair_corr"))

    @classmethod
    def from_hdf5_data(cls, group: "h5py.Group"):
        energy = EnergyBlocks.from_hdf5_data(group.get("energy"))
        ssf_group = group.get("ss_factor")
        ss_factor = SSFBlocks.from_hdf5_data(ssf_group) \
            if ssf_group is not None else None
        obd_group = group.get("one_body_dm")
        one_body_dm = OBDBlocks.from_hdf5_data(obd_group) \
            if obd_group is not None else None
        g2_group = group.get("pair_corr")
        pair_corr = PairCorrBlocks.from_hdf5_data(g2_group) \
            if g2_group is not None else None
        return cls(energy, ss_factor, one_body_dm, pair_corr)

    def merge(self, other: "PropsDataBlocks") -> "PropsDataBlocks":
        if not isinstance(other, PropsDataBlocks):
            raise TypeError("merge requires another "
                            "'PropsDataBlocks'")
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
        g2 = self.pair_corr
        if g2 is None:
            g2 = other.pair_corr
        elif other.pair_corr is not None:
            g2 = g2 + other.pair_corr
        return PropsDataBlocks(self.energy + other.energy, ssf, obd, g2)


@dataclass(frozen=True)
class SamplingData:
    """The data from a VMC sampling."""
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
