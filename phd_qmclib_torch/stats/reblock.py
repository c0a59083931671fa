"""Blocking (reblocking) analysis of serially-correlated Monte Carlo data.

Implements the Flyvbjerg-Petersen blocking analysis in two equivalent
forms:

* :class:`Object` - the classic explicit-reshaping analysis.
* :class:`OTFObject` / :class:`OTFSet` - analysis over *accumulated
  reblocking tables* (per-order sums, sums of squares and block counts)
  that can be merged across independent runs and extended to deeper
  orders.  The table layout (structured dtype with ``BLOCK_SIZE``,
  ``MEANS``, ``MEANS_SQR``, ``NUM_BLOCKS`` fields) is byte-compatible with
  the reference so result files interoperate.

The port's own copy of the JAX package's ``stats/reblock.py`` (NumPy
and ``scipy.optimize`` only).  Like the original, it builds the tables
of series of at least 2^14 values with the optional C++ cascade of
:mod:`.native` (the same source, built by the port itself) when that is
available, so the tables are bit-equal to the original's either way.

Behavioral parity notes (reference: the upstream library's
``stats/reblock.py``):

* The reference builds the tables with a numba-jitted *streaming doubling
  cascade* (``:524-604``).  Block means of order ``k`` are the means of
  the first ``floor(n / 2**k)`` complete blocks of ``2**k`` consecutive
  samples - exactly what a truncate-reshape-mean computes.  Here the
  tables are built with that vectorized formulation (``numpy``), which is
  both simpler and faster than a serial cascade on modern hardware, and
  produces *identical* tables.
* Optimal block size criterion ``B^3 > 8 N tau^2`` with a
  ``RuntimeWarning`` fallback to the maximum size (``:175-191``).
* Table merge across restarts (``:927-948``) and deep-extension of a set
  of tables (``:951-1021``).
"""
import typing as t
import warnings
from collections.abc import Mapping
from math import ceil, floor, log2, sqrt

import numpy as np
from scipy.optimize import curve_fit

__all__ = [
    "IACTimeFit",
    "Object",
    "OTFObject",
    "OTFSet",
    "otf_data_dtype",
    "on_the_fly_obj_create",
    "on_the_fly_obj_data_init",
    "on_the_fly_obj_data_order",
    "on_the_fly_obj_data_update",
    "on_the_fly_extend_obj_data_set",
]

BLOCK_SIZE_FIELD = "BLOCK_SIZE"
MEANS_FIELD = "MEANS"
MEANS_SQR_FIELD = "MEANS_SQR"
NUM_BLOCKS_FIELD = "NUM_BLOCKS"

#: Structured dtype of a reblocking table row (one entry per order).
#: Field layout matches the reference (``stats/reblock.py:436-441``) so
#: tables round-trip through HDF5 files written by either implementation.
otf_data_dtype = np.dtype([
    (BLOCK_SIZE_FIELD, np.int64),
    (MEANS_FIELD, np.float64),
    (MEANS_SQR_FIELD, np.float64),
    (NUM_BLOCKS_FIELD, np.int64),
])


# ---------------------------------------------------------------------------
# Table construction and manipulation.
# ---------------------------------------------------------------------------

def on_the_fly_obj_data_order(source_data: np.ndarray) -> int:
    """Maximum reblocking order representable for the given data length."""
    data_length = np.asarray(source_data).shape[0]
    return int(floor(log2(data_length)))


def on_the_fly_obj_data_init(order: int,
                             num_cols: t.Optional[int] = None) -> np.ndarray:
    """Initialize an empty reblocking table with ``order + 1`` levels.

    With ``num_cols=None`` a 1d table is returned; otherwise a 2d table
    with one row per column of tabular data.
    """
    squeeze = num_cols is None
    ncols = 1 if squeeze else num_cols
    table = np.zeros((ncols, order + 1), dtype=otf_data_dtype)
    table[BLOCK_SIZE_FIELD][:] = 1 << np.arange(order + 1)
    return table[0] if squeeze else table


def on_the_fly_obj_create(source_data: np.ndarray) -> np.ndarray:
    """Build a reblocking table from raw sample data.

    ``source_data`` may be 1d (a single series, returning a 1d table) or
    2d with shape ``(num_samples, num_cols)`` (returning a table of shape
    ``(num_cols, order + 1)``).

    Equivalent to the reference's streaming doubling cascade
    (``stats/reblock.py:524-604``), computed by vectorized reshaping.
    """
    source_data = np.asarray(source_data, dtype=np.float64)
    assert source_data.ndim >= 1
    is_1d = source_data.ndim == 1
    if is_1d:
        source_data = source_data[:, np.newaxis]

    n, num_cols = source_data.shape
    max_order = int(floor(log2(n)))
    table = on_the_fly_obj_data_init(max_order, num_cols)

    from . import native
    if n * num_cols >= 1 << 14 and native.native_available():
        # Native C++ streaming cascade (csrc/reblock.cpp) - a single
        # cache-friendly pass; used for large series.
        ms, msq, nb = native.otf_reblock_native(source_data, max_order)
        table[MEANS_FIELD][:] = ms
        table[MEANS_SQR_FIELD][:] = msq
        table[NUM_BLOCKS_FIELD][:] = nb
        return table[0] if is_1d else table

    data_t = source_data.T  # (num_cols, n)
    for order in range(max_order + 1):
        bsize = 1 << order
        nblocks = n // bsize
        eff = nblocks * bsize
        means = data_t[:, :eff].reshape(num_cols, nblocks, bsize).mean(axis=2)
        table[MEANS_FIELD][:, order] = means.sum(axis=1)
        table[MEANS_SQR_FIELD][:, order] = (means ** 2).sum(axis=1)
        table[NUM_BLOCKS_FIELD][:, order] = nblocks

    return table[0] if is_1d else table


def on_the_fly_obj_data_update(obj_data: np.ndarray,
                               ext_obj_data: np.ndarray) -> None:
    """Merge (in place) the accumulated data of two compatible tables.

    Reference: ``stats/reblock.py:927-948``.
    """
    assert obj_data.shape == ext_obj_data.shape
    assert np.all(obj_data[BLOCK_SIZE_FIELD] == ext_obj_data[BLOCK_SIZE_FIELD])
    obj_data[MEANS_FIELD] += ext_obj_data[MEANS_FIELD]
    obj_data[MEANS_SQR_FIELD] += ext_obj_data[MEANS_SQR_FIELD]
    obj_data[NUM_BLOCKS_FIELD] += ext_obj_data[NUM_BLOCKS_FIELD]


def _extension_from_last_order(last_order_data_set: np.ndarray) -> np.ndarray:
    """Deep-extension table from the last-order block sums of a table set.

    Reference: ``stats/reblock.py:951-979``.
    """
    obj_data_set = np.asarray(last_order_data_set)
    assert obj_data_set.dtype == otf_data_dtype
    block_size_set = obj_data_set[BLOCK_SIZE_FIELD]
    assert np.all(np.diff(block_size_set, axis=0) == 0)

    # Reblock the *means* of the last-order entries across the set.
    last_means_set = obj_data_set[MEANS_FIELD]
    extension = on_the_fly_obj_create(last_means_set)
    if extension.ndim == 1:
        extension = extension[np.newaxis, :]

    last_block_size = obj_data_set[BLOCK_SIZE_FIELD][0]
    extension[BLOCK_SIZE_FIELD] *= last_block_size[:, np.newaxis]
    # NOTE (parity): as in the reference, the extension's NUM_BLOCKS are
    # left as computed from the set (not rescaled).
    return extension[:, 1:]


def on_the_fly_extend_obj_data_set(obj_data_set) -> np.ndarray:
    """Combine a sequence of reblocking tables into one deeper table.

    The tables are merged element-wise, then extended with higher orders
    derived from the per-table last-order data.  This is how statistics
    compose across restarted runs.  Reference: ``stats/reblock.py:982-1021``.
    """
    obj_data_set = np.asarray(obj_data_set)
    assert obj_data_set.dtype == otf_data_dtype

    if obj_data_set.ndim == 2:
        is_2d = True
        num_data, max_order = obj_data_set.shape
        num_cols = 1
        obj_data_set = obj_data_set[:, np.newaxis, :]
    else:
        is_2d = False
        num_data, num_cols, max_order = obj_data_set.shape

    data_total = on_the_fly_obj_data_init(max_order - 1, num_cols)
    last_order_set = []
    for data_index in range(num_data):
        ext_data = obj_data_set[data_index]
        on_the_fly_obj_data_update(data_total, ext_data)
        last_order_set.append(ext_data[:, max_order - 1])

    data_ext = _extension_from_last_order(np.asarray(last_order_set))
    ext_data_set = np.hstack((data_total, data_ext))
    return ext_data_set[0] if is_2d else ext_data_set


# ---------------------------------------------------------------------------
# Integrated autocorrelation time fit.
# ---------------------------------------------------------------------------

class IACFitParams(t.NamedTuple):
    iac_time: float
    eac_time: float
    c_time: float


class IACTimeFit:
    """Fit ``tau(B) = tau_int - c * exp(-B / tau_exp)``.

    Reference: ``stats/reblock.py:45-102``.
    """

    def __init__(self, times: np.ndarray, iac_times: np.ndarray):
        self.times = np.asarray(times, dtype=np.float64)
        self.iac_times = np.asarray(iac_times, dtype=np.float64)
        try:
            self.results = curve_fit(self.__func__, self.times,
                                     self.iac_times)
        except TypeError as e:
            raise TypeError(
                "IAC time-fit did not converge on this series") from e

    @staticmethod
    def __func__(time, iac_time, eac_time, const):
        return iac_time - const * np.exp(-time / eac_time)

    def __call__(self, times):
        return self.__func__(np.asarray(times), *self.params)

    @property
    def params(self) -> IACFitParams:
        return IACFitParams(*self.results[0])

    @property
    def cov_matrix(self):
        return self.results[1]

    @property
    def errors(self) -> IACFitParams:
        return IACFitParams(*np.sqrt(np.diag(self.cov_matrix)))

    @property
    def iac_time(self):
        return self.params.iac_time

    @property
    def eac_time(self):
        return self.params.eac_time


# ---------------------------------------------------------------------------
# Analysis objects.
# ---------------------------------------------------------------------------

_OPT_BLOCK_WARNING = (
    "the optimum block size criterion is not satisfied by any of the "
    "autocorrelation times. The maximum block size will be treated as the "
    "optimal one. You may try to gather more data to suppress this warning."
)


class _AnalysisMixin:
    """Derived quantities shared by all reblocking analyses."""

    # Subclasses provide: size, mean, var, block_sizes, num_blocks,
    # means, vars.

    @property
    def errors(self):
        """Errors of the mean for each of the block sizes."""
        return np.sqrt(self.vars / self.num_blocks)

    @property
    def iac_times(self):
        """Integrated autocorrelation times per block size:
        ``0.5 * B * var_B / var``.

        Zero-variance (constant) series — e.g. ``num_walkers`` pinned at
        the cap, or S(0) — would hit 0/0 here; they are defined to have
        the uncorrelated-limit IAC time of 0.5 instead of NaN.
        """
        var = np.asarray(self._var_bcast(), dtype=np.float64)
        vars_ = np.asarray(self.vars, dtype=np.float64)
        safe_var = np.where(var == 0.0, 1.0, var)
        raw = 0.5 * self.block_sizes * vars_ / safe_var
        return np.where(var == 0.0, 0.5, raw)

    def _var_bcast(self):
        return self.var

    @property
    def opt_block_size(self):
        """Optimal block size by the criterion ``B^3 > 8 N tau^2``."""
        block_sizes = self.block_sizes
        criterion = (block_sizes ** 3
                     > 8 * self.size * self.iac_times ** 2)
        if not np.count_nonzero(criterion):
            warnings.warn(_OPT_BLOCK_WARNING, RuntimeWarning)
            return block_sizes.max()
        return block_sizes[criterion].min()

    @property
    def opt_iac_time(self):
        """IAC time at the optimal block size."""
        criterion = self.block_sizes == self.opt_block_size
        return self.iac_times[criterion][0]

    @property
    def eff_size(self):
        """Effective (decorrelated) sample size ``N / (2 tau)``."""
        return self.size / (2 * self.opt_iac_time)

    @property
    def mean_eff_error(self):
        """Effective error of the mean: ``sqrt(var / eff_size)``."""
        return sqrt(self.var / self.eff_size)

    @property
    def iac_time_fit(self) -> IACTimeFit:
        return IACTimeFit(self.block_sizes, self.iac_times)


class Object(_AnalysisMixin):
    """Explicit-reshaping blocking analysis of a 1d series.

    Reference: ``stats/reblock.py:326-419``.
    """

    def __init__(self, source_data: np.ndarray, min_num_blocks: int = 2):
        source_data = np.asarray(source_data, dtype=np.float64)
        assert source_data.ndim == 1
        if min_num_blocks < 2:
            raise ValueError("min_num_blocks must be at least 2 for a "
                             "blocking analysis")
        self.source_data = source_data
        self.min_num_blocks = min_num_blocks
        self.var_ddof = 1

    @property
    def size(self) -> int:
        return len(self.source_data)

    @property
    def mean(self):
        return self.source_data.mean(axis=0)

    @property
    def var(self):
        return self.source_data.var(axis=0, ddof=self.var_ddof)

    @property
    def block_sizes(self) -> np.ndarray:
        data_length = len(self.source_data)
        max_order = int(floor(log2(data_length)))
        min_order = int(ceil(log2(self.min_num_blocks)))
        if max_order < min_order:
            raise ValueError("the series is shorter than min_num_blocks "
                             "at every reblocking level")
        return (1 << np.arange(max_order - min_order + 1)).astype(np.int64)

    @property
    def num_blocks(self) -> np.ndarray:
        return (self.size // self.block_sizes).astype(np.int64)

    def _block_means(self, bsize: int) -> np.ndarray:
        nblocks = self.size // bsize
        eff = nblocks * bsize
        return self.source_data[:eff].reshape(nblocks, bsize).mean(axis=1)

    @property
    def means(self) -> np.ndarray:
        return np.array([self._block_means(b).mean()
                         for b in self.block_sizes])

    @property
    def vars(self) -> np.ndarray:
        return np.array([self._block_means(b).var(ddof=self.var_ddof)
                         for b in self.block_sizes])


class OTFObject(_AnalysisMixin):
    """Blocking analysis over an accumulated reblocking table (1d).

    Reference: ``stats/reblock.py:651-756``.
    """

    def __init__(self, source_data: np.ndarray,
                 min_num_blocks: t.Optional[int] = 2):
        source_data = np.asarray(source_data)
        if source_data.dtype != otf_data_dtype:
            raise TypeError("source_data lacks the reblocking structured dtype")
        if source_data.ndim != 1:
            raise ValueError("expected a rank-1 source_data array")
        min_num_blocks = min_num_blocks or 2
        if min_num_blocks < 2:
            raise ValueError("min_num_blocks must be at least 2 for a "
                             "blocking analysis")
        criterion = source_data[NUM_BLOCKS_FIELD] >= min_num_blocks
        if not np.count_nonzero(criterion):
            raise ValueError("no reblocking level reaches "
                             "min_num_blocks; the series is too short")
        self.source_data = source_data[criterion]
        self.min_num_blocks = min_num_blocks
        self.var_ddof = 1

    @classmethod
    def from_non_obj_data(cls, seq, min_num_blocks: int = None):
        return cls(on_the_fly_obj_create(seq), min_num_blocks=min_num_blocks)

    @classmethod
    def from_obj_data_set(cls, obj_data_set, min_num_blocks: int = None):
        return cls(on_the_fly_extend_obj_data_set(obj_data_set),
                   min_num_blocks=min_num_blocks)

    @property
    def size(self):
        return self.num_blocks[0]

    @property
    def mean(self):
        return self.means[0]

    @property
    def var(self):
        return self.vars[0]

    @property
    def block_sizes(self):
        return self.source_data[BLOCK_SIZE_FIELD]

    @property
    def num_blocks(self):
        return self.source_data[NUM_BLOCKS_FIELD]

    @property
    def means(self):
        return self.source_data[MEANS_FIELD] / self.num_blocks

    @property
    def vars(self):
        num_blocks = self.num_blocks
        means_sqr = self.source_data[MEANS_SQR_FIELD] / num_blocks
        ddof_num_blocks = num_blocks - self.var_ddof
        return num_blocks * (means_sqr - self.means ** 2) / ddof_num_blocks


class OTFSet(_AnalysisMixin, Mapping):
    """Blocking analysis over a set of reblocking tables (2d; one
    reblocking per column of tabular data, e.g. per S(k) mode or per
    density bin).

    Reference: ``stats/reblock.py:759-924``.
    """

    def __init__(self, source_data: np.ndarray,
                 min_num_blocks: t.Optional[int] = 2):
        source_data = np.asarray(source_data)
        if source_data.dtype != otf_data_dtype:
            raise TypeError("source_data lacks the reblocking structured dtype")
        if source_data.ndim != 2:
            raise ValueError("expected a rank-2 source_data array")
        block_size_set = source_data[BLOCK_SIZE_FIELD]
        assert np.all(np.diff(block_size_set, axis=0) == 0)
        min_num_blocks = min_num_blocks or 2
        if min_num_blocks < 2:
            raise ValueError("min_num_blocks must be at least 2 for a "
                             "blocking analysis")
        data_num_blocks = source_data[NUM_BLOCKS_FIELD][0, :]
        criterion = data_num_blocks >= min_num_blocks
        if not np.count_nonzero(criterion):
            raise ValueError("no reblocking level reaches "
                             "min_num_blocks; the series is too short")
        self.source_data = source_data[:, criterion]
        self.min_num_blocks = min_num_blocks
        self.var_ddof = 1

    @classmethod
    def from_non_obj_data(cls, seq, min_num_blocks: int = None):
        return cls(on_the_fly_obj_create(seq), min_num_blocks=min_num_blocks)

    @classmethod
    def from_obj_data_set(cls, obj_data_set, min_num_blocks: int = None):
        return cls(on_the_fly_extend_obj_data_set(obj_data_set),
                   min_num_blocks=min_num_blocks)

    @property
    def size(self) -> np.ndarray:
        return self.num_blocks[:, 0]

    @property
    def mean(self):
        return self.means[:, 0]

    @property
    def var(self):
        return self.vars[:, 0]

    def _var_bcast(self):
        return self.var[:, np.newaxis]

    @property
    def block_sizes(self):
        return self.source_data[BLOCK_SIZE_FIELD]

    @property
    def num_blocks(self):
        return self.source_data[NUM_BLOCKS_FIELD]

    @property
    def means(self):
        return self.source_data[MEANS_FIELD] / self.num_blocks

    @property
    def vars(self):
        num_blocks = self.num_blocks
        means_sqr = self.source_data[MEANS_SQR_FIELD] / num_blocks
        ddof_num_blocks = num_blocks - self.var_ddof
        return num_blocks * (means_sqr - self.means ** 2) / ddof_num_blocks

    @property
    def opt_block_size(self):
        block_sizes = self.block_sizes
        data_size = self.size[:, np.newaxis]
        iac_times = self.iac_times
        criterion = block_sizes ** 3 > 8 * data_size * iac_times ** 2
        opt_block_sizes = []
        for row_idx, row_positions in enumerate(criterion):
            valid_sizes = block_sizes[row_idx, row_positions]
            if not np.count_nonzero(valid_sizes):
                warnings.warn(_OPT_BLOCK_WARNING, RuntimeWarning)
                opt_block_sizes.append(block_sizes.max())
            else:
                opt_block_sizes.append(valid_sizes.min())
        return np.array(opt_block_sizes)

    @property
    def opt_iac_time(self):
        criterion = self.block_sizes == self.opt_block_size[:, np.newaxis]
        return np.array([self.iac_times[i, pos][0]
                         for i, pos in enumerate(criterion)])

    @property
    def eff_size(self):
        return self.size / (2 * self.opt_iac_time)

    @property
    def mean_eff_error(self):
        return np.sqrt(self.var / self.eff_size)

    def __getitem__(self, index) -> OTFObject:
        return OTFObject(self.source_data[index],
                         min_num_blocks=self.min_num_blocks)

    def __len__(self) -> int:
        return self.source_data.shape[0]

    def __iter__(self):
        for index in range(len(self)):
            yield self[index]
