"""Per-walker histogram: the density and g2 estimators' binning op.

Counterpart of ``phd_qmclib_tpu.ops.histogram``.  For rows ``pos (...,
N)`` it counts ``hist[..., b] = #{i : bin(pos[..., i]) = b}`` with
``bin = clip(pos // bin_size, 0, B - 1)``: the floor division of the JAX
package's ``walker_histogram_onehot`` (and of its production
``walker_histogram_mxu``, whose TPU matrix-unit factorization has no job
here).  Counts are exact integers in ``pos``'s dtype.

:func:`walker_histogram` launches the hand-written CUDA kernel of
``csrc/histogram.cu`` on a CUDA tensor and runs
:func:`walker_histogram_plain` on a CPU tensor.
"""
import functools

import torch

from . import _build

__all__ = ["MAX_BINS", "launch_shape", "tiled_launch_shape",
           "walker_histogram", "walker_histogram_plain"]

#: Most bins of the one-row-per-warp kernel: one warp's int counts in 48
#: KB of shared memory.  More bins take the tiled kernel.
SHARED_BYTES = 48 * 1024
MAX_BINS = SHARED_BYTES // 4
#: Most warps per CTA of the kernel (``csrc/histogram.cu`` kMaxWarps).
MAX_WARPS = 8
#: Shared memory of one H100 SM, and what each resident CTA reserves of
#: it.
SM_SHARED_BYTES, CTA_RESERVED_BYTES = 228 * 1024, 1024

#: Threads per CTA of the tiled kernel (kMaxWarps warps).
TILED_THREADS = 32 * MAX_WARPS
#: Resident threads of one H100 SM.
SM_THREADS = 2048

#: Launch functions by dtype: one row per warp, and tiled.
_LAUNCH = {torch.float32: "qmc_walker_histogram_f32",
           torch.float64: "qmc_walker_histogram_f64"}
_LAUNCH_TILED = {torch.float32: "qmc_walker_histogram_tiled_f32",
                 torch.float64: "qmc_walker_histogram_tiled_f64"}


@functools.lru_cache(maxsize=256)
def launch_shape(num_rows: int, num_bins: int, sms: int,
                 ctas_per_sm: int) -> tuple:
    """``(warps per CTA, CTAs)`` of the kernel: as many warps (one row
    each at a time, their int bins in shared memory) as fit 48 KB, and a
    persistent grid of the CTAs that fit on ``sms`` SMs, at most
    ``ctas_per_sm`` each (the kernel's launch bounds), and no CTA without
    a tile of rows: CTA ``c`` takes the tiles ``c, c + grid, ...`` of
    ``warps`` contiguous rows."""
    warps = max(1, min(MAX_WARPS, SHARED_BYTES // (4 * num_bins)))
    per_cta = warps * num_bins * 4 + CTA_RESERVED_BYTES
    resident = max(1, min(ctas_per_sm, SM_SHARED_BYTES // per_cta))
    return warps, _build.persistent_grid(-(-num_rows // warps), sms, resident)


@functools.lru_cache(maxsize=256)
def tiled_launch_shape(num_rows: int, num_bins: int, sms: int,
                       ctas_per_sm: int) -> tuple:
    """``(bins per tile, CTAs)`` of the tiled kernel, for ``num_bins >
    MAX_BINS``: the fewest tiles whose int counts fit 48 KB, of equal
    width rounded up to a multiple of 4 (every tile of a 16-byte aligned
    row of counts then starts 16-byte aligned), and a persistent grid of
    the CTAs that fit on ``sms`` SMs by their shared memory, their
    threads and the kernel's launch bounds, one row per CTA at a time
    and no CTA without a row."""
    num_tiles = -(-num_bins // MAX_BINS)
    tile = -(-num_bins // (4 * num_tiles)) * 4
    per_cta = tile * 4 + CTA_RESERVED_BYTES
    resident = max(1, min(ctas_per_sm, SM_THREADS // TILED_THREADS,
                          SM_SHARED_BYTES // per_cta))
    return tile, _build.persistent_grid(num_rows, sms, resident)


@functools.lru_cache(maxsize=256)
def _launch(dtype, num_rows: int, num_bins: int, index: int):
    """The launch function of the kernel for ``num_rows`` rows of
    ``dtype`` into ``num_bins`` bins on CUDA device ``index``, its warps
    per CTA (the bins per tile beyond ``MAX_BINS``) and its grid."""
    fns = _build.functions()
    shape, names = (launch_shape, _LAUNCH) if num_bins <= MAX_BINS \
        else (tiled_launch_shape, _LAUNCH_TILED)
    size, grid = shape(num_rows, num_bins, _build.sm_count(index),
                       fns["qmc_walker_histogram_ctas_per_sm"]())
    return fns[names[dtype]], size, grid


def _bin_ids(pos: torch.Tensor, bin_size: torch.Tensor,
             num_bins: int) -> torch.Tensor:
    """int64 bin of every element: ``pos // bin_size`` clipped to
    ``[0, num_bins - 1]``; NaN goes to bin 0, as in the kernel."""
    q = pos // bin_size
    q = torch.where(q >= 0, q, 0.0).clamp(max=num_bins - 1)
    return q.to(torch.int64)


def walker_histogram_plain(pos: torch.Tensor, bin_size: torch.Tensor,
                           num_bins: int) -> torch.Tensor:
    """Plain torch version of the kernel: ``(..., num_bins)`` counts.

    One ``scatter_add_`` of ones into the ``(rows, num_bins)`` output,
    never a ``(rows, N, num_bins)`` one-hot (146 GB at the g2 estimator's
    full-width shape).
    """
    rows = pos.reshape(-1, pos.shape[-1])
    out = torch.zeros((rows.shape[0], num_bins), dtype=pos.dtype,
                      device=pos.device)
    out.scatter_add_(1, _bin_ids(rows, bin_size, num_bins),
                     torch.ones_like(rows))
    return out.reshape(pos.shape[:-1] + (num_bins,))


def walker_histogram(pos: torch.Tensor, bin_size: torch.Tensor,
                     num_bins: int) -> torch.Tensor:
    """``(..., num_bins)`` per-row histogram of ``pos (..., N)``.

    ``bin_size`` is a 0-d tensor of ``pos``'s dtype on ``pos``'s device;
    the kernel reads it there, so no value crosses to the host.  A CUDA
    tensor launches a kernel of ``csrc/histogram.cu`` (f32 or f64, any
    row length and row count; rows that are not 16-byte aligned, as in a
    view with a storage offset, take its scalar path; more than
    ``MAX_BINS`` bins take its tiled kernel, a CTA per row and the bins
    in passes); a CPU tensor runs :func:`walker_histogram_plain`.
    """
    dev = pos.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return walker_histogram_plain(pos, bin_size, num_bins)
        raise ValueError(f"no kernel for device {dev}")
    if pos.dtype not in _LAUNCH:
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    if not 0 < num_bins < 1 << 31:
        raise ValueError(f"num_bins must be a positive int32, got "
                         f"{num_bins}")
    if bin_size.dim() != 0 or bin_size.dtype != pos.dtype \
            or bin_size.device != dev:
        raise ValueError("bin_size must be a 0-d tensor in pos' dtype on "
                         "pos' device")
    if pos.dim() < 1 or pos.shape[-1] == 0:
        raise ValueError(f"pos must have a non-empty last axis, got "
                         f"{tuple(pos.shape)}")
    rows_2d = pos.dim() == 2
    rows = pos if rows_2d else pos.reshape(-1, pos.shape[-1])
    if not rows.is_contiguous():
        raise ValueError("pos must be contiguous")
    num_rows, row_len = rows.shape
    if num_rows >= 1 << 31:
        raise ValueError(f"{num_rows} rows exceed the kernel's int range")
    out = pos.new_empty((num_rows, num_bins))
    if num_rows > 0:
        fn, size, grid = _launch(pos.dtype, num_rows, num_bins, dev.index)
        _build.call(fn, dev, rows.data_ptr(), bin_size.data_ptr(),
                    out.data_ptr(), num_rows, row_len, num_bins, size,
                    grid)
        walker_histogram.launch_count += 1
    return out if rows_2d else out.reshape(pos.shape[:-1] + (num_bins,))


#: Kernel launches since the last reset (set it to 0 to reset).
walker_histogram.launch_count = 0
