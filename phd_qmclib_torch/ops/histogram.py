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
import torch

from . import _build

__all__ = ["MAX_BINS", "walker_histogram", "walker_histogram_plain"]

#: Most bins the kernel takes: one warp's int counts in 48 KB of shared
#: memory.
MAX_BINS = 48 * 1024 // 4


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
    tensor launches the kernel of ``csrc/histogram.cu`` (f32 or f64,
    ``num_bins <= MAX_BINS``); a CPU tensor runs
    :func:`walker_histogram_plain`.
    """
    if pos.device.type == "cpu":
        return walker_histogram_plain(pos, bin_size, num_bins)
    if pos.device.type != "cuda":
        raise ValueError(f"no kernel for device {pos.device}")
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pos must be float32 or float64, got {pos.dtype}")
    if not 0 < num_bins <= MAX_BINS:
        raise ValueError(f"num_bins must be in [1, {MAX_BINS}], got "
                         f"{num_bins}")
    if bin_size.shape != () or bin_size.dtype != pos.dtype \
            or bin_size.device != pos.device:
        raise ValueError("bin_size must be a 0-d tensor in pos' dtype on "
                         "pos' device")
    if pos.dim() < 1 or pos.shape[-1] == 0:
        raise ValueError(f"pos must have a non-empty last axis, got "
                         f"{tuple(pos.shape)}")
    rows = pos.reshape(-1, pos.shape[-1])
    if not rows.is_contiguous():
        raise ValueError("pos must be contiguous")
    num_rows, row_len = rows.shape
    if num_rows >= 1 << 31:
        raise ValueError(f"{num_rows} rows exceed the kernel's int range")
    out = torch.empty((num_rows, num_bins), dtype=pos.dtype,
                      device=pos.device)
    if num_rows == 0:
        return out.reshape(pos.shape[:-1] + (num_bins,))
    lib = _build.library()
    launch = (lib.qmc_walker_histogram_f32 if pos.dtype == torch.float32
              else lib.qmc_walker_histogram_f64)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(launch(rows.data_ptr(), bin_size.data_ptr(),
                            out.data_ptr(), num_rows, row_len, num_bins,
                            stream),
                     "walker histogram kernel")
    walker_histogram.launch_count += 1
    return out.reshape(pos.shape[:-1] + (num_bins,))


#: Kernel launches since the last reset (set it to 0 to reset).
walker_histogram.launch_count = 0
