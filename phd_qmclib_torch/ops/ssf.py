"""The S(k) harmonics in one launch: ``(|rho_k|^2, Re rho_k, Im rho_k)``
of every walker at the harmonic momenta ``k_j = j 2 pi / L``, ``j =
0..M-1``.

:func:`ssf_harmonics` launches the hand-written CUDA kernel of
``csrc/ssf.cu``; it has no CPU version here: ``models/mrbp.py`` runs
``models/jastrow.py``'s plain ``_harmonics_reim`` on a CPU tensor, and
the kernel rounds every element as that version does (only the order of
the particle sum differs).  The JAX package computes the same with an
XLA scan (``_fourier_harmonics_scan``); it has no Pallas kernel for it.
"""
import torch

from . import _build

__all__ = ["MAX_NOP", "ssf_harmonics"]

#: Largest particle count of the kernel (``csrc/ssf.cu`` kMaxNop).
MAX_NOP = 1024


def ssf_harmonics(pos: torch.Tensor, lengths: torch.Tensor, *,
                  num_modes: int) -> torch.Tensor:
    """The parts ``(W, num_modes, 3)`` of walkers ``pos (W, N)``: for
    each walker and mode ``j``, ``(re^2 + im^2, re, im)`` with ``re + i
    im = sum_n exp(i j k_1 z_n)``, ``k_1 = 2 pi / L``.

    ``lengths`` is ``(R,)``, the supercell size L of each row: one row,
    or the rows of a fused sweep, the ``W / R`` consecutive walkers of
    row ``r`` taking ``lengths[r]`` with the arithmetic of a launch on
    that row alone.  The kernel divides as the plain version's torch
    division does (2 pi in ``pos``' dtype over L, rounded once).  ``pos``
    and ``lengths`` are contiguous, float32 or float64 alike, on one CUDA
    device; ``0 < N <= 1024``, ``num_modes >= 1``.  Each launch adds one
    to ``ssf_harmonics.launch_count``, or with more than one row to
    ``ssf_harmonics.table_launch_count``.
    """
    if pos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ssf_harmonics takes float32 or float64 "
                        f"positions, not {pos.dtype}")
    if pos.dim() != 2 or not 0 < pos.shape[1] <= MAX_NOP:
        raise ValueError(f"positions of shape (W, N), 0 < N <= {MAX_NOP}, "
                         f"expected; got {tuple(pos.shape)}")
    if lengths.dim() != 1 or lengths.shape[0] == 0 \
            or pos.shape[0] % lengths.shape[0] != 0 \
            or lengths.dtype != pos.dtype or lengths.device != pos.device:
        raise ValueError("the supercell lengths have to be an (R,) table "
                         "on the positions' device in their dtype, R > 0 "
                         "dividing W")
    if not (pos.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("ssf_harmonics needs contiguous positions and "
                         "lengths")
    if num_modes < 1:
        raise ValueError(f"num_modes has to be at least 1, not {num_modes}")
    if pos.device.type != "cuda":
        raise ValueError(f"ssf_harmonics runs on a CUDA device only, not "
                         f"{pos.device}")
    num_walkers, nop = pos.shape
    out = pos.new_empty((num_walkers, num_modes, 3))
    if num_walkers == 0:
        return out
    rows = lengths.shape[0]
    suffix = "f32" if pos.dtype == torch.float32 else "f64"
    _build.call(_build.functions()[f"qmc_ssf_harmonics_{suffix}"],
                pos.device, pos.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), num_walkers, num_walkers // rows, nop,
                num_modes)
    if rows > 1:
        ssf_harmonics.table_launch_count += 1
    else:
        ssf_harmonics.launch_count += 1
    return out


#: Kernel launches since the last reset (set them to 0 to reset): with one
#: row, and with a sweep's table of rows.
ssf_harmonics.launch_count = 0
ssf_harmonics.table_launch_count = 0
