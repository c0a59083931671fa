"""Build and load the hand-written CUDA kernels.

``csrc/*.cu`` (with the device code they share in ``csrc/*.cuh``)
compile with ``nvcc`` into one shared library with a plain C interface,
``build/libqmc_kernels.so`` at the root of the checkout, the first time
a kernel is launched (or again when a source or header is newer than
the library).  Each source compiles in its own ``nvcc`` process,
all started together, and one more links the objects.  The library is
loaded with ``ctypes``: every pointer and the stream pass as
``c_void_p``, every integer as ``c_int`` (a 64-bit key or step as
``c_uint64``), and every launch function returns its
``cudaGetLastError()``.

The launch path (:func:`functions`, :func:`call`, :func:`sm_count`,
:func:`persistent_grid`) costs about what a PyTorch op's dispatch does:
the ctypes function objects are looked up once, when the library loads;
the stream is the device's current raw stream, an int, without a
``torch.cuda.Stream`` object; the device guard is entered only when the
tensor's device is not the current one.

Nothing here runs at import time: the CPU tests import every module on
a host without ``nvcc`` or a GPU.
"""
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["build", "call", "functions", "library", "persistent_grid",
           "sm_count", "BUILD_DIR", "HEADERS", "SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "pairwise.cu", CSRC / "prng.cu", CSRC / "histogram.cu",
           CSRC / "diffuse.cu", CSRC / "obd.cu", CSRC / "ssf.cu")
#: Device code included by several sources.
HEADERS = (CSRC / "pair_terms.cuh", CSRC / "pair_terms_grad.cuh",
           CSRC / "philox.cuh", CSRC / "trig.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIBRARY = BUILD_DIR / "libqmc_kernels.so"

#: Hopper only (``sm_90a``); no ``--use_fast_math``: the one-body terms
#: need the accurate ``tanf``/``tanhf`` and the Box-Muller radius the
#: accurate ``logf``.  ``-Xptxas -v`` reports registers, shared memory
#: and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L, _U64 = ctypes.c_longlong, ctypes.c_uint64
_DIFFUSE = (_P, _P, _P, _P, _P, _P, _D, _D, _U64, _U64, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _P)
_NORMALS = (_P, _I, _U64, _U64, _D, _I, _P)
_HISTOGRAM = (_P, _P, _P, _L, _L, _I, _I, _I, _I, _P)
_OBD = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_SSF = (_P, _P, _P, _I, _I, _I, _I, _P)
#: Signatures of the exported launch functions (all return an int).
SIGNATURES = {
    # pos, params (rows of PARAMS_SIZE), energy, drift, num_walkers,
    # walkers_per_row, nop, is_free, is_ideal, defects_sep, stream
    "qmc_pair_energy_drift_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _P),
    "qmc_pair_energy_drift_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _P),
    # pos, params, log_psi, energy, drift, num_walkers, walkers_per_row,
    # nop, is_free, is_ideal, defects_sep, stream
    "qmc_pair_logpsi_energy_drift_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _P),
    "qmc_pair_logpsi_energy_drift_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _P),
    # pos, params, drift, g_lp, g_e, rows (W x PARAMS_SIZE), num_walkers,
    # nop, is_free, is_ideal, defects_sep, stream
    "qmc_pair_logpsi_params_vjp_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _P),
    "qmc_pair_logpsi_params_vjp_f64": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _P),
    # cpos, cdrift, cenergy, params, xi (or NULL), e_ref (0-d, on the
    # device), dt, sigma, key, step, npos, nenergy, ndrift, nweight,
    # num_walkers, nop, is_free, is_ideal, defects_sep, stream
    "qmc_diffuse_energy_drift_f32": _DIFFUSE,
    "qmc_diffuse_energy_drift_f64": _DIFFUSE,
    # pos, params (rows of PARAMS_SIZE), offsets (rows of num_pos), out,
    # num_walkers, walkers_per_row, nop, num_pos, is_free, is_ideal, stream
    "qmc_obd_grid_f32": _OBD,
    "qmc_obd_grid_f64": _OBD,
    # pos, supercell lengths (R rows), out, num_walkers, walkers_per_row, nop, num_modes,
    # stream
    "qmc_ssf_harmonics_f32": _SSF,
    "qmc_ssf_harmonics_f64": _SSF,
    # out, num_elements, key, step, scale, grid, stream
    "qmc_philox_normals_f32": _NORMALS,
    "qmc_philox_normals_f64": _NORMALS,
    # out (R rows), row_numel, R, keys (R uint64 on the device), scales
    # (R on the device), step, CTAs per row, stream
    "qmc_philox_normals_rows_f32": (_P, _I, _I, _P, _P, _U64, _I, _P),
    "qmc_philox_normals_rows_f64": (_P, _I, _I, _P, _P, _U64, _I, _P),
    # out (uint32 words), num_quads, key, step, grid, stream
    "qmc_philox_words": (_P, _I, _U64, _U64, _I, _P),
    # pos, bin_size (one per group of rows, on the device), out, num_rows,
    # rows per group, row_len, num_bins, warps per CTA, grid, stream
    "qmc_walker_histogram_f32": _HISTOGRAM,
    "qmc_walker_histogram_f64": _HISTOGRAM,
    # The same, with the bins per pass in place of the warps per CTA.
    "qmc_walker_histogram_tiled_f32": _HISTOGRAM,
    "qmc_walker_histogram_tiled_f64": _HISTOGRAM,
    # mismatches (one int32 on the device, added to), stream
    "qmc_check_box_muller": (_P, _P),
    # The CTAs per SM that a kernel's launch bounds keep resident.
    "qmc_philox_ctas_per_sm": (),
    "qmc_walker_histogram_ctas_per_sm": (),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "of phd_qmclib_torch cannot be built")
    return str(candidate)


def build() -> str:
    """Compile the library if it is missing or older than a source.

    Returns what ``nvcc`` printed (the ``-Xptxas -v`` report), or an
    empty string when the library was up to date.  The objects go to a
    fresh temporary directory and the library is written under a
    temporary name and renamed, so concurrent builds never load a
    half-written file.
    """
    newest_source = max(src.stat().st_mtime for src in SOURCES + HEADERS)
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest_source:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir)
        objects = [tmp / f"{src.stem}.o" for src in SOURCES]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(SOURCES, objects)]
        procs = []
        for cmd, obj in zip(compiles, objects):
            with open(obj.with_suffix(".log"), "w") as out:
                procs.append(subprocess.Popen(
                    cmd, stdout=out, stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait()
        logs = [obj.with_suffix(".log").read_text() for obj in objects]
        for cmd, proc, log in zip(compiles, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        tmp_lib = tmp / LIBRARY.name
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", str(tmp_lib), *map(str, objects)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp_lib, LIBRARY)
    return "".join(logs) + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def functions() -> dict:
    """The launch functions by exported name, looked up once."""
    lib = library()
    return {name: getattr(lib, name) for name in SIGNATURES}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def persistent_grid(num_tiles: int, sms: int, ctas_per_sm: int) -> int:
    """CTAs of a persistent kernel whose CTA ``c`` takes the tiles ``c,
    c + grid, c + 2 grid, ...``: every SM's resident CTAs, but no CTA
    without a tile."""
    return max(1, min(num_tiles, sms * ctas_per_sm))


# Bound when the module loads (None on a build of torch without CUDA,
# whose tensors never reach call()).
_get_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def call(fn, device: torch.device, *args) -> None:
    """Launch ``fn(*args, stream)`` on the current stream of ``device``
    (a CUDA ``torch.device`` with an index, as a tensor's is), entering
    the device only when it is not the current one; raise if the launch
    function returned a CUDA error."""
    index = device.index
    if _get_device() == index:
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")
