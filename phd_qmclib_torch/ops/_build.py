"""Build and load the hand-written CUDA kernels.

``csrc/*.cu`` (with the device code they share in ``csrc/*.cuh``)
compile with ``nvcc`` into one shared library with a plain C interface,
``build/libqmc_kernels.so`` at the root of the checkout, the first time
a kernel is launched (or again when a source or header is newer than
the library).  Each source compiles in its own ``nvcc`` process,
all started together, and one more links the objects.  The library is
loaded with ``ctypes``: every pointer and the stream pass as
``c_void_p``, every integer as ``c_int``, and every launch function
returns its ``cudaGetLastError()``.

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

__all__ = ["build", "check", "library", "BUILD_DIR", "HEADERS", "SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "pairwise.cu", CSRC / "prng.cu", CSRC / "histogram.cu",
           CSRC / "diffuse.cu")
#: Device code included by several sources.
HEADERS = (CSRC / "pair_terms.cuh", CSRC / "philox.cuh", CSRC / "trig.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIBRARY = BUILD_DIR / "libqmc_kernels.so"

#: Hopper only (``sm_90a``); no ``--use_fast_math``: the one-body terms
#: need the accurate ``tanf``/``tanhf`` and the Box-Muller radius the
#: accurate ``logf``.  ``-Xptxas -v`` reports registers, shared memory
#: and spills per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_DIFFUSE = (_P, _P, _P, _P, _P, _P, _D, _D, _I, _I, _I, _I, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _P)
#: Signatures of the exported launch functions (all return an int).
SIGNATURES = {
    # pos, params, energy, drift, num_walkers, nop, is_free, is_ideal,
    # defects_sep, stream
    "qmc_pair_energy_drift_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "qmc_pair_energy_drift_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # pos, params, log_psi, energy, drift, num_walkers, nop, is_free,
    # is_ideal, defects_sep, stream
    "qmc_pair_logpsi_energy_drift_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _P),
    "qmc_pair_logpsi_energy_drift_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _P),
    # cpos, cdrift, cenergy, params, xi (or NULL), e_ref (0-d, on the
    # device), dt, sigma, key_lo, key_hi, step_lo, step_hi, npos,
    # nenergy, ndrift, nweight, num_walkers, nop, is_free, is_ideal,
    # defects_sep, stream
    "qmc_diffuse_energy_drift_f32": _DIFFUSE,
    "qmc_diffuse_energy_drift_f64": _DIFFUSE,
    # out, num_elements, key_lo, key_hi, step_lo, step_hi, stream
    "qmc_philox_normals_f32": (_P, _I, _I, _I, _I, _I, _P),
    "qmc_philox_normals_f64": (_P, _I, _I, _I, _I, _I, _P),
    # out (uint32 words), num_quads, key_lo, key_hi, step_lo, step_hi,
    # stream
    "qmc_philox_words": (_P, _I, _I, _I, _I, _I, _P),
    # pos, bin_size (0-d, on the device), out, num_rows, row_len,
    # num_bins, stream
    "qmc_walker_histogram_f32": (_P, _P, _P, _I, _I, _I, _P),
    "qmc_walker_histogram_f64": (_P, _P, _P, _I, _I, _I, _P),
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


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
