"""ctypes bindings to the native (C++) reblocking cascade.

The port's counterpart of the JAX package's ``stats/native.py``: the
same cascade (``phd_qmclib_torch/csrc/reblock.cpp``, the same code as
the JAX package's ``csrc/reblock.cpp``), compiled with ``g++`` and the
same flags (``-O3 -march=native -fPIC -shared -std=c++17``) into
``build/libreblock.so`` at the root of the checkout the first time it is
asked for, and again when the source is newer than the library.  The
object goes to a fresh temporary directory under ``build/`` and is
renamed into place, so processes that build at once never load a
half-written file.  Nothing builds at import.

``stats.reblock.on_the_fly_obj_create`` uses the library for series of
at least 2^14 values, as the JAX package does; without ``g++`` on
``PATH`` it is not available and the tables come from the vectorized
NumPy path.  A build that is attempted and fails raises with the
compiler's message.  Disable explicitly with
``PHD_QMCLIB_TORCH_NATIVE=0``.
"""
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import typing as t
from pathlib import Path

import numpy as np

__all__ = ["build", "native_available", "otf_reblock_native", "LIBRARY",
           "SOURCE"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "reblock.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIBRARY = BUILD_DIR / "libreblock.so"
#: ``csrc/Makefile``'s flags.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def build(cxx: str) -> str:
    """Compile the library with ``cxx`` if it is missing or older than its
    source.  Returns what the compiler printed, or an empty string when
    the library was up to date."""
    if LIBRARY.exists() \
            and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp_lib = Path(tmp_dir) / LIBRARY.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp_lib), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp_lib, LIBRARY)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> t.Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; ``None`` when no
    ``g++`` is on ``PATH``."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    build(cxx)
    lib = ctypes.CDLL(str(LIBRARY))
    lib.otf_reblock_f64.restype = None
    lib.otf_reblock_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # data
        ctypes.c_int64,                   # n
        ctypes.c_int64,                   # num_cols
        ctypes.c_int64,                   # max_order
        ctypes.POINTER(ctypes.c_double),  # means_sum
        ctypes.POINTER(ctypes.c_double),  # means_sqr_sum
        ctypes.POINTER(ctypes.c_int64),   # num_blocks
    ]
    return lib


def native_available() -> bool:
    """Whether the library is switched on and built (building it at the
    first call)."""
    if os.environ.get("PHD_QMCLIB_TORCH_NATIVE", "1") == "0":
        return False
    return _library() is not None


def otf_reblock_native(data: np.ndarray, max_order: int) \
        -> t.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the native cascade on ``data (n, num_cols)`` float64.

    Returns ``(means_sum, means_sqr_sum, num_blocks)`` each of shape
    ``(num_cols, max_order + 1)``.
    """
    if not native_available():
        raise RuntimeError("the native reblocking library is switched off "
                           "or has no compiler to build it")
    lib = _library()
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError(f"data must be (n, num_cols), got {data.shape}")
    n, num_cols = data.shape
    if not 0 <= max_order < 63:
        raise ValueError(f"max_order {max_order} outside [0, 63)")
    orders = max_order + 1
    means_sum = np.zeros((num_cols, orders), dtype=np.float64)
    means_sqr_sum = np.zeros((num_cols, orders), dtype=np.float64)
    num_blocks = np.zeros((num_cols, orders), dtype=np.int64)
    lib.otf_reblock_f64(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, num_cols, max_order,
        means_sum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        means_sqr_sum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        num_blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return means_sum, means_sqr_sum, num_blocks
