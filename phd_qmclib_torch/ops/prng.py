"""Counter-based Gaussian noise for the DMC diffusion step.

Counterpart of ``phd_qmclib_tpu.ops.prng.normal_pallas``.  The TPU
kernel draws its bits from the chip's hardware generator; here the bits
are Philox4x32-10, counter-based, so any element of any step can be
drawn independently and the CUDA kernel (``csrc/prng.cu``) and its
plain torch version give the same integer words:

* key ``(seed mod 2^32, seed >> 32)``;
* counter ``(q mod 2^32, q >> 32, step mod 2^32, step >> 32)`` for the
  quad ``q`` of output elements ``4q .. 4q+3``.

The four words ``(w0, w1, w2, w3)`` of a quad become two pairs of 24-bit
uniforms, ``u1 = (w >> 8) 2^-24 + 2^-24`` in (0, 1] and
``u2 = (w >> 8) 2^-24`` in [0, 1), and full Box-Muller with quarter-wave
polynomial cos/sin turns each pair into ``r cos`` and ``r sin``:
elements ``4q, 4q+1`` from ``(w0, w1)`` and ``4q+2, 4q+3`` from
``(w2, w3)``.  The transform runs in f32 whatever the output dtype.

:func:`normal` scales the normals as it draws them (``scale=``, bit for
bit ``scale * z``: torch's multiply of the f32 normal by the scale cast
to f32, or of the normal cast to f64 by the scale) and can write into a
buffer the caller keeps (``out=``), so that a sampler's noise costs one
launch and no allocation per step.
"""
import functools
import math

import torch

from . import _build, trig

__all__ = ["box_muller", "box_muller_mismatches", "check_key", "key_table",
           "normal", "normal_plain", "normal_rows", "normal_rows_plain",
           "philox_words", "philox_words_plain", "rows_grid"]

_MASK32 = 0xFFFFFFFF
#: Philox4x32 round multipliers and Weyl key increments (Salmon et al.,
#: "Parallel random numbers: as easy as 1, 2, 3", SC11).
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10


def _split64(value: int):
    """(low, high) 32-bit words of a non-negative integer below 2^64."""
    if not 0 <= value < 1 << 64:
        raise ValueError(f"{value} is not a 64-bit unsigned integer")
    return value & _MASK32, value >> 32


def check_key(key: int, step: int):
    """``(key, step)`` for the kernels' 64-bit C arguments; raises unless
    both are integers in [0, 2^64)."""
    if not (0 <= key < 1 << 64 and 0 <= step < 1 << 64):
        raise ValueError(f"key {key} and step {step} must be 64-bit "
                         f"unsigned integers")
    return key, step


# -- plain torch version ----------------------------------------------------

def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * b`` in int64 arithmetic.

    ``b`` splits into 16-bit halves so that no partial product reaches
    2^63: ``m*b = uh 2^32 + (ul 2^16 + t)`` with ``t = m*(b & 0xFFFF)``
    and ``u = m*(b >> 16) = uh 2^16 + ul``.
    """
    t = m * (b & 0xFFFF)
    u = m * (b >> 16)
    s = ((u & 0xFFFF) << 16) + t
    return (u >> 16) + (s >> 32), s & _MASK32


def _philox(c0, c1, c2, c3, k0: int, k1: int) -> torch.Tensor:
    """Philox4x32-10 of int64 counter words ``c0..c3`` (tensors of one
    shape, values in [0, 2^32)) under the key ``(k0, k1)``; returns the
    words stacked on a last axis of 4."""
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_words_plain(key: int, step: int, num_quads: int,
                       device="cpu") -> torch.Tensor:
    """Philox4x32-10 words ``(num_quads, 4)`` as int64 in [0, 2^32)."""
    k0, k1 = _split64(key)
    s0, s1 = _split64(step)
    q = torch.arange(num_quads, dtype=torch.int64, device=device)
    return _philox(q & _MASK32, q >> 32, torch.full_like(q, s0),
                   torch.full_like(q, s1), k0, k1)


def _cos_poly(arg: torch.Tensor) -> torch.Tensor:
    """cos(arg) for arg in [0, pi/2] (quarter-wave polynomial)."""
    return trig._horner(trig.COS_COEFFS, arg * arg)


def _sin_poly(arg: torch.Tensor) -> torch.Tensor:
    """sin(arg) for arg in [0, pi/2]."""
    return arg * trig._horner(trig.SIN_COEFFS, arg * arg)


def _fold(u2: torch.Tensor):
    """Quarter-wave folding of ``2 pi u2``: ``(b, flip, arg)`` with
    ``b`` in [-1, 1], ``cos(pi b) = cos(2 pi u2)`` and ``arg`` in
    [0, pi/2]."""
    a = 2.0 * u2
    b = a - 2.0 * torch.round(0.5 * a)
    c = b.abs()
    flip = c > 0.5
    arg = math.pi * torch.where(flip, 1.0 - c, c)
    return b, flip, arg


def _cos2pi(u: torch.Tensor) -> torch.Tensor:
    """cos(2 pi u) for u in [0, 1) via quarter-wave folding."""
    _, flip, arg = _fold(u)
    val = _cos_poly(arg)
    return torch.where(flip, -val, val)


def box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """Full Box-Muller: ``(r cos(2 pi u2), r sin(2 pi u2))`` with
    ``r = sqrt(-2 log u1)``, for ``u1`` in (0, 1] and ``u2`` in [0, 1)."""
    radius = torch.sqrt(-2.0 * torch.log(u1))
    b, flip, arg = _fold(u2)
    cosv = torch.where(flip, -1.0, 1.0) * _cos_poly(arg)
    sinv = torch.where(b >= 0, 1.0, -1.0) * _sin_poly(arg)
    return radius * cosv, radius * sinv


def normal_plain(key: int, step: int, shape, dtype=torch.float32,
                 device="cpu") -> torch.Tensor:
    """Plain torch version of the kernel: standard normals of ``shape``."""
    numel = math.prod(shape)
    words = philox_words_plain(key, step, -(-numel // 4), device)
    bits24 = (words >> 8).to(torch.float32)
    u1 = bits24[:, 0::2] * 2.0 ** -24 + 2.0 ** -24
    u2 = bits24[:, 1::2] * 2.0 ** -24
    zc, zs = box_muller(u1, u2)
    out = torch.stack([zc, zs], dim=-1).reshape(-1)[:numel]
    return out.reshape(shape).to(dtype)


# -- kernel wrappers ---------------------------------------------------------

#: Launch functions by output dtype.
_NORMALS = {torch.float32: "qmc_philox_normals_f32",
            torch.float64: "qmc_philox_normals_f64"}
#: Threads per CTA of the kernels of ``csrc/prng.cu`` (kThreads).
THREADS = 256


@functools.lru_cache(maxsize=None)
def _ctas_per_sm() -> int:
    return _build.functions()["qmc_philox_ctas_per_sm"]()


def _grid(num_quads: int, index: int) -> int:
    return _build.persistent_grid(-(-num_quads // THREADS),
                                  _build.sm_count(index), _ctas_per_sm())


@functools.lru_cache(maxsize=64)
def _like(dtype, device):
    """An empty tensor of ``dtype`` on ``device``, whose ``new_empty``
    allocates an output: on the card half the host time of
    ``torch.empty(shape, dtype=..., device=...)``, which parses its
    keyword arguments on every call.  None for a CUDA device without an
    index, which names whatever device is current at the call."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return None
    return torch.empty(0, dtype=dtype, device=device)


@functools.lru_cache(maxsize=256)
def _launch(dtype, numel: int, index: int):
    """The launch function and grid of the normals kernel for ``numel``
    elements of ``dtype`` on CUDA device ``index``."""
    name = _NORMALS.get(dtype)
    if name is None:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if numel >= 1 << 31:
        raise ValueError(f"{numel} elements exceed the kernel's int range")
    return _build.functions()[name], _grid(-(-numel // 4), index)


def _check_out(out: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``out`` is a contiguous tensor of ``shape`` and
    ``dtype`` on ``device``."""
    want = device if isinstance(device, torch.device) else torch.device(
        device)
    if out.shape != tuple(shape) or out.dtype != dtype \
            or out.device.type != want.type \
            or want.index not in (None, out.device.index) \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {tuple(shape)} tensor "
                         f"of {dtype} on {want}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")


def normal(key: int, step: int, shape, dtype=torch.float32,
           device="cuda", *, scale: float = 1.0,
           out: torch.Tensor = None) -> torch.Tensor:
    """``scale`` times standard normals of ``shape`` for ``(key, step)``.

    On a CUDA device (the default) this launches the kernel of
    ``csrc/prng.cu``; on ``device="cpu"`` it runs :func:`normal_plain`
    and the same multiply.  ``dtype`` is float32 or float64 (the values
    are f32 normals either way).  The result is bit for bit ``scale *
    z``.  With ``out`` (a contiguous tensor of ``shape``, ``dtype`` and
    ``device``) the values are written there and ``out`` is returned; no
    tensor is allocated.
    """
    if out is None:
        like = _like(dtype, device)
        out = (torch.empty(shape, dtype=dtype, device=device) if like is None
               else like.new_empty(shape))
    else:
        _check_out(out, shape, dtype, device)
    dev = out.device
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"no kernel for device {dev}")
        z = normal_plain(key, step, out.shape, out.dtype, dev)
        return torch.mul(z, scale, out=out)
    numel = out.numel()
    fn, grid = _launch(out.dtype, numel, dev.index)
    check_key(key, step)
    if numel == 0:
        return out
    _build.call(fn, dev, out.data_ptr(), numel, key, step, scale, grid)
    normal.launch_count += 1
    return out


#: Kernel launches since the last reset (set it to 0 to reset).
normal.launch_count = 0


# -- the rows of a fused parameter sweep ---------------------------------------

_NORMALS_ROWS = {torch.float32: "qmc_philox_normals_rows_f32",
                 torch.float64: "qmc_philox_normals_rows_f64"}


def key_table(keys, device="cuda") -> torch.Tensor:
    """The 64-bit keys ``keys`` (integers in [0, 2^64)) as the int64
    tensor :func:`normal_rows` reads on ``device``, each key's bits
    unchanged."""
    return torch.tensor([k - (1 << 64) if k >= 1 << 63 else k
                         for k in (check_key(k, 0)[0] for k in keys)],
                        dtype=torch.int64, device=device)


def normal_rows_plain(keys: torch.Tensor, step: int, scales: torch.Tensor,
                      out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the rows kernel: row ``r`` of ``out`` is
    :func:`normal` of ``(keys[r], step)`` at the row's shape, scaled by
    ``scales[r]``, row by row."""
    for key, scale, row in zip(keys.tolist(), scales.tolist(), out):
        z = normal_plain(key & 0xFFFFFFFFFFFFFFFF, step, row.shape,
                         row.dtype, row.device)
        torch.mul(z, scale, out=row)
    return out


def normal_rows(keys: torch.Tensor, step: int, scales: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """The noise of a fused parameter sweep's rows in one launch.

    ``out (R, ...)`` is a contiguous float32 or float64 tensor; row
    ``r`` gets ``scales[r]`` times the standard normals of ``(keys[r],
    step)``, its quads counted from 0 inside the row: bit for bit
    ``normal(keys[r], step, out.shape[1:], scale=scales[r])``, whatever
    the row's length (its unaligned tail included).  ``keys`` is
    :func:`key_table`'s int64 tensor and ``scales`` an ``(R,)`` tensor
    of ``out``'s dtype, both on ``out``'s device: nothing crosses from
    the host per call.  A CUDA tensor launches the rows kernel of
    ``csrc/prng.cu`` (one launch adds one to
    ``normal_rows.launch_count``); a CPU tensor runs
    :func:`normal_rows_plain`.
    """
    num_rows = out.shape[0] if out.dim() else 0
    dev = out.device
    if keys.shape != (num_rows,) or scales.shape != (num_rows,) \
            or keys.dtype != torch.int64 or scales.dtype != out.dtype \
            or keys.device != dev or scales.device != dev:
        raise ValueError("keys and scales must be (R,) tensors (int64 and "
                         "out's dtype) on out's device, R = out.shape[0]")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"no kernel for device {dev}")
        return normal_rows_plain(keys, step, scales, out)
    numel = out.numel()
    if numel == 0:
        return out
    fn, grid = _launch_rows(out.dtype, num_rows, numel // num_rows,
                            dev.index)
    check_key(0, step)
    _build.call(fn, dev, out.data_ptr(), numel // num_rows, num_rows,
                keys.data_ptr(), scales.data_ptr(), step, grid)
    normal_rows.launch_count += 1
    return out


@functools.lru_cache(maxsize=256)
def _launch_rows(dtype, num_rows: int, row_numel: int, index: int):
    """The launch function and grid of the rows kernel for ``num_rows``
    rows of ``row_numel`` elements of ``dtype`` on CUDA device
    ``index``."""
    name = _NORMALS_ROWS.get(dtype)
    if name is None:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if row_numel >= 1 << 31:
        raise ValueError(f"{row_numel} elements a row exceed the kernel's "
                         f"int range")
    return (_build.functions()[name],
            rows_grid(num_rows, row_numel, _build.sm_count(index),
                      _ctas_per_sm()))


def rows_grid(num_rows: int, row_numel: int, sms: int,
              ctas_per_sm: int) -> int:
    """CTAs per row of the rows kernel, which launches ``num_rows``
    times as many: the persistent grid of all the rows' quads
    (:func:`~phd_qmclib_torch.ops._build.persistent_grid`) shared among
    the rows, at least one CTA a row and no more than a row's quads
    fill."""
    row_tiles = -(-(-(-row_numel // 4)) // THREADS)
    total = _build.persistent_grid(num_rows * row_tiles, sms, ctas_per_sm)
    return max(1, min(row_tiles, total // num_rows))


#: Kernel launches since the last reset (set it to 0 to reset).
normal_rows.launch_count = 0


def box_muller_mismatches(device="cuda") -> int:
    """How many of the 2^24 values of a 24-bit uniform the kernels'
    Box-Muller (``csrc/philox.cuh``: the log without its branches for
    arguments it never sees, the folding with conditional negations)
    turn into another radius, cosine or sine, in any bit, than the plain
    CUDA form (``sqrtf(-2 logf(u1))``, the +-1 multiplies) does: 0 when
    the kernels draw the accurate ``logf``'s numbers.  Runs the check
    kernel of ``csrc/prng.cu`` on a CUDA ``device``."""
    count = torch.zeros((), dtype=torch.int32, device=device)
    if count.device.type != "cuda":
        raise ValueError(f"no kernel for device {count.device}")
    _build.call(_build.functions()["qmc_check_box_muller"], count.device,
                count.data_ptr())
    return int(count)


def philox_words(key: int, step: int, num_quads: int,
                 device="cuda") -> torch.Tensor:
    """Philox4x32-10 words ``(num_quads, 4)`` as int64 in [0, 2^32): the
    kernel's own bits on a CUDA device, for holding them against
    :func:`philox_words_plain`; :func:`philox_words_plain` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_words_plain(key, step, num_quads, device)
    if not 0 < num_quads < 1 << 29:
        raise ValueError(f"num_quads out of range: {num_quads}")
    out = torch.empty((num_quads, 4), dtype=torch.int32, device=device)
    _build.call(_build.functions()["qmc_philox_words"], out.device,
                out.data_ptr(), num_quads, *check_key(key, step),
                _grid(num_quads, out.device.index))
    return out.to(torch.int64) & _MASK32
