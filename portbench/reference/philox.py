"""The DMC step's Gaussian noise, worked out again.

The program keys its noise by ``(seed, global step index)`` with
Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1,
2, 3", SC11): key ``(seed mod 2^32, seed >> 32)``, counter ``(q mod
2^32, q >> 32, step mod 2^32, step >> 32)`` for the quad ``q`` of
elements ``4q .. 4q+3``.  Each quad's words ``(w0, w1, w2, w3)`` give
two pairs of 24-bit uniforms, ``u1 = (w >> 8 + 1) 2^-24`` in (0, 1] and
``u2 = (w >> 8) 2^-24`` in [0, 1), and Box-Muller turns each pair into
``r cos(2 pi u2), r sin(2 pi u2)``, ``r = sqrt(-2 log u1)``: elements
``4q, 4q+1`` from ``(w0, w1)`` and ``4q+2, 4q+3`` from ``(w2, w3)``.
The words are integers, so they are exact here; the transform runs in
the caller's dtype with library functions.
"""
import math

import torch

__all__ = ["normals", "philox_words"]

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``m * b`` in int64 arithmetic, ``b``
    split in 16-bit halves so that no partial product passes 2^63."""
    lo_prod = m * (b & 0xFFFF)
    hi_prod = m * (b >> 16)
    s = ((hi_prod & 0xFFFF) << 16) + lo_prod
    return (hi_prod >> 16) + (s >> 32), s & _MASK32


def philox_words(key: int, step: int, num_quads: int,
                 device) -> torch.Tensor:
    """Philox4x32-10 words ``(num_quads, 4)``, int64 in [0, 2^32)."""
    k0, k1 = key & _MASK32, key >> 32
    q = torch.arange(num_quads, dtype=torch.int64, device=device)
    c0, c1 = q & _MASK32, q >> 32
    c2 = torch.full_like(q, step & _MASK32)
    c3 = torch.full_like(q, step >> 32)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def normals(key: int, step: int, shape, dtype, device) -> torch.Tensor:
    """Standard normals of ``shape`` for ``(key, step)``."""
    numel = math.prod(shape)
    bits = (philox_words(key, step, -(-numel // 4), device) >> 8).to(dtype)
    u1 = (bits[:, 0::2] + 1.0) * 2.0 ** -24
    u2 = bits[:, 1::2] * 2.0 ** -24
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = (2 * math.pi) * u2
    out = torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)],
                      dim=-1)
    return out.reshape(-1)[:numel].reshape(shape)
