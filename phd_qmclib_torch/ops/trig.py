"""Reduced-range trig polynomials shared by the hot kernels.

Counterpart of ``phd_qmclib_tpu.ops.trig``: the same coefficient
tuples, which ``csrc/pairwise.cu`` and ``csrc/prng.cu`` repeat as
constants, and the torch evaluators that the plain versions of those
kernels use.

All evaluators assume the caller guarantees the reduced domain
``(-pi/2, pi/2]`` — no range reduction here.
"""
import torch

__all__ = [
    "SIN_COEFFS", "COS_COEFFS", "TAN_P_COEFFS", "TAN_Q_COEFFS",
    "sincos_poly32", "tancot_poly32",
]

#: Least-squares-on-Chebyshev-nodes coefficients of ``sin(x)/x`` and
#: ``cos(x)`` in ``x^2`` over ``[-pi/2, pi/2]``; max abs error 1.6e-7 /
#: 1.4e-7 in f32 arithmetic (~1 ULP).
SIN_COEFFS = (1.0, -1.66666666e-01, 8.33333098e-03, -1.98408615e-04,
              2.75252866e-06, -2.38894895e-08)
COS_COEFFS = (1.0, -4.99999994e-01, 4.16666362e-02, -1.38883608e-03,
              2.47601348e-05, -2.60510641e-07)

#: Order-13 continued-fraction truncation of tan, normalized:
#: tan x = x P(x^2)/Q(x^2).  The pole of the truncation sits at Q's
#: root next to pi/2, so a cot computed as Q/(xP) stays absolutely
#: accurate (1.6e-7) right where cot -> 0.
TAN_P_COEFFS = (1.0, -0.12820512820512820, 2.7972027972027972e-03,
                -7.4000074000074000e-06)
TAN_Q_COEFFS = (1.0, -0.46153846153846154, 2.3310023310023310e-02,
                -2.0720020720020720e-04)


def _horner(coeffs, z2: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(z2, coeffs[-1])
    for k in range(len(coeffs) - 2, -1, -1):
        acc = acc * z2 + coeffs[k]
    return acc


def sincos_poly32(x: torch.Tensor):
    """(sin x, cos x) for ``x`` in ``(-pi/2, pi/2]`` via reduced-range
    polynomials, accurate to ~1 f32 ULP."""
    z2 = x * x
    return x * _horner(SIN_COEFFS, z2), _horner(COS_COEFFS, z2)


def tancot_poly32(x: torch.Tensor):
    """``(x*P(x^2), Q(x^2))`` with ``tan x ~= xP/Q`` on
    ``(-pi/2, pi/2]``.

    The forward path consumes only the ratio (tan inside the cutoff,
    cot outside), so this rational replaces the sin/cos pair at
    two-thirds the op count.  f32 accuracy over the full argument
    domain: 1.44e-6 max relative (tan), 1.6e-7 absolute for cot near
    pi/2."""
    z2 = x * x
    return x * _horner(TAN_P_COEFFS, z2), _horner(TAN_Q_COEFFS, z2)
