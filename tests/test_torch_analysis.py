"""The port's copy of the analysis helpers against the JAX package's
original: every public function on seeded inputs, equal bit for bit (the
code is a copy), then a few closed-form checks on the copy itself."""
import inspect

import numpy as np
import pytest

from phd_qmclib_torch import analysis as tanalysis
from phd_qmclib_tpu import analysis as janalysis

L, N = 16.0, 8


def _rng():
    return np.random.default_rng(41)


def _obdm():
    rng = _rng()
    offsets = np.linspace(0.0, L / 2, 33)
    n1 = 0.6 + 0.4 * np.exp(-offsets) + 1e-3 * rng.normal(size=33)
    return offsets, n1, np.full(33, 2e-3)


def _ssf():
    rng = _rng()
    momenta = np.arange(12) * 2 * np.pi / L
    ssf = np.concatenate([[N], momenta[1:] / (momenta[1:] + 1.5)])
    ssf = ssf + 1e-3 * rng.normal(size=12)
    return momenta, ssf, np.full(12, 2e-3)


def _g2():
    rng = _rng()
    edges = np.linspace(0, L / 2, 65)
    r = 0.5 * (edges[1:] + edges[:-1])
    g2 = (0.5 + 0.9 * r) / (1 + 0.9 * r) + 1e-3 * rng.normal(size=64)
    return r, g2, np.full(64, 2e-3)


def _cmd():
    rng = _rng()
    blocks, nts, nw = 4, 64, 50.0
    tau = 1e-3 * (np.arange(nts) + 1)
    w2 = 2 * 0.8 / N * tau * (1 + 0.05 * rng.normal(size=(blocks, nts)))
    iter_cmd = np.stack([w2 * nw, 1e-3 * nw * rng.normal(
        size=(blocks, nts))], axis=-1)
    return 1e-3, iter_cmd, np.full((blocks, nts), nw), N


def _itc():
    tau = np.arange(33) * 0.125
    f = 0.7 * np.exp(-1.0 * tau) + 0.3 * np.exp(-3.5 * tau)
    return tau, f, np.full_like(f, 1e-4)


def _density():
    rng = _rng()
    z = (np.arange(64) + 0.5) * L / 64
    rho = N / L * (1 + 0.3 * np.cos(2 * np.pi * z / 4.0)) \
        + 1e-3 * rng.normal(size=64)
    return rho, np.full(64, 1e-3)


#: One call per public function: the arguments, and the keywords.
CALLS = {
    "contact_from_pair_correlation": lambda: (_g2() + (2.0,), {}),
    "density_from_ssf": lambda: (
        (_ssf()[0], _rng().normal(size=12), _rng().normal(size=12) * 0.1,
         np.linspace(0, L, 40, endpoint=False), L, N),
        dict(re_err=np.full(12, 1e-2), im_err=np.full(12, 1e-2))),
    "effective_mass_from_cm_diffusion": lambda: (_cmd(), {}),
    "extrapolated_estimate": lambda: (
        (np.array([1.0, 0.8, 0.5]), np.array([1.1, 0.7, 0.45])),
        dict(mixed_err=np.full(3, 0.01), variational_err=np.full(3, 0.02))),
    "feynman_spectrum": lambda: (_ssf(), {}),
    "leggett_bound": lambda: (_density(), {}),
    "luttinger_parameter_from_obdm": lambda: (
        (_obdm()[0], _obdm()[1], L), dict(n1_err=_obdm()[2])),
    "momentum_distribution": lambda: (
        (_obdm()[0], _obdm()[1], L, N), dict(n1_err=_obdm()[2])),
    "pair_correlation_from_counts": lambda: (
        (_rng().integers(100, 200, 64).astype(float), N, L),
        dict(counts_err=np.full(64, 3.0))),
    "pair_correlation_from_ssf": lambda: (
        (_ssf()[0], _ssf()[1] * N, np.linspace(0, L / 2, 30), N, L),
        dict(rho2_err=_ssf()[2] * N)),
    "sound_speed_from_ssf": lambda: (_ssf(), {}),
    "spectral_function_from_itc": lambda: (_itc(), dict(num_omega=48)),
    "zero_limit_extrapolation": lambda: (
        (np.array([1e-3, 2e-3, 4e-3, 8e-3]),
         np.array([8.4151, 8.4162, 8.4183, 8.4229]), np.full(4, 2e-4)),
        dict(order=2)),
}


def _public(module):
    return sorted(name for name, fn
                  in inspect.getmembers(module, inspect.isfunction)
                  if not name.startswith("_")
                  and fn.__module__ == module.__name__)


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}[{key}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def test_every_public_function_has_a_case():
    assert _public(tanalysis) == _public(janalysis) == sorted(CALLS)
    assert tanalysis.__all__ == janalysis.__all__


@pytest.mark.parametrize("name", sorted(CALLS))
def test_function_matches_the_original(name):
    args, kwargs = CALLS[name]()
    got = getattr(tanalysis, name)(*args, **kwargs)
    want = getattr(janalysis, name)(*args, **kwargs)
    _assert_same(got, want, name)
    flat = np.concatenate([np.ravel(np.asarray(x, dtype=float))
                           for x in (got if isinstance(got, tuple)
                                     else (got,))
                           if not isinstance(x, dict)])
    assert np.isfinite(flat).any()


# -- closed forms, on the copy -------------------------------------------------

def test_condensate_fraction_from_a_known_obdm():
    """The k = 0 occupation over N is the condensate fraction."""
    M = 33
    offsets = np.linspace(0.0, L / 2, M)
    momenta = np.arange(M) * 2 * np.pi / L
    f = np.zeros(M)
    f[0], f[1], f[2] = 5.0, 1.2, 0.3
    n1 = (f[0] + 2 * (f[1:, None]
                      * np.cos(momenta[1:, None] * offsets)).sum(0)) / N
    k, occ = tanalysis.momentum_distribution(offsets, n1, L, N)
    np.testing.assert_allclose(k, momenta)
    np.testing.assert_allclose(occ[:3], f[:3], atol=1e-10)
    np.testing.assert_allclose(occ[3:], 0.0, atol=1e-10)
    assert occ[0] / N == pytest.approx(0.625)
    _, occ = tanalysis.momentum_distribution(offsets, np.ones(M), L, N)
    assert occ[0] / N == pytest.approx(1.0)


def test_spectral_function_tg_free_fermion_inversion():
    """At the Tonks-Girardeau point F(k, tau) is a sum of free-fermion
    particle-hole decays: the inversion must put the weight inside the
    particle-hole band and reproduce the channel moments."""
    nop, sc = 5, 5.0
    q = 2 * np.pi / sc * np.arange(-(nop // 2), nop // 2 + 1)
    fermi = set(np.round(q, 12))
    for j in (1, 2):
        k = j * 2 * np.pi / sc
        omegas = np.array([(qi + k) ** 2 - qi ** 2 for qi in q
                           if round(qi + k, 12) not in fermi])
        tau = np.linspace(0, 3.0 / omegas.min(), 48)
        f = np.exp(-np.outer(tau, omegas)).sum(axis=1) / nop
        om, s, info = tanalysis.spectral_function_from_itc(
            tau, f, np.full_like(f, 1e-5 * f[0]), num_omega=128,
            omega_max=1.5 * omegas.max())
        assert info["m0"] == pytest.approx(omegas.size / nop, rel=0.01)
        assert info["m1"] == pytest.approx(omegas.sum() / nop, rel=0.02)
        pad = 2.0 / tau[-1]
        inside = (om >= omegas.min() - pad) & (om <= omegas.max() + pad)
        frac = np.trapezoid(np.where(inside, s, 0.0), om) / info["m0"]
        assert frac > 0.95


def test_spectral_function_rejects_unusable_input():
    tau = np.arange(5) * 0.1
    with pytest.raises(ValueError):
        tanalysis.spectral_function_from_itc(
            tau, np.array([1.0, np.nan, np.nan, np.nan, 0.5]))
    with pytest.raises(ValueError):
        tanalysis.spectral_function_from_itc(tau, -np.ones(5))
    with pytest.raises(ValueError):
        tanalysis.spectral_function_from_itc(tau, np.exp(+tau))


def test_feynman_spectrum_tonks_girardeau_phonon():
    """TG: S(k) = k / (2 k_F) below 2 k_F, so the Feynman bound
    ``k^2 / S(k)`` is the linear phonon ``2 k_F k``."""
    k_f = np.pi * N / L
    momenta = np.arange(6) * 2 * np.pi / L
    ssf = np.concatenate([[0.0], momenta[1:] / (2 * k_f)])
    k, omega = tanalysis.feynman_spectrum(momenta, ssf)
    np.testing.assert_allclose(omega, 2 * k_f * k, rtol=1e-12)


def test_pair_correlation_from_counts_uniform_is_one():
    num_bins = 32
    dr = 0.5 * L / num_bins
    counts = np.full(num_bins, N * (N - 1) * dr / L)
    r, g2, err = tanalysis.pair_correlation_from_counts(counts, N, L)
    np.testing.assert_allclose(g2, 1.0, rtol=1e-12)
    assert r.shape == (num_bins,)
