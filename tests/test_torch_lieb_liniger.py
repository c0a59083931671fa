"""The port's copy of the exact Lieb-Liniger solver against the JAX
package's original (bit-equal: the code is a copy), and against the
closed-form limits on the copy itself."""
import numpy as np
import pytest

from phd_qmclib_torch import lieb_liniger as tll
from phd_qmclib_tpu import lieb_liniger as jll

GAMMAS = (0.01, 0.5, 2.0, 50.0, 5000.0)


def test_public_names_match():
    assert tll.__all__ == jll.__all__


@pytest.mark.parametrize("gamma", GAMMAS)
def test_ground_state_energy_matches(gamma):
    assert tll.ground_state_energy(gamma, num_points=128) \
        == jll.ground_state_energy(gamma, num_points=128)


@pytest.mark.parametrize("gamma", GAMMAS)
def test_ground_state_matches(gamma):
    got = tll.ground_state(gamma, density=1.5, num_points=128)
    want = jll.ground_state(gamma, density=1.5, num_points=128)
    assert set(got) == set(want)
    for name, value in got.items():
        assert value == want[name], name


@pytest.mark.parametrize("gamma", GAMMAS)
def test_sound_speed_and_luttinger_parameter_match(gamma):
    assert tll.sound_speed(gamma, 0.7, num_points=128) \
        == jll.sound_speed(gamma, 0.7, num_points=128)
    assert tll.luttinger_parameter(gamma, num_points=128) \
        == jll.luttinger_parameter(gamma, num_points=128)


def test_tonks_girardeau_limit():
    e = tll.ground_state_energy(1e5, num_points=256)
    assert e == pytest.approx(np.pi ** 2 / 3, rel=2e-4)
    gs = tll.ground_state(1e5, num_points=256)
    assert gs["sound_speed"] == pytest.approx(2 * np.pi, rel=2e-4)
    assert gs["luttinger_k"] == pytest.approx(1.0, rel=2e-4)


def test_tonks_girardeau_expansion_at_gamma_5000():
    """The large-coupling expansion ``e = pi^2/3 (1 - 4/gamma)`` the
    card's Tonks-Girardeau energy check leans on, against the exact
    solver."""
    e = tll.ground_state_energy(5000.0, num_points=256)
    assert e == pytest.approx(np.pi ** 2 / 3 * (1 - 4 / 5000.0), rel=1e-5)


def test_bogoliubov_limit():
    g = 0.01
    e = tll.ground_state_energy(g, num_points=256)
    assert e == pytest.approx(g * (1 - 4 * np.sqrt(g) / (3 * np.pi)),
                              rel=1e-3)
    c = tll.sound_speed(g, num_points=256)
    c_weak = 2 * np.sqrt(g) * np.sqrt(1 - np.sqrt(g) / (2 * np.pi))
    assert c == pytest.approx(c_weak, rel=1e-4)


def test_gamma_two_pinned():
    gs = tll.ground_state(2.0, num_points=256)
    assert gs["e"] == pytest.approx(1.050321, abs=2e-5)
    assert gs["sound_speed"] == pytest.approx(2.490588, abs=2e-5)
    assert gs["mu"] == pytest.approx(2.456471, abs=2e-5)
    assert gs["luttinger_k"] == pytest.approx(2.522772, abs=5e-5)
    assert gs["ssf_slope"] == pytest.approx(1 / gs["sound_speed"])
    assert gs["chi_k0"] == pytest.approx(-2 / gs["sound_speed"] ** 2)


def test_density_scaling():
    a = tll.ground_state(2.0, density=1.0, num_points=256)
    b = tll.ground_state(2.0, density=2.0, num_points=256)
    assert b["sound_speed"] == pytest.approx(2 * a["sound_speed"])
    assert b["e"] == pytest.approx(4 * a["e"])
    assert b["mu"] == pytest.approx(4 * a["mu"])
    assert b["luttinger_k"] == pytest.approx(a["luttinger_k"])


def test_thermodynamic_consistency_mu():
    c_ll, n0, dn = 1.0, 1.0, 1e-4

    def eps_density(n):
        return n ** 3 * tll.ground_state_energy(c_ll / n, num_points=256)

    mu_fd = (eps_density(n0 + dn) - eps_density(n0 - dn)) / (2 * dn)
    mu = tll.ground_state(c_ll / n0, density=n0, num_points=256)["mu"]
    assert mu == pytest.approx(mu_fd, rel=1e-5)


def test_invalid_coupling_rejected():
    for module in (tll, jll):
        with pytest.raises(ValueError, match="repulsive"):
            module.ground_state_energy(0.0)
