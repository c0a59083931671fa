"""The port's estimator functions against the JAX package's ``core_funcs``,
in f64 on the CPU: the S(k) harmonics, the OBDM grid and the pair-distance
histogram (g2), on the free, ideal, bench and defected specs.

Inputs are made with numpy from a seed and fed to both packages.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_tpu.models import mrbp as jmrbp

torch.set_num_threads(1)

#: The same formulas, summed in another order: 1e-12 relative to the
#: scale of each quantity (N^2 for |rho_k|^2, N for Re/Im rho_k, 1 for
#: the OBDM).
RTOL = 1e-12

BENCH = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
             boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.4)
SPECS = {
    "free": dict(BENCH, lattice_depth=0.0, tbf_contact_cutoff=2.0),
    "ideal": dict(BENCH, interaction_strength=0.0),
    "bench": BENCH,
    "defected": dict(BENCH, boson_number=32, supercell_size=32.0,
                     num_defects=4, defect_magnitude=10.0),
}


def _setup(name, num_walkers=8, seed=0):
    kwargs = SPECS[name]
    jspec = jmrbp.Spec(**kwargs)
    pos = np.random.default_rng(seed).uniform(
        0, kwargs["supercell_size"], (num_walkers, kwargs["boson_number"]))
    return (jmrbp.core_funcs(jspec), jax.tree.map(jnp.float64,
                                                  jspec.cfc_params),
            jnp.asarray(pos),
            tmrbp.core_funcs(tmrbp.Spec(**kwargs)),
            tmrbp.cfc_params_from_numpy(jspec.cfc_params),
            torch.as_tensor(pos))


@pytest.mark.parametrize("num_modes", [1, 2, 7])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_ssf_harmonics_match_jax(name, num_modes):
    jfuncs, jcfc, jpos, tfuncs, tcfc, tpos = _setup(name)
    nop = tpos.shape[-1]
    want = np.asarray(jfuncs.fourier_density_parts_harmonics(
        num_modes, jpos, jcfc))
    got = tfuncs.fourier_density_parts_harmonics(num_modes, tpos, tcfc)
    assert got.shape == (8, num_modes, 3)
    np.testing.assert_allclose(got[..., 0].numpy(), want[..., 0],
                               rtol=RTOL, atol=RTOL * nop ** 2)
    np.testing.assert_allclose(got[..., 1:].numpy(), want[..., 1:],
                               rtol=RTOL, atol=RTOL * nop)
    # The k = 0 mode is exact: |rho_0|^2 = N^2, rho_0 = N.
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  np.tile([nop ** 2, nop, 0.0], (8, 1)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_obdm_grid_matches_jax(name):
    jfuncs, jcfc, jpos, tfuncs, tcfc, tpos = _setup(name)
    offsets = np.linspace(0.0, 0.5 * SPECS[name]["supercell_size"], 6)
    want = np.asarray(jfuncs.one_body_density_grid(jnp.asarray(offsets),
                                                   jpos, jcfc))
    got = tfuncs.one_body_density_grid(torch.as_tensor(offsets), tpos, tcfc)
    assert got.shape == (8, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL)
    # No displacement, no change: n1(0) = 1.
    np.testing.assert_allclose(got[:, 0].numpy(), 1.0, rtol=RTOL)


OBD_JAX_FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
                   / "obd_grid_jax.npz")


@pytest.mark.parametrize("name", ["bench", "defected", "free", "ideal"])
def test_obdm_grid_fixture_is_the_jax_packages(name):
    """``fixtures/obd_grid_jax.npz``, which the card's OBDM kernel is held
    against (``test_torch_cuda_kernels.py``), is what the JAX package
    computes at its inputs now, and the port's plain version agrees."""
    with np.load(OBD_JAX_FIXTURE) as fixture:
        kwargs = json.loads(str(fixture[f"{name}_spec"]))
        pos, offsets, stored = (fixture[f"{name}_{key}"]
                                for key in ("pos", "offsets", "obd"))
    assert pos.shape == (8, 128) and stored.shape == (8, 32)
    assert offsets[-1] == 0.5 * kwargs["supercell_size"]
    jspec = jmrbp.Spec(**kwargs)
    want = np.asarray(jmrbp.core_funcs(jspec).one_body_density_grid(
        jnp.asarray(offsets), jnp.asarray(pos),
        jax.tree.map(jnp.float64, jspec.cfc_params)))
    np.testing.assert_allclose(want, stored, rtol=1e-14, atol=1e-14)
    tspec = tmrbp.Spec(**kwargs)
    got = tmrbp.core_funcs(tspec).one_body_density_grid(
        torch.as_tensor(offsets), torch.as_tensor(pos),
        tmrbp.cfc_params_from_numpy(jspec.cfc_params))
    np.testing.assert_allclose(got.numpy(), stored, rtol=RTOL, atol=RTOL)


SSF_JAX_FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
                   / "ssf_harmonics_jax.npz")


@pytest.mark.parametrize("name", ["odd", "production", "sk"])
def test_ssf_harmonics_fixture_is_the_jax_packages(name):
    """``fixtures/ssf_harmonics_jax.npz``, which the card's S(k) kernel is
    held against (``test_torch_cuda_kernels.py``), is what the JAX package
    computes at its inputs now, and the port's plain version agrees."""
    with np.load(SSF_JAX_FIXTURE) as fixture:
        kwargs = json.loads(str(fixture[f"{name}_spec"]))
        num_modes = int(fixture[f"{name}_modes"])
        pos, stored = fixture[f"{name}_pos"], fixture[f"{name}_parts"]
    nop = kwargs["boson_number"]
    assert pos.shape == (8, nop) and stored.shape == (8, num_modes, 3)
    jspec = jmrbp.Spec(**kwargs)
    want = np.asarray(jmrbp.core_funcs(jspec).fourier_density_parts_harmonics(
        num_modes, jnp.asarray(pos),
        jax.tree.map(jnp.float64, jspec.cfc_params)))
    np.testing.assert_allclose(want, stored, rtol=1e-14, atol=1e-14 * nop**2)
    tfuncs = tmrbp.core_funcs(tmrbp.Spec(**kwargs))
    got = tfuncs.fourier_density_parts_harmonics(
        num_modes, torch.as_tensor(pos),
        tmrbp.cfc_params_from_numpy(jspec.cfc_params)).numpy()
    np.testing.assert_allclose(got[..., 0], stored[..., 0], rtol=RTOL,
                               atol=RTOL * nop ** 2)
    np.testing.assert_allclose(got[..., 1:], stored[..., 1:], rtol=RTOL,
                               atol=RTOL * nop)


@pytest.mark.parametrize("num_bins", [7, 16])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_pair_dist_histogram_matches_jax(name, num_bins):
    jfuncs, jcfc, jpos, tfuncs, tcfc, tpos = _setup(name)
    nop = tpos.shape[-1]
    want = np.asarray(jfuncs.pair_dist_histogram(num_bins, jpos, jcfc))
    got = tfuncs.pair_dist_histogram(num_bins, tpos, tcfc)
    assert got.shape == (8, num_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(-1).numpy(),
                                  nop * (nop - 1) / 2)


def test_estimators_take_leading_axes():
    """``(..., N)`` positions: a (2, 4, N) batch equals its rows."""
    _, _, _, tfuncs, tcfc, tpos = _setup("bench")
    batched = tpos.reshape(2, 4, -1)
    offsets = torch.linspace(0.0, 8.0, 3, dtype=torch.float64)
    for fn, lead in ((tfuncs.fourier_density_parts_harmonics, 5),
                     (tfuncs.one_body_density_grid, offsets),
                     (tfuncs.pair_dist_histogram, 9)):
        flat = fn(lead, tpos, tcfc)
        out = fn(lead, batched, tcfc)
        assert out.shape == (2, 4) + flat.shape[1:]
        torch.testing.assert_close(out.reshape(flat.shape), flat,
                                   rtol=0.0, atol=0.0)
