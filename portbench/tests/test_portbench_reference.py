"""The plain reference against the port's own plain versions on the
CPU in float64, at small sizes: the model's functions, the estimators,
the noise and the draws.  The reference imports nothing of the port;
these tests do, to hold it to the same equations."""
import math

import numpy as np
import pytest
import torch

from reference import philox, streams
from reference.model import Model

from phd_qmclib_torch import utils
from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import prng

SPECS = [
    dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
         boson_number=8, supercell_size=8.0, tbf_contact_cutoff=0.4),
    dict(lattice_depth=12.0, lattice_ratio=1.0, interaction_strength=4.0,
         boson_number=6, supercell_size=6.0, tbf_contact_cutoff=0.35),
    dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
         boson_number=8, supercell_size=8.0, tbf_contact_cutoff=0.4,
         num_defects=2, defect_magnitude=10.0),
]


def _pos(spec, walkers=32, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((walkers, spec["boson_number"]), generator=gen,
                      dtype=torch.float64) * spec["supercell_size"]


def _port(spec):
    mspec = mrbp.Spec(**spec)
    cfc = mrbp.cast_params(mspec.cfc_params, torch.float64, "cpu")
    return mrbp.core_funcs(mspec), cfc


@pytest.mark.parametrize("spec", SPECS)
def test_energy_drift_and_log_psi(spec):
    funcs, cfc = _port(spec)
    model, pos = Model(spec, chunk=7), _pos(spec)
    energy, drift = model.energy_drift(pos)
    want_e, want_f = funcs.energy_and_drift(pos, cfc)
    np.testing.assert_allclose(energy, want_e, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(drift, want_f, rtol=1e-10, atol=1e-9)
    lp, _ = funcs.log_psi_and_energy(pos, cfc)
    np.testing.assert_allclose(model.log_psi(pos), lp, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("spec", SPECS[:2])
def test_estimators(spec):
    funcs, cfc = _port(spec)
    model, pos = Model(spec, chunk=5), _pos(spec, seed=4)
    np.testing.assert_allclose(
        model.ssf_parts(pos, 6),
        funcs.fourier_density_parts_harmonics(6, pos, cfc), rtol=1e-9,
        atol=1e-9)
    offsets = torch.linspace(0, 0.5 * spec["supercell_size"], 5,
                             dtype=torch.float64)
    np.testing.assert_allclose(model.obd_grid(pos, 5),
                               funcs.one_body_density_grid(offsets, pos, cfc),
                               rtol=1e-10)
    np.testing.assert_array_equal(model.pair_hist(pos, 16),
                                  funcs.pair_dist_histogram(16, pos, cfc))
    assert float(model.density_hist(pos, 8).sum()) == pos.numel()


def test_params_solve_as_the_port():
    spec = SPECS[0]
    port = mrbp.Spec(**spec)
    p = Model(spec).p
    assert p.e0 == pytest.approx(port.obf_params.param_e0, rel=1e-13)
    tbf = port.tbf_params
    for mine, theirs in ((p.k2, tbf.param_k2), (p.beta, tbf.param_beta),
                         (p.r_off, tbf.param_r_off), (p.am, tbf.param_am)):
        assert mine == pytest.approx(theirs, rel=1e-12)


@pytest.mark.parametrize("key,step", [(7, 0), (2 ** 31 + 5, 123457),
                                      (2 ** 40 + 3, 2 ** 33 + 1)])
def test_philox_words_and_normals(key, step):
    words = philox.philox_words(key, step, 50, "cpu")
    assert torch.equal(words, prng.philox_words_plain(key, step, 50))
    mine = philox.normals(key, step, (7, 9), torch.float64, "cpu")
    theirs = prng.normal_plain(key, step, (7, 9), torch.float64)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=2e-6)


def test_block_seed_and_draws():
    for seed, block in ((1, 0), (2 ** 31 + 77, 12)):
        assert streams.block_seed(seed, block) == utils.block_seed(seed,
                                                                   block)
    gen = torch.Generator().manual_seed(utils.block_seed(9, 3))
    draws = [torch.rand((5,), generator=gen) for _ in range(4)]
    assert torch.equal(streams.dmc_comb_uniforms(9, 3, 3, 5, torch.float32,
                                                 "cpu"), draws[3])
    unit, u = streams.vmc_draws(9, 3, 1, (5, 4), torch.float32, "cpu",
                                False, 512)
    gen = torch.Generator().manual_seed(utils.block_seed(9, 3))
    seq = [torch.rand(shape, generator=gen)
           for shape in ((5, 4), (5,), (5, 4), (5,))]
    assert torch.equal(unit, seq[2].double() - 0.5)
    assert torch.equal(u, seq[3])
    assert math.isfinite(float(unit.sum()))
