"""The model API the execution layer needs, against the JAX package in
f64 on the CPU: ``mrbp.PhysicalFuncs``, and the Jastrow functions
``wf_abs``, ``one_body_density``, ``delta_log_psi_move`` and
``delta_drift_move``.  Tolerance 1e-12 (relative to the value's scale)
against the JAX functions; the single-particle updates are also held
against the difference of the full functions (1e-9), as the JAX
package's own tests hold them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.multirods_qmc import bloch_phonon
from phd_qmclib_tpu.models import mrbp as jmrbp

torch.set_num_threads(1)

SPECS = {
    "lattice": dict(lattice_depth=10.0, lattice_ratio=1.0,
                    interaction_strength=1.0, boson_number=5,
                    supercell_size=5.0, tbf_contact_cutoff=0.3),
    "defects": dict(lattice_depth=12.0, lattice_ratio=0.5,
                    interaction_strength=2.0, boson_number=6,
                    supercell_size=6.0, tbf_contact_cutoff=0.4,
                    num_defects=2, defect_magnitude=6.0),
    "free": dict(lattice_depth=0.0, lattice_ratio=1.0,
                 interaction_strength=3.0, boson_number=5,
                 supercell_size=5.0, tbf_contact_cutoff=0.5),
    "ideal": dict(lattice_depth=8.0, lattice_ratio=1.0,
                  interaction_strength=0.0, boson_number=5,
                  supercell_size=5.0, tbf_contact_cutoff=0.3),
}
TOL = 1e-12


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale


def _pos(name, shape, seed=5):
    size = SPECS[name]["supercell_size"]
    return np.random.default_rng(seed).uniform(0, size, shape)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_physical_funcs_match_jax(name):
    nop = SPECS[name]["boson_number"]
    ours = tmrbp.PhysicalFuncs.from_model_spec(tmrbp.Spec(**SPECS[name]),
                                               device="cpu")
    theirs = jmrbp.PhysicalFuncs.from_model_spec(jmrbp.Spec(**SPECS[name]))
    batch = _pos(name, (7, nop), seed=2)
    packed = np.stack([batch, np.zeros_like(batch)], axis=1)
    for conf in (batch, packed, batch[0], torch.as_tensor(batch)):
        jconf = np.asarray(conf)
        _close(ours.wf_abs_log(conf), theirs.wf_abs_log(jconf))
        _close(ours.energy(conf), theirs.energy(jconf))
        _close(ours.drift(conf), theirs.drift(jconf))
        for sz in (0.0, 0.37, 2.2):
            _close(ours.one_body_density(sz, conf),
                   theirs.one_body_density(sz, jconf))
    kz = np.array([0.0, 2 * np.pi / nop, 1.7])
    rho = ours.fourier_density(kz, batch)
    want = np.asarray(theirs.fourier_density(kz, batch))
    _close(rho.real, want.real)
    _close(rho.imag, want.imag)
    assert ours.wf_abs_log(batch).shape == (7,)
    assert ours.drift(packed).shape == (7, nop)
    _close(ours.one_body_density(0.0, batch), np.ones(7))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_single_particle_functions_match_jax(name):
    nop = SPECS[name]["boson_number"]
    tspec, jspec = tmrbp.Spec(**SPECS[name]), jmrbp.Spec(**SPECS[name])
    tfuncs, jfuncs = tmrbp.core_funcs(tspec), jmrbp.core_funcs(jspec)
    pos = _pos(name, (nop,))
    tpos, jpos = torch.as_tensor(pos), jnp.asarray(pos)
    _close(tfuncs.wf_abs(tpos, tspec.cfc_params),
           jfuncs.wf_abs(jpos, jspec.cfc_params))
    _close(tfuncs.wf_abs(torch.as_tensor(_pos(name, (3, nop))),
                         tspec.cfc_params),
           jfuncs.wf_abs(jnp.asarray(_pos(name, (3, nop))),
                         jspec.cfc_params))
    for k, dz in ((1, 0.23), (nop - 1, -0.41), (0, 1.6)):
        delta = tfuncs.delta_log_psi_move(k, dz, tpos, tspec.cfc_params)
        _close(delta, jfuncs.delta_log_psi_move(k, dz, jpos,
                                                jspec.cfc_params))
        moved = tpos.clone()
        moved[k] += dz
        _close(delta, (tfuncs.log_psi(moved, tspec.cfc_params)
                       - tfuncs.log_psi(tpos, tspec.cfc_params)).numpy(),
               tol=1e-9)
        drift0 = tfuncs.drift(tpos, tspec.cfc_params)
        drift1 = tfuncs.drift(moved, tspec.cfc_params)
        for i in range(nop):
            delta_i = tfuncs.delta_drift_move(i, k, dz, tpos,
                                              tspec.cfc_params)
            _close(delta_i, jfuncs.delta_drift_move(i, k, dz, jpos,
                                                    jspec.cfc_params))
            _close(delta_i, (drift1[i] - drift0[i]).numpy(), tol=1e-9)


def test_one_body_density_agrees_with_the_grid():
    spec = tmrbp.Spec(**SPECS["lattice"])
    funcs = tmrbp.core_funcs(spec)
    pos = torch.as_tensor(_pos("lattice", (4, 5)))
    offsets = torch.linspace(0.0, 2.5, 6, dtype=torch.float64)
    grid = funcs.one_body_density_grid(offsets, pos, spec.cfc_params)
    for idx, sz in enumerate(offsets):
        _close(funcs.one_body_density(float(sz), pos, spec.cfc_params),
               grid[:, idx].numpy(), tol=1e-12)


def test_legacy_alias_package():
    assert bloch_phonon.Spec is tmrbp.Spec
    assert bloch_phonon.core_funcs is tmrbp.core_funcs
    assert bloch_phonon.PhysicalFuncs is tmrbp.PhysicalFuncs
    assert bloch_phonon.dmc.Sampling is not None
