"""The port's mrbp model against the JAX package, in f64 on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the
port's parameters come from the JAX spec through
``cfc_params_from_numpy``, so both start from the same numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import jastrow as tjastrow
from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_tpu.models import mrbp as jmrbp

torch.set_num_threads(1)

#: f64 agreement: the two packages evaluate the same formulas, but sum
#: in another order; the energy's kinetic and drift^2 sums cancel.
RTOL = 1e-12


def _random_spec_kwargs(seed: int) -> dict:
    """The randomized config space of ``tests/ops/test_pairwise.py``:
    free gas, ideal lattice gas, interacting defected lattice."""
    rng = np.random.default_rng(1000 + seed)
    nop = int(rng.choice([16, 64]))
    kwargs = dict(lattice_ratio=1.0, boson_number=nop,
                  supercell_size=float(nop),
                  tbf_contact_cutoff=float(rng.uniform(0.2, 0.45)))
    variant = seed % 3
    if variant == 0:
        kwargs.update(lattice_depth=0.0,
                      interaction_strength=float(rng.uniform(0.5, 20)))
    elif variant == 1:
        kwargs.update(lattice_depth=float(rng.uniform(1.0, 30.0)),
                      interaction_strength=0.0)
    else:
        kwargs.update(lattice_depth=float(rng.uniform(5.0, 30.0)),
                      interaction_strength=float(rng.uniform(0.5, 10)),
                      num_defects=max(1, nop // 8),
                      defect_magnitude=float(rng.uniform(0.1, 1.0)))
    return kwargs, rng


@pytest.mark.parametrize("kwargs", [
    dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
         boson_number=128, supercell_size=128.0, tbf_contact_cutoff=0.4),
    dict(lattice_depth=12.0, lattice_ratio=0.5, interaction_strength=3.0,
         boson_number=32, supercell_size=32.0, tbf_contact_cutoff=4.0,
         num_defects=4, defect_magnitude=6.0, obf_lattice_depth=9.0),
    dict(lattice_depth=0.0, lattice_ratio=1.0, interaction_strength=0.5,
         boson_number=16, supercell_size=16.0, tbf_contact_cutoff=2.0),
])
def test_spec_params_match(kwargs):
    jspec, tspec = jmrbp.Spec(**kwargs), tmrbp.Spec(**kwargs)
    assert tspec.static_spec == tuple(jspec.static_spec)
    for group in ("params", "obf_params", "tbf_params"):
        jvals = np.array(getattr(jspec, group), dtype=np.float64)
        tvals = np.array(getattr(tspec, group), dtype=np.float64)
        np.testing.assert_allclose(tvals, jvals, rtol=1e-14, atol=1e-14)
    converted = tmrbp.cfc_params_from_numpy(jspec.cfc_params)
    assert converted == tspec.cfc_params
    leaves = jax.tree.map(np.asarray, jspec.cfc_params)
    assert tmrbp.cfc_params_from_numpy(leaves) == tspec.cfc_params


@pytest.mark.parametrize("seed", range(6))
def test_core_funcs_match_jax(seed):
    kwargs, rng = _random_spec_kwargs(seed)
    jspec = jmrbp.Spec(**kwargs)
    jfuncs = jmrbp.core_funcs(jspec)
    jcfc = jax.tree.map(jnp.float64, jspec.cfc_params)
    tfuncs = tmrbp.core_funcs(tmrbp.Spec(**kwargs))
    tcfc = tmrbp.cfc_params_from_numpy(jspec.cfc_params)
    pos = rng.uniform(0, kwargs["supercell_size"],
                      (16, kwargs["boson_number"]))
    jpos, tpos = jnp.asarray(pos), torch.as_tensor(pos)

    def check(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=RTOL)

    check(tfuncs.log_psi(tpos, tcfc), jfuncs.log_psi(jpos, jcfc))
    check(tfuncs.drift(tpos, tcfc), jfuncs.drift(jpos, jcfc))
    je, jd = jfuncs.energy_and_drift(jpos, jcfc)
    te, td = tfuncs.energy_and_drift(tpos, tcfc)
    check(te, je)
    check(td, jd)
    jlp, jle = jfuncs.log_psi_and_energy(jpos, jcfc)
    tlp, tle = tfuncs.log_psi_and_energy(tpos, tcfc)
    check(tlp, jlp)
    check(tle, jle)
    # The generic Jastrow energy_and_drift (the mrbp namespace routes it
    # through the pair kernel's wrapper instead).
    static = jspec.static_spec
    generic = tjastrow.build_core_funcs(
        one_body=tmrbp._one_body,
        one_body_log_dz=tmrbp._one_body_log_dz,
        one_body_log_dz2=tmrbp._one_body_log_dz2,
        two_body_pair_terms=tmrbp._two_body_pair_terms,
        potential=tmrbp._make_potential(static.defects_sep),
        is_free=static.is_free, is_ideal=static.is_ideal,
        boson_number=static.boson_number)
    ge, gd = generic.energy_and_drift(
        tpos, tmrbp.cast_params(tcfc, torch.float64, "cpu"))
    check(ge, je)
    check(gd, jd)


def test_recast_matches_jax():
    spec = tmrbp.Spec(20.0, 1.0, 1.0, 16, 16.0, 0.4)
    jcfc = jax.tree.map(jnp.float64,
                        jmrbp.Spec(20.0, 1.0, 1.0, 16, 16.0, 0.4)
                        .cfc_params)
    z = np.random.default_rng(5).uniform(-20.0, 36.0, (8, 16))
    z[0, :4] = [0.0, 16.0, -16.0, 32.0]
    got = tmrbp.recast(torch.as_tensor(z), spec.cfc_params)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmrbp.recast(jnp.asarray(z),
                                                          jcfc)))
