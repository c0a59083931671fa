"""The pair energy/drift op's plain torch version against the JAX
package's Pallas kernel (interpret mode) and XLA path, on the CPU.

The CUDA kernel itself is held against this plain version on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.ops import pairwise as tpairwise
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.ops import pairwise as jpairwise

torch.set_num_threads(1)

BENCH32 = dict(lattice_depth=20.0, lattice_ratio=1.0,
               interaction_strength=1.0, boson_number=32,
               supercell_size=32.0, tbf_contact_cutoff=0.4)
VARIANTS = {
    "bench": BENCH32,
    "free": dict(BENCH32, lattice_depth=0.0, interaction_strength=4.0),
    "ideal": dict(BENCH32, interaction_strength=0.0),
    "defected": dict(BENCH32, num_defects=4, defect_magnitude=7.5),
    "obf_depth": dict(BENCH32, obf_lattice_depth=15.0, num_defects=8,
                      defect_magnitude=3.0),
}


def _plain(spec, pos, dtype):
    static = spec.static_spec
    params = tpairwise.pack_params(
        tmrbp.cfc_params_from_numpy(spec.cfc_params), dtype)
    return tpairwise.energy_and_drift_plain(
        torch.as_tensor(pos, dtype=dtype), params,
        nop=static.boson_number, is_free=static.is_free,
        is_ideal=static.is_ideal, defects_sep=static.defects_sep)


@pytest.mark.parametrize("variant", ["bench", "defected"])
def test_plain_f32_matches_pallas_interpret(variant):
    """f32 at N=32, W=32 against the Pallas kernel body, with the
    tolerances of ``tests/ops/test_pairwise.py`` (f32 sums of 32
    per-particle terms in another order)."""
    spec = jmrbp.Spec(**VARIANTS[variant])
    static = spec.static_spec
    pos = np.random.default_rng(0).uniform(0, 32.0, (32, 32)) \
        .astype(np.float32)
    e_j, d_j = jpairwise.energy_and_drift_pallas(
        jnp.asarray(pos), jnp.asarray(jpairwise.pack_params(
            spec.cfc_params)), nop=32, is_free=static.is_free,
        is_ideal=static.is_ideal, defects_sep=static.defects_sep, tw=8,
        interpret=True)
    e_t, d_t = _plain(spec, pos, torch.float32)
    assert e_t.dtype == d_t.dtype == torch.float32
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_f64_matches_xla(variant):
    """f64 against the JAX package's XLA energy and drift to 1e-12 (the
    same formulas, summed per particle here and per pair there)."""
    spec = jmrbp.Spec(**VARIANTS[variant])
    pos = np.random.default_rng(1).uniform(0, 32.0, (24, 32))
    e_j, d_j = jmrbp.core_funcs(spec).energy_and_drift(
        jnp.asarray(pos), jax.tree.map(jnp.float64, spec.cfc_params))
    e_t, d_t = _plain(spec, pos, torch.float64)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pack_params_matches_jax(variant):
    spec = jmrbp.Spec(**VARIANTS[variant])
    cfc = tmrbp.cfc_params_from_numpy(spec.cfc_params)
    vec = tpairwise.pack_params(cfc, torch.float32)
    assert vec.shape == (tpairwise.PARAMS_SIZE,)
    assert vec.dtype == torch.float32
    np.testing.assert_array_equal(vec[:13].numpy(),
                                  jpairwise.pack_params(spec.cfc_params)[
                                      0, :13])
    # The Hamiltonian's depth, which the potential uses off the defects
    # (slot 0 is the trial orbital's, which obf_lattice_depth moves).
    assert vec[tpairwise.P_V0M] == np.float32(spec.lattice_depth)
    assert vec[tpairwise.P_V0] == np.float32(spec.obf_params.lattice_depth)
    assert not vec[14:].any()
    # Leaves cast to 0-d tensors pack to the same vector.
    cast = tmrbp.cast_params(cfc, torch.float64, "cpu")
    np.testing.assert_array_equal(
        tpairwise.pack_params(cast, torch.float64).numpy(),
        tpairwise.pack_params(cfc, torch.float64).numpy())


def test_wrapper_takes_plain_version_only_on_cpu():
    spec = tmrbp.Spec(**BENCH32)
    params = tpairwise.pack_params(spec.cfc_params, torch.float64)
    pos = torch.as_tensor(
        np.random.default_rng(2).uniform(0, 32.0, (4, 32)))
    count = tpairwise.energy_and_drift.launch_count
    kw = dict(nop=32, is_free=False, is_ideal=False, defects_sep=1)
    e, d = tpairwise.energy_and_drift(pos, params, **kw)
    e_p, d_p = tpairwise.energy_and_drift_plain(pos, params, **kw)
    assert torch.equal(e, e_p) and torch.equal(d, d_p)
    assert tpairwise.energy_and_drift.launch_count == count
    # Any other device gets the kernel or an error, never the plain
    # version.
    with pytest.raises(ValueError, match="no kernel"):
        tpairwise.energy_and_drift(pos.to("meta"), params.to("meta"), **kw)
