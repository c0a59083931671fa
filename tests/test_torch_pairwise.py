"""The pair energy/drift op (forward and log|psi| variants) and the
fused diffusion step: their plain torch versions against the JAX
package's Pallas kernel (interpret mode) and XLA path, on the CPU.

The CUDA kernels themselves are held against these plain versions on
the card (``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.ops import pairwise as tpairwise
from phd_qmclib_torch.ops import prng
from phd_qmclib_torch.samplers import dmc as tdmc
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


def _kernel_kw(spec):
    static = spec.static_spec
    return dict(nop=static.boson_number, is_free=static.is_free,
                is_ideal=static.is_ideal, defects_sep=static.defects_sep)


def _plain(spec, pos, dtype, with_log_psi=False):
    params = tpairwise.pack_params(
        tmrbp.cfc_params_from_numpy(spec.cfc_params), dtype, device="cpu")
    return tpairwise.energy_and_drift_plain(
        torch.as_tensor(pos, dtype=dtype), params,
        with_log_psi=with_log_psi, **_kernel_kw(spec))


def _random_spec_kwargs(seed: int) -> dict:
    """The randomized config space of ``tests/ops/test_pairwise.py`` at
    N <= 32: free gas, ideal lattice gas, interacting defected
    lattice."""
    rng = np.random.default_rng(2000 + seed)
    nop = int(rng.choice([8, 32]))
    kwargs = dict(lattice_ratio=float(rng.uniform(0.5, 1.5)),
                  boson_number=nop, supercell_size=float(nop),
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
    return kwargs


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
    vec = tpairwise.pack_params(cfc, torch.float32, device="cpu")
    assert vec.shape == (tpairwise.PARAMS_SIZE,)
    assert vec.dtype == torch.float32
    np.testing.assert_array_equal(vec[:13].numpy(),
                                  jpairwise.pack_params(spec.cfc_params)[
                                      0, :13])
    # The Hamiltonian's depth, which the potential uses off the defects
    # (slot 0 is the trial orbital's, which obf_lattice_depth moves).
    assert vec[tpairwise.P_V0M] == np.float32(spec.lattice_depth)
    assert vec[tpairwise.P_V0] == np.float32(spec.obf_params.lattice_depth)
    # The one-body well amplitude: the model's own f32 expression (its
    # orbital at the well centre), 0 for a free gas.
    cf = 0.0
    if not spec.is_free:
        well_centre = torch.tensor([0.5 * spec.well_width])
        cf = tmrbp._one_body(well_centre,
                             tmrbp.cast_params(cfc, torch.float32, "cpu"))
    assert vec[tpairwise.P_CF] == cf
    assert not vec[15:].any()
    # Leaves cast to 0-d tensors pack to the same vector.
    cast = tmrbp.cast_params(cfc, torch.float64, "cpu")
    np.testing.assert_array_equal(
        tpairwise.pack_params(cast, torch.float64, device="cpu").numpy(),
        tpairwise.pack_params(cfc, torch.float64, device="cpu").numpy())


def test_wrapper_takes_plain_version_only_on_cpu():
    spec = tmrbp.Spec(**BENCH32)
    params = tpairwise.pack_params(spec.cfc_params, torch.float64,
                                   device="cpu")
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


@pytest.mark.parametrize("variant", ["bench", "defected"])
def test_plain_log_psi_f32_matches_pallas_interpret(variant):
    """The log|psi| variant in f32 at N=32, W=32 against the Pallas
    kernel body with ``with_log_psi=True``, at the tolerances of
    ``tests/ops/test_pairwise.py``: log|psi| sums ~N^2/2 pair logs in
    f32 (rtol 1e-5), the energy's kinetic term is ``C (1 + v^2)`` here
    and ``-f2''/f2 + (f2'/f2)^2`` there (rtol 2e-6)."""
    spec = jmrbp.Spec(**VARIANTS[variant])
    static = spec.static_spec
    pos = np.random.default_rng(3).uniform(0, 32.0, (32, 32)) \
        .astype(np.float32)
    lp_j, e_j, d_j = jpairwise.energy_and_drift_pallas(
        jnp.asarray(pos), jnp.asarray(jpairwise.pack_params(
            spec.cfc_params)), nop=32, is_free=static.is_free,
        is_ideal=static.is_ideal, defects_sep=static.defects_sep, tw=8,
        with_log_psi=True, interpret=True)
    lp_t, e_t, d_t = _plain(spec, pos, torch.float32, with_log_psi=True)
    assert lp_t.dtype == e_t.dtype == d_t.dtype == torch.float32
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("case", [f"random{i}" for i in range(6)]
                         + sorted(VARIANTS))
def test_plain_log_psi_f64_matches_xla(case):
    """f64 log|psi|, energy and drift against the JAX package's XLA
    ``log_psi_and_energy`` and ``drift`` to 1e-12, over the randomized
    free, ideal and defected specs and the named variants."""
    kwargs = (_random_spec_kwargs(int(case[6:])) if case.startswith("random")
              else VARIANTS[case])
    spec = jmrbp.Spec(**kwargs)
    funcs = jmrbp.core_funcs(spec)
    cfc = jax.tree.map(jnp.float64, spec.cfc_params)
    pos = np.random.default_rng(4).uniform(0, spec.supercell_size,
                                           (24, spec.boson_number))
    lp_j, e_j = funcs.log_psi_and_energy(jnp.asarray(pos), cfc)
    d_j = funcs.drift(jnp.asarray(pos), cfc)
    lp_t, e_t, d_t = _plain(spec, pos, torch.float64, with_log_psi=True)
    for got, want in ((lp_t, lp_j), (e_t, e_j), (d_t, d_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    # The forward variant gives the same energy and drift.
    e_f, d_f = _plain(spec, pos, torch.float64)
    assert torch.equal(e_f, e_t) and torch.equal(d_f, d_t)


def _diffuse_inputs(spec, seed, dtype=torch.float64, num_walkers=40):
    rng = np.random.default_rng(seed)
    nop, sc = spec.boson_number, spec.supercell_size
    return dict(
        cpos=rng.uniform(0, sc, (num_walkers, nop)),
        cdrift=rng.normal(0, 5.0, (num_walkers, nop)),
        cenergy=rng.normal(8.5 * nop, 10.0, num_walkers),
        xi=rng.standard_normal((num_walkers, nop)),
        e_ref=8.4 * nop)


@pytest.mark.parametrize("variant", ["bench", "defected", "free", "ideal"])
def test_plain_diffuse_matches_jax_composition(variant):
    """The fused step's plain version with injected xi against the JAX
    composition ``mrbp.recast`` -> ``core_funcs.energy_and_drift`` ->
    the weight, in f64 (N=32, with walkers at the edges of the box)."""
    spec = jmrbp.Spec(**VARIANTS[variant])
    dt, sigma = 1e-2, float(np.sqrt(2e-2))
    inp = _diffuse_inputs(spec, 5)
    inp["cpos"][0, :3] = [0.0, 32.0 - 1e-12, 31.9]
    cfc = jax.tree.map(jnp.float64, spec.cfc_params)
    npos_j = jmrbp.recast(jnp.asarray(inp["cpos"])
                          + 2.0 * jnp.asarray(inp["cdrift"]) * dt
                          + sigma * jnp.asarray(inp["xi"]), cfc)
    ne_j, nd_j = jmrbp.core_funcs(spec).energy_and_drift(npos_j, cfc)
    nw_j = jnp.exp(-dt * (0.5 * (ne_j + jnp.asarray(inp["cenergy"]))
                          - inp["e_ref"]))
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in inp.items()}
    params = tpairwise.pack_params(
        tmrbp.cfc_params_from_numpy(spec.cfc_params), torch.float64,
        device="cpu")
    out = tpairwise.diffuse_energy_drift_plain(
        t["cpos"], t["cdrift"], t["cenergy"], params, dt, sigma, t["e_ref"],
        7, 3, xi=t["xi"], **_kernel_kw(spec))
    assert [tuple(x.shape) for x in out] == [(40, 32), (40,), (40, 32),
                                              (40,)]
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(npos_j))
    for got, want in zip(out[1:], (ne_j, nd_j, nw_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


def test_plain_diffuse_draws_the_normals_stream():
    """Without xi the fused step draws ``prng.normal_plain(seed, step)``
    in f32, for N not a multiple of 4 (quads straddle walkers), and
    equals the DMC step's own diffusion (``dmc.Sampling.diffuse``) with
    the step's pre-scaled noise."""
    spec = tmrbp.Spec(**dict(BENCH32, boson_number=13, supercell_size=13.0))
    sampling = tdmc.Sampling(spec, time_step=1e-3, max_num_walkers=8,
                             target_num_walkers=7, rng_seed=11)
    dt, sigma = sampling.time_step, sampling.sigma_spread
    inp = _diffuse_inputs(spec, 6, num_walkers=7)
    t = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in inp.items()}
    params = tpairwise.pack_params(spec.cfc_params, torch.float32,
                                   device="cpu")
    kw = _kernel_kw(spec)
    drawn = tpairwise.diffuse_energy_drift(
        t["cpos"], t["cdrift"], t["cenergy"], params, dt, sigma,
        t["e_ref"], 11, 5, **kw)
    xi = prng.normal_plain(11, 5, (7, 13))
    injected = tpairwise.diffuse_energy_drift_plain(
        t["cpos"], t["cdrift"], t["cenergy"], params, dt, sigma,
        t["e_ref"], 11, 5, xi=xi, **kw)
    for a, b in zip(drawn, injected):
        assert torch.equal(a, b)
    step = sampling.diffuse(
        t["cpos"], t["cdrift"], t["cenergy"], sigma * xi, t["e_ref"],
        tmrbp.cast_params(spec.cfc_params, torch.float32, "cpu"))
    for a, b in zip(drawn, step):
        assert torch.equal(a, b)


def test_log_psi_and_diffuse_wrappers_take_plain_version_only_on_cpu():
    spec = tmrbp.Spec(**BENCH32)
    params = tpairwise.pack_params(spec.cfc_params, torch.float64,
                                   device="cpu")
    pos = torch.as_tensor(
        np.random.default_rng(7).uniform(0, 32.0, (4, 32)))
    kw = _kernel_kw(spec)
    counts = (tpairwise.energy_and_drift.log_psi_launch_count,
              tpairwise.diffuse_energy_drift.launch_count)
    got = tpairwise.energy_and_drift(pos, params, with_log_psi=True, **kw)
    want = tpairwise.energy_and_drift_plain(pos, params, with_log_psi=True,
                                            **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    e_ref = torch.tensor(270.0, dtype=torch.float64)
    tpairwise.diffuse_energy_drift(pos, pos, pos[:, 0], params, 1e-3, 0.05,
                                   e_ref, 1, 0, **kw)
    assert counts == (tpairwise.energy_and_drift.log_psi_launch_count,
                      tpairwise.diffuse_energy_drift.launch_count)
    meta = pos.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpairwise.energy_and_drift(meta, params.to("meta"),
                                   with_log_psi=True, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        tpairwise.diffuse_energy_drift(meta, meta, meta[:, 0],
                                       params.to("meta"), 1e-3, 0.05,
                                       e_ref.to("meta"), 1, 0, **kw)


@pytest.mark.parametrize("nop, length, rm", [(5, 5.0, 0.4), (8, 4.0, 0.9),
                                             (13, 13.0, 0.0)])
def test_k3_bound_counts_each_pair_by_its_side_of_the_cutoff(nop, length,
                                                             rm):
    """``chip_smoke.k3_bound`` counts each unordered pair of the moved
    positions inside or outside the minimum-image cutoff, as a loop over
    the pairs does, and the first design's count is never below it."""
    import chip_smoke as cs

    pos = torch.as_tensor(np.random.default_rng(nop).uniform(
        0, length, (3, nop)), dtype=torch.float32)
    params = torch.zeros(tpairwise.PARAMS_SIZE)
    params[tpairwise.P_L], params[tpairwise.P_RM] = length, rm
    in_cut = 0
    for walker in pos.tolist():
        for i in range(nop):
            for j in range(i + 1, nop):
                d = abs(walker[i] - walker[j])
                in_cut += min(d, length - d) < rm
    pairs = 3 * nop * (nop - 1) // 2
    least = cs.k3_bound(pos, params)
    assert (least["pairs_in_cutoff"], least["pairs"]) == (in_cut, pairs)
    flops = (in_cut * cs.K3_FLOPS_IN_CUT
             + (pairs - in_cut) * cs.K3_FLOPS_OUTSIDE
             + pos.numel() * cs.K3_FLOPS_PER_ELEMENT)
    assert least["bound_ms"] == pytest.approx(
        max(flops / cs.PEAK_FP32_FLOPS,
            cs.F32_BYTES * (4 * pos.numel() + 3 * 3
                            + tpairwise.PARAMS_SIZE + 1)
            / cs.PEAK_HBM_BYTES_PER_S) * 1e3)
    first = cs.k3_bound(pos, params, *cs.K3_FIRST_DESIGN_FLOPS)
    assert first["bound_ms"] >= least["bound_ms"]
