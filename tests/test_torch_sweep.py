"""Fused parameter sweeps in the port, in f64 on the CPU.

The row variants of the kernels' plain versions (K1's parameter table,
K2's rows, K4's bin-size groups) against one call per row, bit for bit;
the fused DMC step under injected draws against the JAX package's
``replay_states`` of each row; ``ParamSweep`` and ``VmcSweep`` rows
against their standalone port runs over the estimators, with rows that
differ in coupling, time step and supercell; the fused VMC step against
JAX's ``replay_chain``; the validation errors against the JAX package's
texts.
"""
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.ops import histogram, pairwise, prng
from phd_qmclib_torch.parallel import ParamSweep, VmcSweep
from phd_qmclib_torch.samplers import dmc as tdmc
from phd_qmclib_torch.samplers import vmc as tvmc
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.parallel import sweep as jsweep
from phd_qmclib_tpu.samplers import dmc as jdmc
from phd_qmclib_tpu.samplers import vmc as jvmc

torch.set_num_threads(1)

NOP = 8
#: (coupling, supercell, time step) of each row: the rows differ in all
#: three (a supercell of another length moves the recast, the minimum
#: image, the bin widths and the S(k), OBDM and ITC grids).
ROWS = ((0.5, 8.0, 1e-2), (1.0, 8.0, 2e-2), (2.0, 10.0, 1e-2))
MAX_W, TARGET = 32, 24


def _spec_kw(gn, sc, **extra):
    return dict(lattice_depth=12.0, lattice_ratio=1.0, interaction_strength=gn,
                boson_number=NOP, supercell_size=sc, tbf_contact_cutoff=0.3,
                **extra)


def _confs(sc, num, seed):
    return np.random.default_rng(seed).uniform(0, sc, (num, NOP))


# -- the kernels' row variants, plain versions ---------------------------------

@pytest.mark.parametrize("with_log_psi", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_table_plain_equals_row_calls(dtype, with_log_psi):
    specs = [tmrbp.Spec(**_spec_kw(gn, sc, num_defects=2,
                                   defect_magnitude=5.0))
             for gn, sc, _ in ROWS]
    table = torch.stack([pairwise.pack_params(s.cfc_params, dtype, "cpu")
                         for s in specs])
    per_row = 6
    pos = torch.as_tensor(np.concatenate(
        [_confs(s.supercell_size, per_row, r) for r, s in enumerate(specs)]),
        dtype=dtype)
    static = specs[0].static_spec
    kw = dict(nop=NOP, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep, with_log_psi=with_log_psi)
    got = pairwise.energy_and_drift(pos, table, **kw)
    for r in range(len(specs)):
        rows = slice(r * per_row, (r + 1) * per_row)
        want = pairwise.energy_and_drift(pos[rows].contiguous(), table[r],
                                         **kw)
        for g, w in zip(got, want):
            assert torch.equal(g[rows], w)


@pytest.mark.parametrize("shape", [(5, 7), (4, 8), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normal_rows_plain_equals_row_calls(shape, dtype):
    """Each row word for word the single-row draw of its key, also when
    a row's length is not a multiple of 4."""
    keys = [3, (1 << 64) - 5, 1 << 40]
    scales = [0.1, 0.25, 1.0]
    out = torch.empty((3,) + shape, dtype=dtype)
    step = (1 << 33) + 7
    prng.normal_rows(prng.key_table(keys, "cpu"), step,
                     torch.tensor(scales, dtype=dtype), out)
    for r, (key, scale) in enumerate(zip(keys, scales)):
        scale = float(torch.tensor(scale, dtype=dtype))
        want = prng.normal(key, step, shape, dtype, "cpu", scale=scale)
        assert torch.equal(out[r], want)


def test_normal_rows_rejects_bad_tables():
    out = torch.empty((2, 4, 4))
    keys = prng.key_table([1, 2], "cpu")
    with pytest.raises(ValueError, match="keys and scales"):
        prng.normal_rows(keys[:1], 0, torch.ones(2), out)
    with pytest.raises(ValueError, match="keys and scales"):
        prng.normal_rows(keys, 0, torch.ones(2, dtype=torch.float64), out)
    with pytest.raises(ValueError, match="64-bit"):
        prng.key_table([-1], "cpu")


@pytest.mark.parametrize("what", ["density", "g2"])
def test_histogram_groups_plain_equal_row_calls(what):
    """K4's bin-size table at the density shape (rows of walkers) and at
    the g2 shape (rows of pair distances, W N rows a sweep row)."""
    sizes = torch.tensor([8.0, 8.0, 10.0], dtype=torch.float64)
    rng = np.random.default_rng(4)
    if what == "density":
        pos = torch.as_tensor(rng.uniform(0, 10, (3, 6, NOP)))
        bin_size, bins = sizes / 12, 12
    else:
        pos = torch.as_tensor(rng.uniform(0, 5, (3, 6, NOP, NOP)))
        bin_size, bins = 0.5 * sizes / 7, 7
    table = bin_size.view((3,) + (1,) * (pos.dim() - 1)).contiguous()
    got = histogram.walker_histogram(pos, table, bins)
    for r in range(3):
        assert torch.equal(got[r], histogram.walker_histogram(
            pos[r], bin_size[r], bins))


# -- the fused DMC step against the JAX package's replay of each row -----------

@pytest.mark.parametrize("ref_compat", [False, True])
def test_fused_step_matches_jax_replay_per_row(ref_compat):
    nts = 6
    jrows = [jdmc.Sampling(jmrbp.Spec(**_spec_kw(gn, sc)), dt, MAX_W, TARGET,
                           rng_seed=3, ref_compat=ref_compat)
             for gn, sc, dt in ROWS]
    trows = tuple(tdmc.Sampling(tmrbp.Spec(**_spec_kw(gn, sc)), dt, MAX_W,
                                TARGET, rng_seed=3, ref_compat=ref_compat)
                  for gn, sc, dt in ROWS)
    jstates = [s.build_state(_confs(sc, TARGET, r))
               for r, (s, (_, sc, _)) in enumerate(zip(jrows, ROWS))]
    rng = np.random.default_rng(7)
    comb_u = rng.random((nts, len(ROWS), MAX_W))
    xi = np.stack([s.sigma_spread * rng.standard_normal((nts, MAX_W, NOP))
                   for s in jrows], axis=1)
    state = tdmc.State(*(None if fields[0] is None else torch.stack(fields)
                         for fields in zip(*(
                             tdmc.state_from_numpy(js, device="cpu")
                             for js in jstates))))
    got = ParamSweep(trows).replay_states(state, comb_u, xi)
    for r, (jsampling, jstate) in enumerate(zip(jrows, jstates)):
        want = jsampling.replay_states(jstate, comb_u[:, r], xi[:, r])
        np.testing.assert_array_equal(got["parent"][:, r].numpy(),
                                      np.asarray(want["parent"]))
        np.testing.assert_array_equal(got["num_walkers"][:, r].numpy(),
                                      np.asarray(want["num_walkers"]))
        for name in ("pos", "energies", "weights", "ref_energy", "energy",
                     "weight", "accum_energy"):
            np.testing.assert_allclose(got[name][:, r].numpy(),
                                       np.asarray(want[name]), rtol=1e-12,
                                       atol=1e-12, err_msg=f"{name} row {r}")
    # The rows branched, each its own way.
    assert len({tuple(got["num_walkers"][:, r].tolist())
                for r in range(len(ROWS))}) > 1


# -- ParamSweep rows against their standalone runs -----------------------------

ESTIMATORS = {
    "none": {},
    "density": dict(density_est_spec=tdmc.DensityEstSpec(12, as_pure_est=False)),
    "density_pure": dict(density_est_spec=tdmc.DensityEstSpec(12)),
    "ssf": dict(ssf_est_spec=tdmc.SSFEstSpec(5, as_pure_est=False)),
    "ssf_pure": dict(ssf_est_spec=tdmc.SSFEstSpec(5)),
    "obd": dict(obd_est_spec=tdmc.OBDEstSpec(4, as_pure_est=False)),
    "obd_pure_thinned": dict(obd_est_spec=tdmc.OBDEstSpec(
        4, est_every_mult=2), est_every=2),
    "g2": dict(pair_corr_est_spec=tdmc.PairCorrEstSpec(6, as_pure_est=False)),
    "g2_pure": dict(pair_corr_est_spec=tdmc.PairCorrEstSpec(6)),
    "cm": dict(cm_diffusion_est=True, cm_window_blocks=2),
    "itc_mixed": dict(ssf_est_spec=tdmc.SSFEstSpec(5, as_pure_est=False),
                      itc_est_spec=tdmc.ITCEstSpec(3, 4)),
    "itc_pure": dict(itc_est_spec=tdmc.ITCEstSpec(3, 4, est_every_mult=2,
                                                  as_pure_est=True)),
    "every2": dict(density_est_spec=tdmc.DensityEstSpec(12),
                   ssf_est_spec=tdmc.SSFEstSpec(5), est_every=2),
    "window": dict(density_est_spec=tdmc.DensityEstSpec(
        12, pfw_num_time_steps=16)),
    "ref_compat": dict(ref_compat=True,
                       density_est_spec=tdmc.DensityEstSpec(12)),
}
BLOCK_FIELDS = ("iter_density", "iter_ssf", "iter_obd", "iter_g2",
                "iter_cmd", "iter_itc", "iter_itc_nw")


def _dmc_rows(**est):
    return tuple(tdmc.Sampling(tmrbp.Spec(**_spec_kw(gn, sc)), dt, MAX_W,
                               TARGET, rng_seed=11 + r, **est)
                 for r, (gn, sc, dt) in enumerate(ROWS))


def _close(got, want):
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               rtol=1e-12, atol=1e-12)


def _assert_block_row(fused, one, r):
    for name in one.iter_props._fields:
        _close(getattr(fused.iter_props, name)[:, r],
               getattr(one.iter_props, name))
    for name in BLOCK_FIELDS:
        want, got = getattr(one, name), getattr(fused, name)
        assert (want is None) == (got is None), name
        if want is not None:
            _close(got[r], want)
    for name in tdmc.State._fields:
        want = getattr(one.last_state, name)
        if want is not None:
            _close(getattr(fused.last_state, name)[r], want)


@pytest.mark.parametrize("case", sorted(ESTIMATORS))
def test_param_sweep_rows_match_standalone_runs(case):
    rows = _dmc_rows(**ESTIMATORS[case])
    sweep = ParamSweep(rows)
    confs = [_confs(sc, TARGET, r) for r, (_, sc, _) in enumerate(ROWS)]
    state = sweep.build_states(confs, dtype=np.float64, device="cpu")
    fused_it = sweep.blocks(state, 8, burn_in_blocks=1)
    fused = [next(fused_it) for _ in range(4)]
    assert fused[0].iter_props.energy.shape == (8, len(ROWS))
    for r, sampling in enumerate(rows):
        alone = sampling.blocks(sampling.build_state(
            confs[r], dtype=np.float64, device="cpu"), 8, burn_in_blocks=1)
        for block in fused:
            _assert_block_row(block, next(alone), r)


def test_param_sweep_resumes_inside_a_window():
    """``start_block_idx`` and ``aux_init`` (with the rows' axis) continue
    a fused run cut inside a forward-walking window, as in
    ``Sampling.blocks``."""
    rows = _dmc_rows(**ESTIMATORS["window"], cm_diffusion_est=True)
    sweep = ParamSweep(rows)
    confs = [_confs(sc, TARGET, r) for r, (_, sc, _) in enumerate(ROWS)]
    state = sweep.build_states(confs, dtype=np.float64, device="cpu")
    whole = sweep.blocks(state, 8, burn_in_blocks=1)
    blocks = [next(whole) for _ in range(4)]
    cut = blocks[1]  # the first measured block: the window is half full
    assert cut.aux_carry is not None
    resumed = sweep.blocks(cut.last_state, 8, burn_in_blocks=1,
                           start_block_idx=2, aux_init=cut.aux_carry)
    for want in blocks[2:]:
        got = next(resumed)
        for name in BLOCK_FIELDS:
            if getattr(want, name) is not None:
                assert torch.equal(getattr(got, name), getattr(want, name))
        assert torch.equal(got.last_state.pos, want.last_state.pos)


def test_one_row_sweep_is_the_standalone_run():
    rows = _dmc_rows(**ESTIMATORS["every2"])[:1]
    state = ParamSweep(rows).build_states(
        [_confs(8.0, TARGET, 0)], dtype=np.float64, device="cpu")
    fused = ParamSweep(rows).blocks(state, 8)
    alone = rows[0].blocks(tdmc.State(*(None if x is None else x[0]
                                        for x in state)), 8)
    for _ in range(2):
        a, b = next(fused), next(alone)
        assert torch.equal(a.iter_props.energy[:, 0], b.iter_props.energy)
        assert torch.equal(a.iter_density[0], b.iter_density)


# -- VMC ------------------------------------------------------------------------

VMC_ROWS = ((0.3, 8.0, 0.4), (0.4, 8.0, 0.5), (0.5, 10.0, 0.3))
VMC_ESTIMATORS = {
    "every_step": dict(ssf_est_spec=tvmc.SSFEstSpec(5),
                       obd_est_spec=tvmc.OBDEstSpec(4)),
    "chunked": dict(ssf_est_spec=tvmc.SSFEstSpec(5),
                    obd_est_spec=tvmc.OBDEstSpec(4, est_every_mult=2),
                    pair_corr_est_spec=tvmc.PairCorrEstSpec(6), est_every=2),
}


def _vmc_kw(rm, sc):
    return dict(lattice_depth=12.0, lattice_ratio=1.0, interaction_strength=1.0,
                boson_number=NOP, supercell_size=sc, tbf_contact_cutoff=rm)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("case", sorted(VMC_ESTIMATORS))
def test_vmc_sweep_rows_match_standalone_runs(case, gaussian):
    rows = tuple(tvmc.Sampling(tmrbp.Spec(**_vmc_kw(rm, sc)), spread,
                               rng_seed=5 + r, num_walkers=16,
                               gaussian=gaussian, **VMC_ESTIMATORS[case])
                 for r, (rm, sc, spread) in enumerate(VMC_ROWS))
    sweep = VmcSweep(rows)
    confs = [_confs(sc, 16, r) for r, (_, sc, _) in enumerate(VMC_ROWS)]
    fused_it = sweep.blocks(8, sweep.build_states(confs, dtype=np.float64,
                                                  device="cpu"))
    fused = [next(fused_it) for _ in range(2)]
    assert fused[0].iter_props.energy.shape == (len(VMC_ROWS), 8, 16)
    for r, sampling in enumerate(rows):
        alone = sampling.blocks(8, sampling.build_state(
            confs[r], dtype=np.float64, device="cpu"))
        for block in fused:
            one = next(alone)
            for name in one.iter_props._fields:
                np.testing.assert_allclose(
                    getattr(block.iter_props, name)[r].double().numpy(),
                    getattr(one.iter_props, name).double().numpy(),
                    rtol=1e-12, atol=1e-12)
            for name in ("iter_ssf", "iter_obd", "iter_g2"):
                if getattr(one, name) is not None:
                    _close(getattr(block, name)[r], getattr(one, name))
            assert block.accept_rate[r] == one.accept_rate


@pytest.mark.parametrize("gaussian", [False, True])
def test_fused_vmc_step_matches_jax_replay_per_row(gaussian):
    nts, chains = 6, 16
    jrows = [jvmc.Sampling(jmrbp.Spec(**_vmc_kw(rm, sc)), spread, rng_seed=3,
                           num_walkers=chains, gaussian=gaussian)
             for rm, sc, spread in VMC_ROWS]
    trows = tuple(tvmc.Sampling(tmrbp.Spec(**_vmc_kw(rm, sc)), spread,
                                rng_seed=3, num_walkers=chains,
                                gaussian=gaussian)
                  for rm, sc, spread in VMC_ROWS)
    confs = [_confs(sc, chains, r) for r, (_, sc, _) in enumerate(VMC_ROWS)]
    rng = np.random.default_rng(9)
    moves = (rng.standard_normal((nts, 3, chains, NOP)) * 0.3 if gaussian
             else rng.random((nts, 3, chains, NOP)))
    accept = rng.random((nts, 3, chains))
    sweep = VmcSweep(trows)
    got = sweep.replay_chain(sweep.build_states(confs, dtype=np.float64,
                                                device="cpu"), moves, accept)
    for r, jsampling in enumerate(jrows):
        want = jsampling.replay_chain(jsampling.build_state(confs[r]),
                                      moves[:, r], accept[:, r])
        np.testing.assert_array_equal(got[2][:, r].numpy(),
                                      np.asarray(want[2]))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g[:, r].numpy(), np.asarray(w),
                                       rtol=1e-12, atol=1e-12)


# -- validation, with the JAX package's texts -----------------------------------

def _both(cls_t, cls_j, rows_t, rows_j, **kw):
    with pytest.raises(ValueError) as ours:
        cls_t(tuple(rows_t), **kw)
    with pytest.raises(ValueError) as theirs:
        cls_j(tuple(rows_j), **kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("bad", ["empty", "static", "buffers", "estimators"])
def test_param_sweep_validation_matches_jax(bad):
    def rows(pkg, mrbp):
        base = [pkg.Sampling(mrbp.Spec(**_spec_kw(gn, sc)), dt, MAX_W,
                             TARGET, rng_seed=1) for gn, sc, dt in ROWS]
        if bad == "empty":
            return []
        if bad == "static":
            spec = mrbp.Spec(**_spec_kw(0.0, 8.0))
            return base + [pkg.Sampling(spec, 1e-2, MAX_W, TARGET)]
        if bad == "buffers":
            return base + [pkg.Sampling(mrbp.Spec(**_spec_kw(1.0, 8.0)),
                                        1e-2, MAX_W + 8, TARGET)]
        return base + [pkg.Sampling(
            mrbp.Spec(**_spec_kw(1.0, 8.0)), 1e-2, MAX_W, TARGET,
            density_est_spec=pkg.DensityEstSpec(4))]

    _both(ParamSweep, jsweep.ParamSweep, rows(tdmc, tmrbp),
          rows(jdmc, jmrbp))


@pytest.mark.parametrize("bad", ["empty", "static", "chains"])
def test_vmc_sweep_validation_matches_jax(bad):
    def rows(pkg, mrbp):
        base = [pkg.Sampling(mrbp.Spec(**_vmc_kw(0.3, 8.0)), 0.4,
                             num_walkers=16)]
        if bad == "empty":
            return []
        if bad == "static":
            return base + [pkg.Sampling(mrbp.Spec(**dict(
                _vmc_kw(0.3, 8.0), interaction_strength=0.0)), 0.4,
                num_walkers=16)]
        return base + [pkg.Sampling(mrbp.Spec(**_vmc_kw(0.3, 8.0)), 0.4,
                                    num_walkers=8)]

    _both(VmcSweep, jsweep.VmcSweep, rows(tvmc, tmrbp), rows(jvmc, jmrbp))


def test_sweep_refusals_by_name():
    """A mesh is no longer refused: one of other rows than samplings, or
    of walker shards that do not divide the buffers, fails the JAX
    package's checks with its texts."""
    import jax

    from phd_qmclib_torch.parallel import make_walker_mesh

    rows = _dmc_rows()[:2]
    jrows = tuple(jdmc.Sampling(jmrbp.Spec(**_spec_kw(gn, sc)), dt, MAX_W,
                                TARGET, rng_seed=11 + r)
                  for r, (gn, sc, dt) in enumerate(ROWS[:2]))
    for shape in ((len(rows) + 1, 1), (len(rows), 3)):
        jmesh = jax.make_mesh(shape, ("sweep", "walkers"),
                              devices=jax.devices()[:shape[0] * shape[1]])
        with pytest.raises(ValueError) as theirs:
            jsweep.ParamSweep(jrows, mesh=jmesh)
        with pytest.raises(ValueError) as ours:
            ParamSweep(rows, mesh=make_walker_mesh(
                shape[0] * shape[1], "cpu", rows=shape[0]))
        assert str(ours.value) == str(theirs.value)
    spec = make_walker_mesh(2 * len(rows), "cpu", rows=len(rows))
    assert ParamSweep(rows, mesh=spec).mesh is spec
    rows = _dmc_rows()
    with pytest.raises(ValueError, match="ref_compat"):
        ParamSweep(rows + (tdmc.Sampling(tmrbp.Spec(**_spec_kw(1.0, 8.0)),
                                         1e-2, MAX_W, TARGET,
                                         ref_compat=True),))
    with pytest.raises(ValueError, match="one configuration set per"):
        ParamSweep(rows).build_states([_confs(8.0, TARGET, 0)],
                                      device="cpu")
    with pytest.raises(ValueError, match="one configuration set per"):
        VmcSweep((tvmc.Sampling(tmrbp.Spec(**_vmc_kw(0.3, 8.0)), 0.4,
                                num_walkers=4),)).build_states([],
                                                               device="cpu")
