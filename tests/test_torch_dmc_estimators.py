"""The port's DMC estimators against the JAX package's, in f64 on the CPU.

The JAX oracle is its own step, ``make_step_fn(measure=True,
injected_noise=True)`` on the measured steps and the ``transport_only``
step on the others, stepped in a Python loop on the same injected comb
uniforms and diffusion noise as :meth:`Sampling.replay_estimators`.
Estimator rows agree within 1e-10 of their scale (f64 sums in another
order, carried through up to 24 steps); histogram counts are equal.
Then :meth:`Sampling.blocks` on the CPU against the estimators' sum
rules and cadences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.samplers import dmc as tdmc
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.samplers import dmc as jdmc

torch.set_num_threads(1)

NOP, MAX_W, TARGET = 16, 64, 48
SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=NOP, supercell_size=16.0, tbf_contact_cutoff=0.4)
#: A time step large enough that the comb clones and kills walkers.
SAMPLING = dict(time_step=1e-2, max_num_walkers=MAX_W,
                target_num_walkers=TARGET, rng_seed=3)
#: Scale of each estimator's values, for the 1e-10 tolerance.
SCALE = {"density": NOP * TARGET, "ssf": NOP ** 2 * TARGET,
         "obd": TARGET, "g2": NOP ** 2 * TARGET, "cmd": TARGET}
COUNTS = ("density", "g2")

CASES = {
    "mixed density and S(k)": (dict(
        density_est_spec=dict(num_bins=8, as_pure_est=False),
        ssf_est_spec=dict(num_modes=5, as_pure_est=False)), 12),
    "pure, est_every 4, mult 2, pfw freezes": (dict(
        density_est_spec=dict(num_bins=8, pfw_num_time_steps=8),
        ssf_est_spec=dict(num_modes=3),
        obd_est_spec=dict(num_pos=4, est_every_mult=2,
                          pfw_num_time_steps=16),
        pair_corr_est_spec=dict(num_bins=6, est_every_mult=2),
        est_every=4), 24),
    "CM diffusion": (dict(cm_diffusion_est=True, est_every=2,
                          obd_est_spec=dict(num_pos=3, as_pure_est=False)),
                     12),
}

_SPEC_TYPES = {"density_est_spec": "DensityEstSpec",
               "ssf_est_spec": "SSFEstSpec", "obd_est_spec": "OBDEstSpec",
               "pair_corr_est_spec": "PairCorrEstSpec",
               "itc_est_spec": "ITCEstSpec"}


def _samplings(**kwargs):
    """The same sampling in both packages."""
    def build(module, model):
        kw = {name: (getattr(module, _SPEC_TYPES[name])(**value)
                     if name in _SPEC_TYPES else value)
              for name, value in kwargs.items()}
        return module.Sampling(model.Spec(**SPEC), **SAMPLING, **kw)
    return build(jdmc, jmrbp), build(tdmc, tmrbp)


def _confs(num: int, seed: int = 0) -> np.ndarray:
    spec = tmrbp.Spec(**SPEC)
    rng = np.random.default_rng(seed)
    return np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(num)])


def _draws(sampling, nts: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.random((nts, MAX_W)),
            sampling.sigma_spread * rng.standard_normal((nts, MAX_W, NOP)))


def _jax_replay(sampling, state, comb_u, xi, aux=None, step_offset=0):
    """The JAX step on injected draws, with ``run_block``'s bookkeeping:
    rows of the measured steps (thinned like ``run_block``), the final
    accumulators and state."""
    cadence = sampling.est_every
    measure = jax.jit(sampling.make_step_fn(measure=True,
                                            injected_noise=True))
    transport = jax.jit(sampling.make_step_fn(
        measure=True, transport_only=True, injected_noise=True))
    cfc = sampling._cast_params(jnp.float64)
    scalars = sampling._scalars(jnp.float64)
    extra = {name: jnp.zeros(shape) for name, shape
             in sampling._pure_aux_shapes().items()}
    if aux is not None:
        extra = {name: jnp.asarray(aux[name]) for name in extra}
    aux_keys = tuple(extra)
    if cadence > 1 and aux_keys:
        extra["anc_perm"] = jnp.arange(MAX_W, dtype=jnp.int32)
    if sampling.itc_est_spec is not None:
        extra["itc_perm"] = jnp.arange(MAX_W, dtype=jnp.int32)
    rows = {}
    for k in range(comb_u.shape[0]):
        measured = (k + 1) % cadence == 0
        state, extra, _, est = (measure if measured else transport)(
            state, extra, {"comb_u": jnp.asarray(comb_u[k]),
                           "xi": jnp.asarray(xi[k])},
            jnp.int32(step_offset + k), scalars, cfc)
        if measured:
            for name, value in est.items():
                rows.setdefault(name, []).append(np.asarray(value))
    rows = {name: np.stack(values) for name, values in rows.items()}
    for names, spec in ((("obd",), sampling.obd_est_spec),
                        (("g2",), sampling.pair_corr_est_spec),
                        (("itc", "itc_nw"), sampling.itc_est_spec)):
        if spec is not None and spec.est_every_mult > 1:
            m = spec.est_every_mult
            for name in names:
                rows[name] = rows[name][m - 1::m]
    return rows, {name: extra[name] for name in aux_keys}, state


def _check(got, want, got_aux, want_aux):
    assert set(got) == set(want)
    for name, rows in got.items():
        assert rows.shape == want[name].shape, name
        if name in COUNTS:
            np.testing.assert_array_equal(rows.numpy(), want[name],
                                          err_msg=name)
        else:
            tol = 1e-10 * SCALE[name]
            np.testing.assert_allclose(rows.numpy(), want[name], rtol=1e-10,
                                       atol=tol, err_msg=name)
    assert set(got_aux) == set(want_aux)
    for name, acc in got_aux.items():
        np.testing.assert_allclose(acc.numpy(), np.asarray(want_aux[name]),
                                   rtol=1e-10, atol=1e-10 * NOP ** 2,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_estimators_match_jax(case):
    kwargs, nts = CASES[case]
    jsampling, tsampling = _samplings(**kwargs)
    jstate = jsampling.build_state(_confs(TARGET))
    comb_u, xi = _draws(jsampling, nts, seed=7)
    want, want_aux, _ = _jax_replay(jsampling, jstate, comb_u, xi)
    got, got_aux, _ = tsampling.replay_estimators(
        tdmc.state_from_numpy(jstate, device="cpu"), comb_u, xi)
    _check(got, want, got_aux, want_aux)
    # The run branched, and measured as many rows as the cadence says.
    nw = tsampling.replay_states(tdmc.state_from_numpy(jstate, device="cpu"),
                                 comb_u, xi)["num_walkers"]
    assert len(set(nw.tolist())) > 1
    for name, rows in got.items():
        every = tsampling.est_every * getattr(
            {"obd": tsampling.obd_est_spec,
             "g2": tsampling.pair_corr_est_spec}.get(name),
            "est_every_mult", 1)
        assert rows.shape[0] == nts // every, name


def test_pfw_window_across_blocks_resumes_from_jax_aux_carry():
    """A 2-block forward-walking window: the JAX ``blocks`` runs the
    first block and yields its accumulators; the port continues the
    window from the converted state and ``aux_carry`` on the same draws
    as the JAX step."""
    nts = 8
    kwargs = dict(density_est_spec=dict(num_bins=8, pfw_num_time_steps=16),
                  ssf_est_spec=dict(num_modes=3, pfw_num_time_steps=16),
                  est_every=2)
    jsampling, tsampling = _samplings(**kwargs)
    assert jsampling.pfw_window_blocks(nts) == 2
    assert tsampling.pfw_window_blocks(nts) == 2
    first = next(jsampling.blocks(jsampling.build_state(_confs(TARGET)),
                                  nts))
    assert set(first.aux_carry) == {"aux_density", "aux_ssf"}
    comb_u, xi = _draws(jsampling, nts, seed=9)
    want, want_aux, _ = _jax_replay(jsampling, first.last_state, comb_u, xi,
                                    aux=first.aux_carry, step_offset=nts)
    got, got_aux, _ = tsampling.replay_estimators(
        tdmc.state_from_numpy(first.last_state, device="cpu"), comb_u, xi,
        aux_in=tdmc.aux_from_numpy(first.aux_carry, device="cpu"),
        step_offset=nts)
    _check(got, want, got_aux, want_aux)
    # The window spans both blocks: the divisor counts the measured
    # steps of both, so the density still integrates to N per walker
    # (to the round-off of dividing each bin by 5, 6, 7 and 8).
    nw = tsampling.replay_states(
        tdmc.state_from_numpy(first.last_state, device="cpu"), comb_u,
        xi)["num_walkers"]
    np.testing.assert_allclose(got["density"].sum(-1).numpy(),
                               NOP * nw[1::2].numpy(), rtol=1e-12)


PRODUCTION_LIKE = dict(
    density_est_spec=dict(num_bins=8), ssf_est_spec=dict(num_modes=4),
    obd_est_spec=dict(num_pos=3, est_every_mult=2),
    pair_corr_est_spec=dict(num_bins=6, est_every_mult=2),
    cm_diffusion_est=True, cm_window_blocks=2)


def test_blocks_sum_rules_burn_and_cadence():
    nts, burn = 16, 1
    _, sampling = _samplings(est_every=4, **PRODUCTION_LIKE)
    blocks = sampling.blocks(
        sampling.build_state(_confs(TARGET), device="cpu"), nts,
        burn_in_blocks=burn)
    first = next(blocks)
    assert first.iter_props.num_walkers.shape == (nts,)
    assert all(getattr(first, name) is None for name in (
        "iter_density", "iter_ssf", "iter_obd", "iter_cmd", "iter_g2",
        "iter_itc", "iter_itc_nw", "aux_carry"))
    for _ in range(2):
        block = next(blocks)
        nw = block.iter_props.num_walkers.to(torch.float64)
        nw4, nw8 = nw[3::4], nw[7::8]
        assert block.iter_density.shape == (nts // 4, 8)
        assert block.iter_ssf.shape == (nts // 4, 4, 3)
        assert block.iter_cmd.shape == (nts // 4, 2)
        assert block.iter_obd.shape == (nts // 8, 3)
        assert block.iter_g2.shape == (nts // 8, 6)
        assert all(x.device.type == "cpu" for x in (
            block.iter_density, block.iter_ssf, block.iter_obd,
            block.iter_cmd, block.iter_g2))
        # Sum rules, to the round-off of the pure estimators' division
        # by their contribution counts.
        torch.testing.assert_close(block.iter_density.sum(-1), NOP * nw4,
                                   rtol=1e-12, atol=0.0)
        torch.testing.assert_close(block.iter_ssf[:, 0, 0],
                                   NOP ** 2 * nw4, rtol=1e-12, atol=0.0)
        torch.testing.assert_close(block.iter_g2.sum(-1),
                                   NOP * (NOP - 1) / 2 * nw8, rtol=0.0,
                                   atol=0.0)
        torch.testing.assert_close(block.iter_obd[:, 0], nw8, rtol=1e-12,
                                   atol=0.0)
        assert (block.iter_cmd[:, 0] > 0).all()
        assert block.aux_carry is None


def test_blocks_cadence_leaves_the_dynamics_alone():
    nts = 16
    props = []
    for every in (1, 4):
        _, sampling = _samplings(est_every=every, **PRODUCTION_LIKE)
        blocks = sampling.blocks(
            sampling.build_state(_confs(TARGET), device="cpu"), nts)
        props.append([next(blocks).iter_props for _ in range(2)])
    for a, b in zip(*props):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_blocks_check_the_block_length():
    _, sampling = _samplings(est_every=4, **PRODUCTION_LIKE)
    state = sampling.build_state(_confs(TARGET), device="cpu")
    with pytest.raises(ValueError, match="obd est_every_mult"):
        next(sampling.blocks(state, 12))
    _, sampling = _samplings(est_every=4)
    with pytest.raises(ValueError, match="divisible by est_every"):
        next(sampling.blocks(state, 10))
    # Burn-in blocks do not measure, so any length runs there.
    next(sampling.blocks(state, 10, burn_in_blocks=1))
    with pytest.raises(ValueError, match="pfw_num_time_steps"):
        _samplings(est_every=4, density_est_spec=dict(
            num_bins=4, pfw_num_time_steps=6))


def test_blocks_carry_a_pfw_window_across_blocks():
    nts = 8
    _, sampling = _samplings(est_every=2, density_est_spec=dict(
        num_bins=8, pfw_num_time_steps=3 * nts))
    blocks = sampling.blocks(
        sampling.build_state(_confs(TARGET), device="cpu"), nts)
    for _ in range(4):
        block = next(blocks)
        assert set(block.aux_carry) == {"aux_density"}
        assert block.aux_carry["aux_density"].shape == (MAX_W, 8)
        nw = block.iter_props.num_walkers.to(torch.float64)[1::2]
        torch.testing.assert_close(block.iter_density.sum(-1), NOP * nw,
                                   rtol=1e-12, atol=0.0)
