"""The port's VMC sampler against the JAX package's, in f64 on the CPU.

The Metropolis chains take their moves and acceptance uniforms from
numpy (``replay_chain``), so both packages step the same chains; the
port's own draws (a ``torch.Generator`` per block) are held to the JAX
package's invariants: the chain dynamics do not depend on the estimator
cadence, and the chunked estimator entries equal the every-step ones at
the measured steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.samplers import vmc as tvmc
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.samplers import vmc as jvmc

torch.set_num_threads(1)

#: f64 agreement of two implementations of the same formulas, summed in
#: other orders.
RTOL = 1e-10

BASE = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.4)
VARIANTS = {
    "bench": BASE,
    "free": dict(BASE, lattice_depth=0.0, interaction_strength=4.0),
    "ideal": dict(BASE, interaction_strength=0.0),
    "defected": dict(BASE, num_defects=4, defect_magnitude=7.5),
}
NUM_WALKERS = 24


def _samplings(variant, **kw):
    kwargs = VARIANTS[variant]
    return (jvmc.Sampling(jmrbp.Spec(**kwargs), **kw),
            tvmc.Sampling(tmrbp.Spec(**kwargs), **kw))


def _confs(seed, num_walkers=NUM_WALKERS, nop=16, sc=16.0):
    return np.random.default_rng(seed).uniform(0, sc, (num_walkers, nop))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol)


def test_fourier_density_parts_matches_jax():
    spec = jmrbp.Spec(**BASE)
    kz = np.arange(7) * 2 * np.pi / 16.0
    pos = _confs(1, 5)
    cfc = jax.tree.map(jnp.float64, spec.cfc_params)
    want = jmrbp.core_funcs(spec).fourier_density_parts(
        jnp.asarray(kz), jnp.asarray(pos), cfc)
    want_rho = jmrbp.core_funcs(spec).fourier_density(
        jnp.asarray(kz), jnp.asarray(pos), cfc)
    funcs = tmrbp.core_funcs(tmrbp.Spec(**BASE))
    got = funcs.fourier_density_parts(torch.as_tensor(kz),
                                      torch.as_tensor(pos), None)
    assert got.shape == (5, 7, 3)
    _close(got, want, 1e-12)
    got_rho = funcs.fourier_density(torch.as_tensor(kz),
                                    torch.as_tensor(pos), None)
    np.testing.assert_allclose(got_rho.numpy(), np.asarray(want_rho),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_state_matches_jax(variant):
    kw = dict(move_spread=0.4, rng_seed=3, num_walkers=NUM_WALKERS,
              ssf_est_spec=jvmc.SSFEstSpec(num_modes=6),
              obd_est_spec=jvmc.OBDEstSpec(num_pos=5))
    jax_sampling = jvmc.Sampling(jmrbp.Spec(**VARIANTS[variant]), **kw)
    torch_sampling = tvmc.Sampling(
        tmrbp.Spec(**VARIANTS[variant]),
        **dict(kw, ssf_est_spec=tvmc.SSFEstSpec(num_modes=6),
               obd_est_spec=tvmc.OBDEstSpec(num_pos=5)))
    confs = _confs(2)
    want = jax_sampling.build_state(confs)
    got = torch_sampling.build_state(confs, device="cpu")
    assert got.pos.dtype == torch.float64
    assert torch.equal(got.pos, torch.as_tensor(confs))
    for name in ("wf_abs_log", "energy", "ssf_parts", "obd_parts"):
        _close(getattr(got, name), getattr(want, name))
    assert bool(got.move_stat.all())
    # One configuration starts every chain.
    one = torch_sampling.build_state(confs[0], device="cpu")
    assert one.pos.shape == (NUM_WALKERS, 16)
    _close(one.wf_abs_log, np.full(NUM_WALKERS, float(got.wf_abs_log[0])))


@pytest.mark.parametrize("gaussian", [False, True],
                         ids=["uniform", "gaussian"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_replay_chain_matches_jax(variant, gaussian):
    """The Metropolis chains on injected moves and acceptance uniforms:
    equal acceptance decisions, positions and log|psi| within 1e-10."""
    spread = 0.15 if gaussian else 0.4
    jax_sampling, torch_sampling = _samplings(
        variant, move_spread=spread, rng_seed=5, num_walkers=NUM_WALKERS,
        gaussian=gaussian)
    rng = np.random.default_rng(7)
    confs = _confs(8)
    nts = 24
    if gaussian:
        moves = spread * rng.standard_normal((nts, NUM_WALKERS, 16))
    else:
        moves = rng.random((nts, NUM_WALKERS, 16))
    accept_u = rng.random((nts, NUM_WALKERS))
    j_pos, j_lp, j_acc = jax_sampling.replay_chain(
        jax_sampling.build_state(confs), moves, accept_u)
    t_pos, t_lp, t_acc = torch_sampling.replay_chain(
        torch_sampling.build_state(confs, device="cpu"), moves, accept_u)
    assert t_acc.dtype == torch.bool and t_pos.shape == (nts, NUM_WALKERS,
                                                          16)
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    # Some moves accepted and some rejected (all of them in the free
    # ideal limit only).
    assert 0 < int(t_acc.sum()) < t_acc.numel()
    _close(t_pos, j_pos)
    _close(t_lp, j_lp)


def test_replay_chain_single_chain_broadcasts():
    """``(nts, N)`` moves and ``(nts,)`` uniforms drive every chain."""
    jax_sampling, torch_sampling = _samplings("bench", move_spread=0.4,
                                              rng_seed=5, num_walkers=1)
    rng = np.random.default_rng(9)
    conf = _confs(10, 1)[0]
    moves, accept_u = rng.random((12, 16)), rng.random(12)
    want = jax_sampling.replay_chain(jax_sampling.build_state(conf), moves,
                                     accept_u)
    got = torch_sampling.replay_chain(
        torch_sampling.build_state(conf, device="cpu"), moves, accept_u)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        _close(a, b)


def test_state_from_numpy_continues_a_jax_chain():
    jax_sampling, torch_sampling = _samplings(
        "defected", move_spread=0.4, rng_seed=5, num_walkers=NUM_WALKERS,
        ssf_est_spec=None)
    jax_state = next(jax_sampling.blocks(
        16, jax_sampling.build_state(_confs(11)))).last_state
    state = tvmc.state_from_numpy(jax_state, device="cpu")
    assert state.move_stat.dtype == torch.bool and state.ssf_parts is None
    rng = np.random.default_rng(12)
    moves, accept_u = rng.random((8, NUM_WALKERS, 16)), rng.random(
        (8, NUM_WALKERS))
    want = jax_sampling.replay_chain(jax_state, moves, accept_u)
    got = torch_sampling.replay_chain(state, moves, accept_u)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        _close(a, b)


def _run_blocks(sampling, ini, nts=16, num_blocks=2):
    blocks = sampling.blocks(nts, ini)
    return [next(blocks) for _ in range(num_blocks)]


@pytest.mark.parametrize("gaussian", [False, True],
                         ids=["uniform", "gaussian"])
def test_cadence_leaves_the_chains_unchanged(gaussian):
    """The chain dynamics with ``est_every`` 1 and 4 are identical, and
    the chunked S(k) and OBDM entries equal the every-step entries at
    the measured steps."""
    est = dict(ssf_est_spec=tvmc.SSFEstSpec(num_modes=6),
               obd_est_spec=tvmc.OBDEstSpec(num_pos=5))
    spec = tmrbp.Spec(**VARIANTS["defected"])
    kw = dict(move_spread=0.15 if gaussian else 0.4, rng_seed=21,
              num_walkers=NUM_WALKERS, gaussian=gaussian)
    every = tvmc.Sampling(spec, **kw, **est)
    chunked = tvmc.Sampling(
        spec, est_every=4, **kw,
        **dict(est, obd_est_spec=tvmc.OBDEstSpec(num_pos=5,
                                                 est_every_mult=2)))
    confs = _confs(13)
    a = _run_blocks(every, every.build_state(confs, device="cpu"))
    b = _run_blocks(chunked, chunked.build_state(confs, device="cpu"))
    for x, y in zip(a, b):
        for name in ("wf_abs_log", "energy", "move_stat"):
            assert torch.equal(getattr(x.iter_props, name),
                               getattr(y.iter_props, name))
        assert torch.equal(x.last_state.pos, y.last_state.pos)
        assert x.accept_rate == y.accept_rate
        assert x.iter_ssf.shape == (16, 6, 3) and y.iter_ssf.shape == (4, 6,
                                                                       3)
        _close(y.iter_ssf, x.iter_ssf[3::4])
        assert y.iter_obd.shape == (2, 5)
        _close(y.iter_obd, x.iter_obd[7::8])
        assert x.iter_g2 is None and y.iter_g2 is None
    # The every-step mode carries the parts; the chunked mode does not.
    assert a[-1].last_state.ssf_parts.shape == (NUM_WALKERS, 6, 3)
    assert b[-1].last_state.ssf_parts is None


def test_g2_cadence():
    """The g2 histogram (which always takes the chunked path) at
    ``est_every`` 1 and 4: equal counts at the measured steps, and its
    sum rule N (N - 1) / 2 per chain."""
    spec = tmrbp.Spec(**BASE)
    kw = dict(move_spread=0.4, rng_seed=22, num_walkers=NUM_WALKERS)
    one = tvmc.Sampling(spec, pair_corr_est_spec=tvmc.PairCorrEstSpec(12),
                        **kw)
    four = tvmc.Sampling(spec, est_every=4,
                         pair_corr_est_spec=tvmc.PairCorrEstSpec(
                             12, est_every_mult=2), **kw)
    confs = _confs(14)
    a = _run_blocks(one, one.build_state(confs, device="cpu"))
    b = _run_blocks(four, four.build_state(confs, device="cpu"))
    for x, y in zip(a, b):
        assert torch.equal(x.iter_props.energy, y.iter_props.energy)
        assert x.iter_g2.shape == (16, 12) and y.iter_g2.shape == (2, 12)
        assert torch.equal(y.iter_g2, x.iter_g2[7::8])
        assert bool((x.iter_g2.sum(-1) == 120 * NUM_WALKERS).all())


def test_block_stream_and_offset():
    """Blocks are reproducible by seed, a continuation with
    ``block_offset`` draws what the whole run drew, and the acceptance
    rate is the mean of the flags."""
    spec = tmrbp.Spec(**BASE)
    sampling = tvmc.Sampling(spec, move_spread=0.4, rng_seed=23,
                             num_walkers=NUM_WALKERS)
    ini = sampling.build_state(_confs(15), device="cpu")
    first, second = _run_blocks(sampling, ini)
    again = next(sampling.blocks(16, first.last_state, block_offset=1))
    assert torch.equal(again.iter_props.energy, second.iter_props.energy)
    assert first.accept_rate == pytest.approx(
        float(first.iter_props.move_stat.double().mean()), abs=0)
    other = tvmc.Sampling(spec, move_spread=0.4, rng_seed=24,
                          num_walkers=NUM_WALKERS)
    assert not torch.equal(next(other.blocks(16, ini)).iter_props.energy,
                           first.iter_props.energy)
    # The energies are the model's at the chain positions.
    lp, e = sampling.core_funcs.log_psi_and_energy(second.last_state.pos,
                                                   sampling.cfc_params)
    assert torch.equal(lp, second.last_state.wf_abs_log)
    assert torch.equal(e, second.iter_props.energy[-1])


def test_a_run_packs_the_kernel_parameters_once(monkeypatch):
    """The steps take the packed parameter vector from the run's
    constants: one ``pack_params`` per block run and one per
    ``build_state``, none per step."""
    from phd_qmclib_torch.ops import pairwise
    packs = []
    pack_params = pairwise.pack_params
    monkeypatch.setattr(pairwise, "pack_params",
                        lambda *a: packs.append(1) or pack_params(*a))
    sampling = tvmc.Sampling(tmrbp.Spec(**BASE), move_spread=0.4,
                             rng_seed=23, num_walkers=NUM_WALKERS,
                             ssf_est_spec=tvmc.SSFEstSpec(num_modes=4))
    ini = sampling.build_state(_confs(15), device="cpu")
    assert len(packs) == 1
    blocks = sampling.blocks(16, ini)
    next(blocks)
    next(blocks)
    assert len(packs) == 2


def test_state_data_blocks_and_states():
    sampling = tvmc.Sampling(tmrbp.Spec(**BASE), move_spread=0.4,
                             rng_seed=25, num_walkers=NUM_WALKERS,
                             ssf_est_spec=tvmc.SSFEstSpec(num_modes=4))
    ini = sampling.build_state(_confs(16), device="cpu")
    confs, block = next(sampling.state_data_blocks(16, ini, thin=4))
    assert confs.shape == (4, NUM_WALKERS, 16)
    assert torch.equal(confs[-1], block.last_state.pos)
    # The same draws as blocks().
    plain = next(sampling.blocks(16, ini))
    assert torch.equal(plain.iter_props.energy, block.iter_props.energy)
    assert torch.equal(plain.iter_ssf, block.iter_ssf)
    s1, s2 = (state for state, _ in zip(sampling.states(ini), range(2)))
    assert s1.pos.shape == s2.pos.shape == (NUM_WALKERS, 16)
    with pytest.raises(ValueError, match="thin"):
        next(sampling.state_data_blocks(16, ini, thin=5))
    with pytest.raises(ValueError, match="at least 1"):
        sampling.as_chain(0, ini)


def test_free_ideal_limit_accepts_every_move():
    """log|psi| = 0: every move is accepted and the energy is 0."""
    sampling = tvmc.Sampling(
        tmrbp.Spec(**dict(BASE, lattice_depth=0.0, interaction_strength=0.0)),
        move_spread=1.0, rng_seed=26, num_walkers=8)
    block = sampling.as_chain(
        32, sampling.build_state(_confs(17, 8), device="cpu"))
    assert block.accept_rate == 1.0
    assert not block.iter_props.energy.any()
    pos = block.last_state.pos
    assert bool(((0 <= pos) & (pos < 16.0)).all())


def test_invalid_cadence_raises():
    spec = tmrbp.Spec(**BASE)
    with pytest.raises(ValueError, match="est_every"):
        tvmc.Sampling(spec, move_spread=0.4, est_every=0)
    with pytest.raises(ValueError, match="est_every_mult"):
        tvmc.Sampling(spec, move_spread=0.4,
                      obd_est_spec=tvmc.OBDEstSpec(3, est_every_mult=0))
    sampling = tvmc.Sampling(spec, move_spread=0.4, rng_seed=1,
                             num_walkers=2, est_every=4,
                             ssf_est_spec=tvmc.SSFEstSpec(3))
    with pytest.raises(ValueError, match="divisible"):
        next(sampling.blocks(
            6, sampling.build_state(_confs(18, 2), device="cpu")))
