"""The port's imaginary-time-correlation estimator F(k, tau) against the
JAX package's, in f64 on the CPU.

The oracle is the JAX measuring step on injected draws (the harness of
``test_torch_dmc_estimators``): the lag sums agree within 1e-10 of their
scale, the counts are equal, the ring buffer agrees within 1e-12 and the
fill counter is equal.  Then the estimator's own invariants: lag 0 equal
to the S(k) slot-0 sums bit for bit, the k = 0 rule, the discounted
initial fill, the composed transport against a NumPy oracle that gathers
through the parents on every step, and the fill rules of ``blocks``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.samplers import dmc as tdmc
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.samplers import dmc as jdmc
from tests.test_torch_dmc_estimators import (
    MAX_W, NOP, SPEC, TARGET, _confs, _draws, _jax_replay, _samplings)

torch.set_num_threads(1)

MODES, LAGS = 4, 3
#: Scale of the lag sums, for the 1e-10 tolerance.
ITC_SCALE = NOP ** 2 * TARGET


def _state(sampling, seed=0):
    return sampling.build_state(_confs(TARGET, seed), device="cpu")


def _itc(pure=False, mult=1, **kwargs):
    return dict(num_modes=MODES, num_lags=LAGS, est_every_mult=mult,
                as_pure_est=pure, **kwargs)


# -- the amplitudes ------------------------------------------------------------

@pytest.mark.parametrize("num_modes", [1, 2, 7])
def test_reim_harmonics_match_jax_and_the_ssf_slots(num_modes):
    jspec, tspec = jmrbp.Spec(**SPEC), tmrbp.Spec(**SPEC)
    pos = np.random.default_rng(num_modes).uniform(0, 16.0, (5, 3, NOP))
    want = jmrbp.core_funcs(jspec).fourier_density_reim_harmonics(
        num_modes, jnp.asarray(pos), jspec.cfc_params)
    funcs = tmrbp.core_funcs(tspec)
    cfc = tmrbp.cast_params(tspec.cfc_params, torch.float64, "cpu")
    tpos = torch.tensor(pos)
    got = funcs.fourier_density_reim_harmonics(num_modes, tpos, cfc)
    assert got.shape == (5, 3, num_modes, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    parts = funcs.fourier_density_parts_harmonics(num_modes, tpos, cfc)
    assert torch.equal(got, parts[..., 1:3])


# -- the measuring step against JAX --------------------------------------------

#: S(k) with at least the ITC's modes (the amplitudes are its slots),
#: with fewer (they are recomputed), and off.
SSF_CASES = {"ssf>=": dict(num_modes=MODES + 1, as_pure_est=False),
             "ssf<": dict(num_modes=MODES - 2), "no ssf": None}
REPLAY_CASES = list(itertools.product(
    (False, True), (1, 2), (1, 3), sorted(SSF_CASES)))


@pytest.mark.parametrize(
    "pure,est_every,mult,ssf", REPLAY_CASES,
    ids=[f"{'pure' if p else 'mixed'}-every{e}-mult{m}-{s}"
         for p, e, m, s in REPLAY_CASES])
def test_replay_matches_jax(pure, est_every, mult, ssf):
    nts = 24
    kwargs = dict(est_every=est_every, itc_est_spec=_itc(
        pure, mult, **(dict(pfw_num_time_steps=12) if pure else {})))
    if SSF_CASES[ssf] is not None:
        kwargs["ssf_est_spec"] = SSF_CASES[ssf]
    jsampling, tsampling = _samplings(**kwargs)
    jstate = jsampling.build_state(_confs(TARGET))
    comb_u, xi = _draws(jsampling, nts, seed=11)
    want, want_aux, want_state = _jax_replay(jsampling, jstate, comb_u, xi)
    tstate = tdmc.state_from_numpy(jstate, device="cpu")
    got, got_aux, got_state = tsampling.replay_estimators(tstate, comb_u, xi)

    num_rows = nts // (est_every * mult)
    assert got["itc"].shape == (num_rows, LAGS + 1, MODES)
    assert got["itc_nw"].shape == (num_rows, LAGS + 1)
    np.testing.assert_allclose(got["itc"].numpy(), want["itc"], rtol=1e-10,
                               atol=1e-10 * ITC_SCALE)
    if pure:
        np.testing.assert_allclose(got["itc_nw"].numpy(), want["itc_nw"],
                                   rtol=1e-13, atol=0)
    else:
        np.testing.assert_array_equal(got["itc_nw"].numpy(), want["itc_nw"])
    np.testing.assert_allclose(got_state.itc_buf.numpy(),
                               np.asarray(want_state.itc_buf), rtol=0,
                               atol=1e-12)
    assert int(got_state.itc_filled) == int(want_state.itc_filled) \
        == min(num_rows, LAGS)
    assert set(got_aux) == set(want_aux)
    assert ("aux_itc" in got_aux) == ("aux_itc_cnt" in got_aux) == pure
    for name, acc in got_aux.items():
        np.testing.assert_allclose(acc.numpy(), np.asarray(want_aux[name]),
                                   rtol=1e-10, atol=1e-10 * NOP ** 2,
                                   err_msg=name)
    if "ssf" in got:
        np.testing.assert_allclose(got["ssf"].numpy(), want["ssf"],
                                   rtol=1e-10, atol=1e-10 * ITC_SCALE)
    # Walkers were cloned and killed between the ITC steps.
    replay = tsampling.replay_states(tstate, comb_u, xi)
    assert len(set(replay["num_walkers"].tolist())) > 1
    slots = torch.arange(MAX_W)
    assert any(not torch.equal(p, slots) for p in replay["parent"])


# -- invariants ----------------------------------------------------------------

def _block_after_burn(sampling, nts=12, **kwargs):
    blocks = sampling.blocks(_state(sampling), nts, burn_in_blocks=1,
                             **kwargs)
    next(blocks)
    return next(blocks)


def test_lag0_equals_mixed_ssf_slot0_bit_for_bit():
    _, sampling = _samplings(
        ssf_est_spec=dict(num_modes=MODES, as_pure_est=False),
        itc_est_spec=_itc())
    block = _block_after_burn(sampling)
    assert torch.equal(block.iter_itc[:, 0, :], block.iter_ssf[:, :, 0])


def test_lag0_equals_mixed_ssf_slot0_with_more_ssf_modes():
    _, sampling = _samplings(
        ssf_est_spec=dict(num_modes=MODES + 3, as_pure_est=False),
        itc_est_spec=_itc())
    block = _block_after_burn(sampling)
    assert torch.equal(block.iter_itc[:, 0, :],
                       block.iter_ssf[:, :MODES, 0])


def test_pure_lag0_accumulator_equals_pure_ssf_bit_for_bit():
    """Lag 0 of the pure ITC is the same per-walker quantity as the pure
    S(k) slot 0, accumulated at the same steps and carried through the
    same parents: the two accumulators are equal bit for bit, which
    holds the ITC pair's transport against the S(k) one's.  Their walker
    sums run over tensors of different shapes, so the emitted rows agree
    to the round-off of a sum in another order."""
    _, sampling = _samplings(est_every=2, ssf_est_spec=dict(num_modes=MODES),
                             itc_est_spec=_itc(pure=True))
    comb_u, xi = _draws(sampling, 24, seed=3)
    got, aux, state = sampling.replay_estimators(_state(sampling), comb_u,
                                                 xi)
    # On the valid slots: S(k) leaves the dead slots unmasked until it
    # sums, the ITC masks what it adds.
    nw = int(state.num_walkers)
    assert aux["aux_itc"][:nw, 0, 1:].all()
    assert torch.equal(aux["aux_itc"][:nw, 0, :], aux["aux_ssf"][:nw, :, 0])
    torch.testing.assert_close(got["itc"][:, 0, :], got["ssf"][:, :, 0],
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("pure", [False, True], ids=["mixed", "pure"])
def test_k0_sum_rule(pure):
    _, sampling = _samplings(itc_est_spec=_itc(pure=pure))
    block = _block_after_burn(sampling)
    torch.testing.assert_close(block.iter_itc[:, :, 0],
                               NOP ** 2 * block.iter_itc_nw, rtol=1e-12,
                               atol=0)
    nw = block.iter_props.num_walkers.to(torch.float64)
    torch.testing.assert_close(block.iter_itc_nw[:, 0], nw, rtol=1e-12,
                               atol=0)


def test_initial_fill_is_discounted():
    nts = 12
    _, sampling = _samplings(itc_est_spec=_itc())
    block = next(sampling.blocks(_state(sampling), nts))
    itc, nw = block.iter_itc, block.iter_itc_nw
    # Step t (0-based) has min(t, LAGS) filled lag rows.
    assert torch.equal((nw[:, 1:] > 0).sum(dim=1),
                       torch.clamp(torch.arange(nts), max=LAGS))
    # Unfilled rows carry zero sums and zero counts.
    assert (itc[:, 1:, :][nw[:, 1:] == 0] == 0.0).all()
    assert int(block.last_state.itc_filled) == LAGS
    assert block.last_state.itc_filled.dtype == torch.int32


def _amplitudes(sampling, cpos):
    cfc = tmrbp.cast_params(sampling.cfc_params, torch.float64, "cpu")
    return sampling.core_funcs.fourier_density_reim_harmonics(
        MODES, cpos, cfc).numpy()


@pytest.mark.parametrize("pure,est_every,mult",
                         [(False, 1, 1), (False, 2, 3), (True, 1, 1),
                          (True, 2, 3), (True, 1, 2)],
                         ids=lambda v: str(v))
def test_composed_transport_matches_a_numpy_oracle(pure, est_every, mult):
    """The oracle gathers the ring buffer (and the pure accumulators)
    through the parents on EVERY step, and measures with the port's own
    amplitudes: the port's single gather through the composed
    permutation must give the same buffer and accumulators bit for
    bit."""
    nts = 24
    _, sampling = _samplings(est_every=est_every,
                             itc_est_spec=_itc(pure, mult))
    state = _state(sampling)
    comb_u, xi = _draws(sampling, nts, seed=5)
    got, got_aux, got_state = sampling.replay_estimators(state, comb_u, xi)
    replay = sampling.replay_states(state, comb_u, xi)

    buf = np.zeros((MAX_W, LAGS, MODES, 2))
    aux = np.zeros((MAX_W, LAGS + 1, MODES))
    aux_cnt = np.zeros((MAX_W, LAGS + 1))
    filled, prev_pos = 0, state.pos
    sums, counts = [], []
    for step in range(nts):
        parent = replay["parent"][step].numpy()
        nw = int(replay["num_walkers"][step])
        valid = np.arange(MAX_W) < nw
        cpos = prev_pos[parent]
        prev_pos = replay["pos"][step]
        buf, aux, aux_cnt = buf[parent], aux[parent], aux_cnt[parent]
        if (step + 1) % (est_every * mult):
            continue
        reim = _amplitudes(sampling, cpos)
        re, im = reim[..., 0], reim[..., 1]
        maskf = valid.astype(float)
        sq = np.where(valid[:, None], re ** 2 + im ** 2, 0.0)
        prod = (buf[..., 0] * re[:, None] + buf[..., 1] * im[:, None]) \
            * maskf[:, None, None]
        lag_ok = (np.arange(1, LAGS + 1) <= filled).astype(float)
        if pure:
            aux = aux + np.concatenate([sq[:, None], prod], axis=1)
            aux_cnt = aux_cnt + maskf[:, None] * np.concatenate(
                [[1.0], lag_ok])
            divisor = (step + 1) // (est_every * mult)
            sums.append((aux * maskf[:, None, None]).sum(axis=0) / divisor)
            counts.append((aux_cnt * maskf[:, None]).sum(axis=0) / divisor)
        else:
            sums.append(np.concatenate([sq.sum(axis=0)[None],
                                        prod.sum(axis=0)]))
            counts.append(np.concatenate([[float(nw)], nw * lag_ok]))
        buf = np.concatenate([reim[:, None], buf[:, :-1]], axis=1)
        filled = min(filled + 1, LAGS)

    np.testing.assert_array_equal(got_state.itc_buf.numpy(), buf)
    assert int(got_state.itc_filled) == filled
    if pure:
        np.testing.assert_array_equal(got_aux["aux_itc"].numpy(), aux)
        np.testing.assert_array_equal(got_aux["aux_itc_cnt"].numpy(),
                                      aux_cnt)
    np.testing.assert_allclose(got["itc"].numpy(), np.stack(sums),
                               rtol=1e-10, atol=1e-10 * ITC_SCALE)
    np.testing.assert_allclose(got["itc_nw"].numpy(), np.stack(counts),
                               rtol=1e-13, atol=0)


@pytest.mark.parametrize("pure", [False, True], ids=["mixed", "pure"])
def test_mult_equals_the_equivalent_cadence(pure):
    blocks = []
    for est_every, mult in ((1, 2), (2, 1)):
        _, sampling = _samplings(est_every=est_every,
                                 itc_est_spec=_itc(pure, mult))
        blocks.append((_block_after_burn(sampling), sampling))
    (a, sa), (b, sb) = blocks
    assert a.iter_itc.shape == (6, LAGS + 1, MODES)
    assert torch.equal(a.iter_itc, b.iter_itc)
    assert torch.equal(a.iter_itc_nw, b.iter_itc_nw)
    assert torch.equal(a.last_state.itc_buf, b.last_state.itc_buf)
    assert torch.equal(a.last_state.pos, b.last_state.pos)
    np.testing.assert_array_equal(sa.itc_lag_times, sb.itc_lag_times)
    np.testing.assert_allclose(
        sa.itc_lag_times, np.arange(LAGS + 1) * 2 * sa.time_step)


@pytest.mark.parametrize("itc", [_itc(), _itc(pure=True, mult=2)],
                         ids=["mixed", "pure-mult2"])
def test_dynamics_bit_identical_with_the_estimator_on(itc):
    finals = []
    for kwargs in (dict(itc_est_spec=itc), {}):
        _, sampling = _samplings(
            ssf_est_spec=dict(num_modes=MODES, as_pure_est=False),
            **kwargs)
        finals.append(_block_after_burn(sampling))
    on, off = finals
    assert off.iter_itc is None and off.last_state.itc_buf is None
    assert torch.equal(on.last_state.pos, off.last_state.pos)
    for x, y in zip(on.iter_props, off.iter_props):
        assert torch.equal(x, y)
    assert torch.equal(on.iter_ssf, off.iter_ssf)


# -- blocks --------------------------------------------------------------------

def test_burn_blocks_yield_no_rows_and_leave_the_buffer_zero():
    _, sampling = _samplings(itc_est_spec=_itc(pure=True))
    burn = next(sampling.blocks(_state(sampling), 12, burn_in_blocks=1))
    assert burn.iter_itc is None and burn.iter_itc_nw is None
    assert burn.aux_carry is None
    assert not burn.last_state.itc_buf.any()
    assert int(burn.last_state.itc_filled) == 0


def test_continuation_with_burn_restarts_the_fill():
    nts = 12
    _, sampling = _samplings(itc_est_spec=_itc())
    blocks = sampling.blocks(_state(sampling), nts)
    for _ in range(2):
        carried = next(blocks).last_state
    assert int(carried.itc_filled) == LAGS and carried.itc_buf.any()

    cont = sampling.blocks(carried, nts, burn_in_blocks=1, block_offset=2)
    assert next(cont).iter_itc is None
    first = next(cont)
    assert torch.equal((first.iter_itc_nw[:, 1:] > 0).sum(dim=1),
                       torch.clamp(torch.arange(nts), max=LAGS))
    # The same rows as from a state whose buffer was zeroed by hand.
    zeroed = carried._replace(itc_buf=torch.zeros_like(carried.itc_buf),
                              itc_filled=torch.zeros_like(
                                  carried.itc_filled))
    ref = sampling.blocks(zeroed, nts, burn_in_blocks=1, block_offset=2)
    next(ref)
    assert torch.equal(first.iter_itc, next(ref).iter_itc)
    # Without burn-in blocks the continuation keeps its fill.
    kept = next(sampling.blocks(carried, nts, block_offset=2))
    assert (kept.iter_itc_nw[:, 1:] > 0).all()


def test_a_state_without_the_buffer_starts_an_empty_fill():
    _, plain = _samplings()
    _, sampling = _samplings(itc_est_spec=_itc())
    state = _state(plain)
    assert state.itc_buf is None
    block = next(sampling.blocks(state, 4))
    assert block.last_state.itc_buf.shape == (MAX_W, LAGS, MODES, 2)
    assert int(block.last_state.itc_filled) == LAGS
    assert torch.equal(block.iter_itc,
                       next(sampling.blocks(_state(sampling), 4)).iter_itc)


def test_a_window_spanning_two_blocks_carries_the_itc_accumulators():
    nts = 6
    _, sampling = _samplings(est_every=2, itc_est_spec=_itc(
        pure=True, pfw_num_time_steps=2 * nts))
    assert sampling.pfw_window_blocks(nts) == 2
    blocks = sampling.blocks(_state(sampling), nts)
    first, second, third = (next(blocks) for _ in range(3))
    for block in (first, second, third):
        assert set(block.aux_carry) == {"aux_itc", "aux_itc_cnt"}
        assert block.aux_carry["aux_itc"].shape == (MAX_W, LAGS + 1, MODES)
        assert block.aux_carry["aux_itc_cnt"].shape == (MAX_W, LAGS + 1)
        torch.testing.assert_close(block.iter_itc[:, :, 0],
                                   NOP ** 2 * block.iter_itc_nw,
                                   rtol=1e-12, atol=0)
    # The window's divisor counts the measured steps of both blocks:
    # the equal-time counts stay the walker count.
    nw = second.iter_props.num_walkers.to(torch.float64)[1::2]
    torch.testing.assert_close(second.iter_itc_nw[:, 0], nw, rtol=1e-12,
                               atol=0)
    # A new window opens with the third block: one contribution at its
    # first measured step, against four by the end of the second.
    cnt = [block.aux_carry["aux_itc_cnt"][:, 0].max()
           for block in (first, second, third)]
    assert [int(c) for c in cnt] == [3, 6, 3]


def test_a_jax_state_with_a_filled_buffer_continues_in_the_port():
    nts = 12
    kwargs = dict(est_every=2, itc_est_spec=_itc(mult=2),
                  ssf_est_spec=dict(num_modes=MODES, as_pure_est=False))
    jsampling, tsampling = _samplings(**kwargs)
    first = next(jsampling.blocks(jsampling.build_state(_confs(TARGET)),
                                  nts))
    assert int(first.last_state.itc_filled) == LAGS
    tstate = tdmc.state_from_numpy(first.last_state, device="cpu")
    np.testing.assert_array_equal(tstate.itc_buf.numpy(),
                                  np.asarray(first.last_state.itc_buf))
    assert tstate.itc_filled.dtype == torch.int32
    assert int(tstate.itc_filled) == LAGS
    comb_u, xi = _draws(jsampling, nts, seed=13)
    want, _, want_state = _jax_replay(jsampling, first.last_state, comb_u,
                                      xi)
    got, _, got_state = tsampling.replay_estimators(tstate, comb_u, xi)
    np.testing.assert_allclose(got["itc"].numpy(), want["itc"], rtol=1e-10,
                               atol=1e-10 * ITC_SCALE)
    np.testing.assert_array_equal(got["itc_nw"].numpy(), want["itc_nw"])
    assert (got["itc_nw"] > 0).all()
    np.testing.assert_allclose(got_state.itc_buf.numpy(),
                               np.asarray(want_state.itc_buf), rtol=0,
                               atol=1e-12)


# -- validation ----------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(num_modes=0, num_lags=2), "num_modes"),
    (dict(num_modes=2, num_lags=0), "num_lags"),
    (dict(num_modes=2, num_lags=2, est_every_mult=0), "est_every_mult"),
], ids=["modes", "lags", "mult"])
def test_spec_validation_matches_jax(kwargs, match):
    for module in (jdmc, tdmc):
        with pytest.raises(ValueError, match=match):
            module.ITCEstSpec(**kwargs)


def test_spec_defaults_match_jax():
    want, got = jdmc.ITCEstSpec(3, 5), tdmc.ITCEstSpec(3, 5)
    for name in ("num_modes", "num_lags", "est_every_mult", "as_pure_est",
                 "pfw_num_time_steps"):
        assert getattr(got, name) == getattr(want, name), name


def test_geometry_matches_jax():
    jsampling, tsampling = _samplings(est_every=4,
                                      itc_est_spec=_itc(pure=True, mult=3))
    np.testing.assert_array_equal(tsampling.itc_momenta,
                                  jsampling.itc_momenta)
    np.testing.assert_array_equal(tsampling.itc_lag_times,
                                  jsampling.itc_lag_times)
    assert tsampling._itc_buf_shape == jsampling._itc_buf_shape
    assert tsampling._pure_aux_shapes() == jsampling._pure_aux_shapes()
    for module, sampling in ((jdmc, _samplings()[0]),
                             (tdmc, _samplings()[1])):
        for name in ("itc_momenta", "itc_lag_times"):
            with pytest.raises(TypeError, match="imaginary-time"):
                getattr(sampling, name)


def test_block_length_must_end_on_an_itc_step():
    jsampling, tsampling = _samplings(est_every=2,
                                      itc_est_spec=_itc(mult=3))
    with pytest.raises(ValueError, match="itc est_every_mult"):
        next(tsampling.blocks(_state(tsampling), 8))
    with pytest.raises(ValueError, match="itc est_every_mult"):
        next(jsampling.blocks(jsampling.build_state(_confs(TARGET)), 8))
    # 16 is a multiple of 4 but 24 is not: a 2-block window needs a
    # multiple of the block length.
    for sampling in _samplings(itc_est_spec=_itc(
            pure=True, pfw_num_time_steps=16)):
        assert sampling.pfw_window_blocks(8) == 2
        assert sampling.pfw_window_blocks(6) == 1
