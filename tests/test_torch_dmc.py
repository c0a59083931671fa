"""The port's DMC sampler against the JAX package's, in f64 on the CPU.

The slice as a whole: both packages replay the same injected comb
uniforms and diffusion noise from the same initial state (the JAX
``build_state``, converted with ``state_from_numpy``), so every step's
branching table must be equal and every trajectory agree to f64
round-off.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.samplers import dmc as tdmc
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.samplers import dmc as jdmc

torch.set_num_threads(1)

SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.4)
#: A time step large enough that the comb clones and kills walkers.
SAMPLING = dict(time_step=1e-2, max_num_walkers=64, target_num_walkers=48,
                rng_seed=3)


def _confs(num: int, seed: int = 0) -> np.ndarray:
    spec = tmrbp.Spec(**SPEC)
    rng = np.random.default_rng(seed)
    return np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(num)])


@pytest.mark.parametrize("case", range(4))
def test_branching_comb_matches_jax(case):
    rng = np.random.default_rng(case)
    max_w = 96
    num = [96, 70, 40, 1][case]
    # Case 0 overflows the buffer; the others leave dead slots.
    scale = [3.0, 1.5, 1.0, 0.5][case]
    weights = rng.uniform(0.0, scale, max_w)
    weights[num:] = 0.0
    u = rng.random(max_w)
    j_parent, j_num = jdmc.branching_comb(
        jnp.asarray(weights), jnp.asarray(num, dtype=jnp.int32),
        u=jnp.asarray(u))
    t_parent, t_num = tdmc.branching_comb(
        torch.as_tensor(weights), torch.tensor(num), torch.as_tensor(u))
    assert int(t_num) == int(j_num)
    np.testing.assert_array_equal(t_parent.numpy(), np.asarray(j_parent))


def test_build_state_matches_jax():
    jsampling = jdmc.Sampling(jmrbp.Spec(**SPEC), **SAMPLING)
    tsampling = tdmc.Sampling(tmrbp.Spec(**SPEC), **SAMPLING)
    confs = _confs(60)
    want = tdmc.state_from_numpy(jsampling.build_state(confs), device="cpu")
    got = tsampling.build_state(confs, device="cpu")
    assert got.num_walkers.dtype == torch.int64
    assert int(got.num_walkers) == int(want.num_walkers) == 48
    assert got.cmd_accum is None and want.cmd_accum is None
    assert got.itc_buf is None and want.itc_buf is None
    for name in tdmc.State._fields[:-3]:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("ref_compat", [False, True])
def test_replay_matches_jax(ref_compat):
    """20 injected-noise steps at N=16, Wm=64: equal branching tables
    and walker counts; positions, energies, weights and E_ref within
    1e-10 (f64 sums in another order, carried through 20 steps)."""
    nts = 20
    jsampling = jdmc.Sampling(jmrbp.Spec(**SPEC), ref_compat=ref_compat,
                              **SAMPLING)
    tsampling = tdmc.Sampling(tmrbp.Spec(**SPEC), ref_compat=ref_compat,
                              **SAMPLING)
    jstate = jsampling.build_state(_confs(48))
    rng = np.random.default_rng(7)
    comb_u = rng.random((nts, 64))
    xi = jsampling.sigma_spread * rng.standard_normal((nts, 64, 16))

    want = jsampling.replay_states(jstate, comb_u, xi)
    got = tsampling.replay_states(tdmc.state_from_numpy(jstate, device="cpu"),
                                  comb_u, xi)
    np.testing.assert_array_equal(got["parent"].numpy(),
                                  np.asarray(want["parent"]))
    np.testing.assert_array_equal(got["num_walkers"].numpy(),
                                  np.asarray(want["num_walkers"]))
    # The comb really branched: some steps are not the identity table.
    assert (got["parent"] != torch.arange(64)).any()
    assert len(set(got["num_walkers"].tolist())) > 1
    for name in ("pos", "energies", "weights", "ref_energy", "energy",
                 "weight", "accum_energy"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


def test_blocks_run_on_cpu():
    sampling = tdmc.Sampling(tmrbp.Spec(**SPEC), time_step=1e-3,
                             max_num_walkers=64, target_num_walkers=48,
                             rng_seed=5)
    state = sampling.build_state(_confs(48), device="cpu")
    blocks = sampling.blocks(state, num_time_steps_block=8,
                             burn_in_blocks=1)
    ratios = []
    for _ in range(2):
        block = next(blocks)
        props = block.iter_props
        assert all(x.shape == (8,) and x.device.type == "cpu"
                   for x in props)
        assert (props.num_walkers > 0).all()
        ratios.append(float(props.energy.sum() / props.weight.sum()))
    e_per_boson = np.mean(ratios) / SPEC["boson_number"]
    assert np.isfinite(e_per_boson)
    # The ideal band bottom and the variational energy bracket it
    # loosely at this size.
    assert 5.0 < e_per_boson < 12.0
    last = block.last_state
    assert last.pos.shape == (64, 16)
    assert float(last.pos.min()) >= 0.0
    assert float(last.pos.max()) < SPEC["supercell_size"]
    # A continued run draws new noise instead of replaying the stream.
    again = next(sampling.blocks(state, 8, block_offset=0))
    shifted = next(sampling.blocks(state, 8, block_offset=2))
    first = next(sampling.blocks(state, 8))
    assert torch.equal(again.last_state.pos, first.last_state.pos)
    assert not torch.equal(shifted.last_state.pos, first.last_state.pos)


def test_a_run_packs_the_kernel_parameters_once(monkeypatch):
    """The steps take the packed parameter vector from the run's
    constants: one ``pack_params`` per block run and per replay, none
    per step."""
    from phd_qmclib_torch.ops import pairwise
    sampling = tdmc.Sampling(tmrbp.Spec(**SPEC), **SAMPLING)
    state = sampling.build_state(_confs(48), device="cpu")
    packs = []
    pack_params = pairwise.pack_params
    monkeypatch.setattr(pairwise, "pack_params",
                        lambda *a: packs.append(1) or pack_params(*a))
    blocks = sampling.blocks(state, num_time_steps_block=8)
    next(blocks)
    next(blocks)
    assert len(packs) == 1
    rng = np.random.default_rng(2)
    sampling.replay_states(state, rng.random((4, 64)),
                           1e-2 * rng.standard_normal((4, 64, 16)))
    assert len(packs) == 2


def test_state_from_numpy_rejects_sharded_states():
    jsampling = jdmc.Sampling(jmrbp.Spec(**SPEC), **SAMPLING)
    jstate = jsampling.build_state(_confs(48))
    sharded = jstate._replace(num_walkers=np.array([24, 24]))
    with pytest.raises(ValueError, match="one-shard"):
        tdmc.state_from_numpy(sharded, device="cpu")
