"""The port's walker mesh against the JAX package's, in f64 on the CPU.

The shard layout of ``build_state``, ``rebalance`` and
``adapt_state_shards`` are pure functions of the global view: they run
in this process (a sampling told its shard count by a stand-in mesh) and
must equal the JAX package's bit for bit.  The sharded step runs on
gloo ranks (``parallel.launch``, the rank functions in
``tests/test_torch_mesh_workers.py``) against a ``jax.shard_map`` of the
JAX package's own step (``make_step_fn(axis_name=..., injected_noise=
True)``) on the virtual CPU devices of ``tests/conftest.py``: the same
global draws, each shard its slice, within 1e-12 over 16 steps.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.parallel import mesh as tmesh
from phd_qmclib_torch.samplers import dmc as tdmc
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.parallel import make_walker_mesh as jax_mesh
from phd_qmclib_tpu.samplers import dmc as jdmc

from . import test_torch_mesh_workers as workers

torch.set_num_threads(1)

NOP = 8
SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=NOP, supercell_size=8.0, tbf_contact_cutoff=0.4)
#: A time step large enough that the comb clones and kills walkers.
SAMPLING = dict(time_step=1e-2, max_num_walkers=64, target_num_walkers=48,
                rng_seed=3)
#: Each rank function's launches stay well inside a test's time.
TIMEOUT = 60.0


def _confs(num: int, seed: int = 0) -> np.ndarray:
    spec = tmrbp.Spec(**SPEC)
    rng = np.random.default_rng(seed)
    return np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(num)])


def _cpu_mesh(size: int) -> tmesh.MeshSpec:
    return tmesh.make_walker_mesh(size, "cpu", timeout=TIMEOUT)


def _stand_in(size: int):
    """What a pure function of the global view reads of a mesh."""
    return types.SimpleNamespace(size=size, rank=0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_states_equal(got, want):
    for name in jdmc.State._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)


# -- pure functions of the global view ----------------------------------------

@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("num", [48, 37])
def test_build_state_layout_matches_jax(num_shards, num):
    jsampling = jdmc.Sampling(jmrbp.Spec(**SPEC), **SAMPLING,
                              mesh=jax_mesh(num_shards))
    tsampling = tdmc.Sampling(tmrbp.Spec(**SPEC), **SAMPLING)
    confs = _confs(num)
    want = jsampling.build_state(confs)
    got = tsampling.build_state(confs, device="cpu", num_shards=num_shards)
    assert got.num_walkers.tolist() == np.asarray(want.num_walkers).tolist()
    for name in ("pos", "masks", "weights"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.energies.numpy(),
                               np.asarray(want.energies), rtol=1e-12,
                               atol=1e-12 * NOP)
    # The sampling of the mesh lays out the same by itself.
    on_mesh = dataclasses.replace(tsampling, mesh=_stand_in(num_shards))
    assert on_mesh.build_state(confs, device="cpu").num_walkers.tolist() \
        == got.num_walkers.tolist()


def _imbalanced(jsampling, counts, seed=0):
    """A JAX global state with the given per-shard counts (an empty
    shard allowed) and random CM and ITC buffers."""
    rng = np.random.default_rng(seed)
    state = jsampling.build_state(_confs(48, seed))
    max_w = jsampling.max_num_walkers
    size = max_w // len(counts)
    valid = np.zeros(max_w, dtype=bool)
    for s, c in enumerate(counts):
        valid[s * size:s * size + c] = True
    pos = rng.uniform(0, 8.0, (max_w, NOP))
    fill = lambda *shape: np.where(  # noqa: E731
        valid.reshape((-1,) + (1,) * (len(shape) - 1)),
        rng.standard_normal(shape), 0.0)
    return state._replace(
        pos=jnp.asarray(pos), drift=jnp.asarray(fill(max_w, NOP)),
        energies=jnp.asarray(fill(max_w)),
        weights=jnp.asarray(np.where(valid, rng.uniform(0.5, 1.5, max_w),
                                     0.0)),
        masks=jnp.asarray(~valid),
        num_walkers=jnp.asarray(np.asarray(counts, dtype=np.int32)),
        cmd_accum=jnp.asarray(fill(max_w)),
        itc_buf=jnp.asarray(fill(max_w, 3, 2, 2)),
        itc_filled=jnp.int32(2))


ITC = dict(num_modes=2, num_lags=3)


@pytest.mark.parametrize("counts", [(5, 0, 16, 9), (16, 16, 16, 16),
                                    (0, 0, 1, 0), (3, 11)],
                         ids=["uneven", "full", "one", "two-shards"])
def test_rebalance_matches_jax(counts):
    num_shards = len(counts)
    kw = dict(SAMPLING, cm_diffusion_est=True)
    jsampling = jdmc.Sampling(jmrbp.Spec(**SPEC), **kw,
                              itc_est_spec=jdmc.ITCEstSpec(**ITC),
                              mesh=jax_mesh(num_shards))
    tsampling = tdmc.Sampling(tmrbp.Spec(**SPEC), **kw,
                              itc_est_spec=tdmc.ITCEstSpec(**ITC),
                              mesh=_stand_in(num_shards))
    jstate = _imbalanced(jsampling, counts)
    want = jsampling.rebalance(jstate)
    got = tsampling.rebalance(tdmc.state_from_numpy(jstate, device="cpu"))
    _assert_states_equal(got, want)
    assert got.num_walkers.tolist() == np.asarray(want.num_walkers).tolist()
    # Rebalanced again, a balanced state keeps its walkers' multiset.
    again = tsampling.rebalance(got)
    assert sorted(map(tuple, again.pos[~again.masks].tolist())) \
        == sorted(map(tuple, got.pos[~got.masks].tolist()))


@pytest.mark.parametrize("src,dst", [(4, 2), (2, 4), (4, 1), (1, 4)])
def test_adapt_state_shards_matches_jax(src, dst):
    kw = dict(SAMPLING, cm_diffusion_est=True)
    counts = {1: (37,), 2: (20, 0), 4: (5, 0, 16, 9)}[src]
    jsrc = jdmc.Sampling(jmrbp.Spec(**SPEC), **kw,
                         itc_est_spec=jdmc.ITCEstSpec(**ITC),
                         mesh=jax_mesh(src) if src > 1 else None)
    jdst = dataclasses.replace(jsrc, mesh=jax_mesh(dst) if dst > 1 else None)
    tdst = tdmc.Sampling(tmrbp.Spec(**SPEC), **kw,
                         itc_est_spec=tdmc.ITCEstSpec(**ITC),
                         mesh=_stand_in(dst) if dst > 1 else None)
    jstate = _imbalanced(jsrc, counts)
    want = jdst.adapt_state_shards(jstate)
    got = tdst.adapt_state_shards(tdmc.state_from_numpy(jstate,
                                                        device="cpu"))
    _assert_states_equal(got, want)
    assert np.atleast_1d(got.num_walkers.numpy()).tolist() \
        == np.asarray(want.num_walkers).tolist()


# -- the mesh's collectives ---------------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 4])
def test_psum_is_the_rank_order_sum_on_every_rank(size):
    rng = np.random.default_rng(size)
    # Magnitudes far apart: a sum in another order differs in its bits.
    values = [rng.standard_normal(7) * 10.0 ** rng.integers(-8, 8, 7)
              for _ in range(size)]
    totals, gathered = tmesh.launch(workers.psum_ranks, _cpu_mesh(size),
                                    values)
    want = values[0].copy()
    for value in values[1:]:
        want = want + value
    for got in gathered:
        assert any(np.array_equal(got, v) for v in values)
    for total in totals:
        np.testing.assert_array_equal(total, want)


@pytest.mark.parametrize("how", ["raise", "die"])
def test_a_failed_rank_makes_launch_raise(how):
    spec = tmesh.make_walker_mesh(2, "cpu", timeout=20.0)
    with pytest.raises(Exception) as info:
        tmesh.launch(workers.fail_rank, spec, how)
    text = str(info.value)
    if how == "raise":
        assert "rank 1 fails on purpose" in text
    assert not torch.distributed.is_initialized()


def test_make_walker_mesh_names_what_it_cannot_give():
    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without CUDA")
    with pytest.raises(ValueError, match="requested 2 devices, 0 available"):
        tmesh.make_walker_mesh(2)
    with pytest.raises(ValueError, match="backend named"):
        tmesh.make_walker_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="nccl takes one rank per GPU"):
        tmesh.make_walker_mesh(devices=["cuda:0", "cuda:0"], backend="nccl")
    spec = tmesh.make_walker_mesh(devices=["cpu"] * 4, backend="gloo",
                                  rows=2)
    assert (spec.size, spec.rows, spec.walkers, spec.backend) \
        == (4, 2, 2, "gloo")
    assert tmesh.make_walker_mesh(3, "cpu").devices == ("cpu",) * 3
    with pytest.raises(ValueError, match="divisible by the mesh 'walkers' "
                                         r"axis size \(3\)"):
        tdmc.Sampling(tmrbp.Spec(**SPEC), **SAMPLING, mesh=_stand_in(3))


# -- the sharded step against JAX's shard_map ---------------------------------

ESTIMATORS = {
    "mixed": dict(density_est_spec=dict(num_bins=8, as_pure_est=False),
                  ssf_est_spec=dict(num_modes=4, as_pure_est=False),
                  pair_corr_est_spec=dict(num_bins=6, as_pure_est=False),
                  obd_est_spec=dict(num_pos=3, as_pure_est=False),
                  cm_diffusion_est=True),
    "pure": dict(density_est_spec=dict(num_bins=8),
                 ssf_est_spec=dict(num_modes=4),
                 pair_corr_est_spec=dict(num_bins=6)),
}
_SPEC_TYPES = {"density_est_spec": "DensityEstSpec",
               "ssf_est_spec": "SSFEstSpec", "obd_est_spec": "OBDEstSpec",
               "pair_corr_est_spec": "PairCorrEstSpec"}


def _build(module, model, **kwargs):
    kw = {name: (getattr(module, _SPEC_TYPES[name])(**value)
                 if name in _SPEC_TYPES else value)
          for name, value in kwargs.items()}
    return module.Sampling(model.Spec(**SPEC), **SAMPLING, **kw)


def _jax_sharded_replay(sampling, state, comb_u, xi):
    """The JAX package's step under ``shard_map`` over its walker mesh on
    the injected global draws: per-step scalars and ensemble, and the
    estimators' shard sums (the block's psum: summed here in rank
    order) except the CM sums, which the step psums itself."""
    ax = sampling.mesh_axis
    P = jax.sharding.PartitionSpec
    step = sampling.make_step_fn(axis_name=ax, measure=True,
                                 injected_noise=True)
    cfc = sampling._cast_params(jnp.float64)
    scalars = sampling._scalars(jnp.float64)
    state_spec = jdmc.State(
        pos=P(ax), drift=P(ax), energies=P(ax), weights=P(ax), masks=P(ax),
        energy=P(), weight=P(), num_walkers=P(ax), ref_energy=P(),
        accum_energy=P(), total_energy=P(), total_weight=P(),
        cmd_accum=P(ax) if sampling.cm_diffusion_est else None)
    aux = {name: jnp.zeros(shape) for name, shape
           in sampling._pure_aux_shapes().items()}
    aux_spec = {name: P(ax) for name in aux}

    def one(st, ex, cu, x, idx):
        new, new_ex, props, est = step(st, ex, {"comb_u": cu, "xi": x}, idx,
                                       scalars, cfc)
        cmd = est.pop("cmd", None)
        return new, new_ex, props, {k: v[None] for k, v in est.items()}, cmd

    est_names = [n for n in ("density", "ssf", "obd", "g2")
                 if getattr(sampling, {"density": "density_est_spec",
                                       "ssf": "ssf_est_spec",
                                       "obd": "obd_est_spec",
                                       "g2": "pair_corr_est_spec"}[n])]
    cmd_spec = P() if sampling.cm_diffusion_est else None
    fn = jax.jit(jax.shard_map(
        one, mesh=sampling.mesh,
        in_specs=(state_spec, aux_spec, P(ax), P(ax), P()),
        out_specs=(state_spec, aux_spec, (P(),) * 5,
                   {name: P(ax) for name in est_names}, cmd_spec)))
    scal, pos, weights, est = [], [], [], {}
    for k in range(comb_u.shape[0]):
        state, aux, props, rows, cmd = fn(state, aux, jnp.asarray(comb_u[k]),
                                          jnp.asarray(xi[k]), jnp.int32(k))
        scal.append([np.asarray(p) for p in props])
        pos.append(np.asarray(state.pos))
        weights.append(np.asarray(state.weights))
        for name, value in rows.items():
            parts = np.asarray(value)
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            est.setdefault(name, []).append(total)
        if cmd is not None:
            est.setdefault("cmd", []).append(np.asarray(cmd))
    names = ("energy", "weight", "num_walkers", "ref_energy", "accum_energy")
    scal = {name: np.stack(col) for name, col in zip(names, zip(*scal))}
    return scal, np.stack(pos), np.stack(weights), \
        {name: np.stack(v) for name, v in est.items()}


@pytest.mark.parametrize("num_shards,case", [(2, "mixed"), (4, "pure")])
def test_sharded_step_matches_jax_shard_map(num_shards, case):
    nts = 16
    jsampling = dataclasses.replace(
        _build(jdmc, jmrbp, **ESTIMATORS[case]), mesh=jax_mesh(num_shards))
    tsampling = _build(tdmc, tmrbp, **ESTIMATORS[case])
    jstate = jsampling.build_state(_confs(44))
    rng = np.random.default_rng(num_shards)
    comb_u = rng.random((nts, 64))
    xi = jsampling.sigma_spread * rng.standard_normal((nts, 64, NOP))
    want_scal, want_pos, want_w, want_est = _jax_sharded_replay(
        jsampling, jstate, comb_u, xi)
    start = workers.state_arrays(tdmc.state_from_numpy(jstate, device="cpu"))
    scal, pos, weights, est, last = tmesh.launch(
        workers.dmc_replay, _cpu_mesh(num_shards), tsampling, start, comb_u,
        xi)
    np.testing.assert_array_equal(scal["num_walkers"],
                                  want_scal["num_walkers"])
    assert len(set(scal["num_walkers"].tolist())) > 1, "the comb branched"
    for name in ("energy", "weight", "ref_energy", "accum_energy"):
        np.testing.assert_allclose(scal[name], want_scal[name], rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(pos, want_pos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(weights, want_w, rtol=1e-12, atol=1e-12)
    assert set(est) == set(want_est)
    for name, rows in est.items():
        scale = np.abs(want_est[name]).max()
        np.testing.assert_allclose(rows, want_est[name], rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=name)
    assert last.num_walkers.shape == (num_shards,)
    assert int(last.num_walkers.sum()) == int(scal["num_walkers"][-1])


def test_sharded_blocks_rebalance_and_sum_rules():
    """Blocks on 4 ranks with ``rebalance_every: 1``: the density sums to
    N nw at every measured step, the CM sums of the block's last step
    are its last state's, and every block starts balanced (the cadence
    rebalance keeps each walker, as its position).

    The JAX package's sharded blocks give 4 times the CM sums: its step
    psums them and its block psums them again (checked here too)."""
    kw = dict(density_est_spec=dict(num_bins=8, as_pure_est=False),
              cm_diffusion_est=True)
    tsampling = dataclasses.replace(_build(tdmc, tmrbp, **kw),
                                    rebalance_every=1)
    state = tsampling.build_state(_confs(48), device="cpu", num_shards=4)
    out = tmesh.launch(workers.dmc_blocks, _cpu_mesh(4), tsampling,
                       workers.state_arrays(state), 8, 3)
    for props, rows, last in out:
        np.testing.assert_array_equal(rows["density"].sum(axis=-1),
                                      NOP * props["num_walkers"])
        assert last.num_walkers.shape == (4,)
        assert int(last.num_walkers.sum()) == int(props["num_walkers"][-1])
        cmd = last.cmd_accum[~last.masks]
        np.testing.assert_allclose(rows["cmd"][-1], [(cmd ** 2).sum(),
                                                     cmd.sum()],
                                   rtol=1e-12, atol=1e-12)
    jsampling = dataclasses.replace(_build(jdmc, jmrbp, **kw),
                                    mesh=jax_mesh(4))
    jblock = next(jsampling.blocks(jsampling.build_state(_confs(48)), 8))
    jcmd = np.asarray(jblock.last_state.cmd_accum)[
        ~np.asarray(jblock.last_state.masks)]
    np.testing.assert_allclose(np.asarray(jblock.iter_cmd)[-1],
                               [4 * (jcmd ** 2).sum(), 4 * jcmd.sum()],
                               rtol=1e-12)
    # Rebalanced at the start of blocks 1 and 2: the shards' counts of
    # the previous block's end, dealt evenly.
    local = dataclasses.replace(tsampling, mesh=_stand_in(4))
    for (_, _, before), (_, _, after) in zip(out, out[1:]):
        dealt = local.rebalance(tdmc.state_from_numpy(before, device="cpu"))
        counts = dealt.num_walkers.tolist()
        assert max(counts) - min(counts) <= 1
        want = sorted(map(tuple, dealt.pos[~dealt.masks].tolist()))
        assert want == sorted(map(tuple, before.pos[~before.masks]
                                  .tolist()))


# -- VMC chains sharded -------------------------------------------------------

def test_sharded_vmc_chains_match_jax_replay_chain():
    """VMC chains never couple: under injected moves and uniforms each
    shard's chains are JAX's ``replay_chain`` on that shard's slice (an
    unsharded JAX sampling of its chains).  A block's S(k), OBDM and g2
    rows are the rank-order sums of the shards' own sums (at the block's
    last, measured step: the sums of each shard's final chains), and its
    acceptance the mean of the shards'."""
    from phd_qmclib_torch.samplers import vmc as tvmc
    from phd_qmclib_tpu.samplers import vmc as jvmc

    num_shards, chains, nts = 2, 16, 12
    est = dict(ssf_est_spec=dict(num_modes=3),
               obd_est_spec=dict(num_pos=3),
               pair_corr_est_spec=dict(num_bins=4))

    def build(module, model, num, with_est=True):
        kw = {name: getattr(module, _SPEC_TYPES[name])(**value)
              for name, value in est.items() if with_est}
        return module.Sampling(model.Spec(**SPEC), move_spread=0.4,
                               rng_seed=5, num_walkers=num, **kw)

    tsampling = build(tvmc, tmrbp, chains)
    confs = _confs(chains, 3)
    rng = np.random.default_rng(11)
    moves = rng.random((nts, chains, NOP))
    accept = rng.random((nts, chains))
    (pos, lp, acc), rows, rate, props, last_pos = tmesh.launch(
        workers.vmc_replay, _cpu_mesh(num_shards), tsampling, confs, moves,
        accept)
    num = chains // num_shards
    # The chains' dynamics do not depend on the estimators, which the JAX
    # package's replay does not carry.
    jsampling = build(jvmc, jmrbp, num, with_est=False)
    for s in range(num_shards):
        part = slice(s * num, (s + 1) * num)
        j_pos, j_lp, j_acc = jsampling.replay_chain(
            jsampling.build_state(confs[part]), moves[:, part],
            accept[:, part])
        np.testing.assert_array_equal(acc[:, part], np.asarray(j_acc))
        np.testing.assert_allclose(pos[:, part], np.asarray(j_pos),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(lp[:, part], np.asarray(j_lp),
                                   rtol=1e-12, atol=1e-12)
    assert 0 < acc.sum() < acc.size
    # The block: psummed rows are the rank-order sums of the shards'.
    assert props["energy"].shape == (4, chains)
    funcs = tsampling.core_funcs
    cfc = tmrbp.cast_params(tsampling.cfc_params, torch.float64, "cpu")
    final = torch.as_tensor(last_pos)
    parts = {
        "ssf": lambda p: funcs.fourier_density_parts_harmonics(3, p, cfc),
        "obd": lambda p: funcs.one_body_density_grid(
            torch.as_tensor(tsampling.obd_pos_offsets), p, cfc),
        "g2": lambda p: funcs.pair_dist_histogram(4, p, cfc)}
    for name, fn in parts.items():
        shard_sums = [fn(final[s * num:(s + 1) * num]).sum(dim=0)
                      for s in range(num_shards)]
        want = shard_sums[0]
        for value in shard_sums[1:]:
            want = want + value
        np.testing.assert_allclose(rows[name][-1], want.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    shard_rates = [props["move_stat"][:, s * num:(s + 1) * num].mean()
                   for s in range(num_shards)]
    assert rate == pytest.approx(np.mean(shard_rates), rel=1e-12)
