"""The port's replay of the upstream library's serial loops, against the
JAX package's original and driving the port's samplers, in f64 on the
CPU.

``phd_qmclib_torch.reference_replay`` is a copy of
``phd_qmclib_tpu.reference_replay``: from the same model, seed and start
its draws and trajectories must be the original's bit for bit.  Its
draws then drive the port's samplers (``vmc.Sampling.replay_chain``,
``dmc.Sampling.replay_states`` with ``ref_compat``) at the tolerances of
``tests/test_reference_replay.py``, which drives the JAX samplers the
same way: every discrete decision (Metropolis accepts, walker counts,
branching tables) identical, VMC positions bit-exact, the rest at f64
round-off.  The sizes are that test's.
"""
import inspect
import re

import numpy as np
import pytest
import torch

from phd_qmclib_torch import reference_replay as treplay
from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.samplers import dmc as tdmc, vmc as tvmc
from phd_qmclib_tpu import reference_replay as jreplay
from phd_qmclib_tpu.models import mrbp as jmrbp

torch.set_num_threads(1)

MODEL = dict(lattice_depth=12.0, lattice_ratio=1.0, interaction_strength=4.0,
             boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.35)
NOP, SC = 16, 16.0
#: The chains of ``tests/test_reference_replay.py``: move spread, seed,
#: start seed, steps, Gaussian proposals.
CHAINS = {
    "uniform": dict(move_spread=0.25, rng_seed=991, start_seed=3,
                    num_steps=1500, gaussian=False),
    "gaussian": dict(move_spread=float(np.sqrt(1e-3)), rng_seed=313,
                     start_seed=6, num_steps=800, gaussian=True),
}
#: Its DMC run.
DMC = dict(time_step=5e-4, max_num_walkers=48, target_num_walkers=32,
           sampling_seed=7, conf_seed=12, rng_seed=1234, num_steps=400)


@pytest.fixture(scope="module")
def spec():
    return tmrbp.Spec(**MODEL)


@pytest.fixture(scope="module")
def jspec():
    return jmrbp.Spec(**MODEL)


def _chain_start(name):
    rng = np.random.default_rng(CHAINS[name]["start_seed"])
    return np.sort(rng.uniform(0, SC, size=NOP))


def _chain_kwargs(name):
    c = CHAINS[name]
    return dict(move_spread=c["move_spread"], rng_seed=c["rng_seed"],
                ini_pos=_chain_start(name), num_steps=c["num_steps"],
                gaussian=c["gaussian"])


@pytest.fixture(scope="module")
def chains(spec):
    return {name: treplay.vmc_replay(spec, **_chain_kwargs(name))
            for name in CHAINS}


@pytest.fixture(scope="module")
def dmc_start(spec):
    """The port's sampling and initial ensemble, as the JAX test builds
    its own, and the replay's arguments from that ensemble."""
    sampling = tdmc.Sampling(
        spec, time_step=DMC["time_step"],
        max_num_walkers=DMC["max_num_walkers"],
        target_num_walkers=DMC["target_num_walkers"],
        rng_seed=DMC["sampling_seed"], ref_compat=True)
    rng = np.random.default_rng(DMC["conf_seed"])
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(DMC["target_num_walkers"])])
    state = sampling.build_state(confs, device="cpu")
    kwargs = dict(
        time_step=DMC["time_step"], rng_seed=DMC["rng_seed"],
        ini_pos=state.pos.numpy(), ini_drift=state.drift.numpy(),
        ini_energies=state.energies.numpy(),
        ini_weights=state.weights.numpy(),
        ini_num_walkers=int(state.num_walkers.sum()),
        ini_ref_energy=float(state.ref_energy),
        max_num_walkers=DMC["max_num_walkers"],
        target_num_walkers=DMC["target_num_walkers"],
        nwc_factor=float(sampling.num_walkers_control_factor),
        num_steps=DMC["num_steps"])
    return sampling, state, kwargs


@pytest.fixture(scope="module")
def dmc_run(spec, dmc_start):
    return treplay.dmc_replay(spec, **dmc_start[2])


def _same_fields(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- the copy against the original ----------------------------------------

def test_public_names_match():
    assert treplay.__all__ == jreplay.__all__
    for name in ("VmcReplayResult", "DmcReplayResult"):
        assert getattr(treplay, name)._fields \
            == getattr(jreplay, name)._fields
    for name in ("vmc_replay", "dmc_replay"):
        got = inspect.signature(getattr(treplay, name))
        want = inspect.signature(getattr(jreplay, name))
        assert got.parameters == want.parameters
        assert got.return_annotation.__name__ \
            == want.return_annotation.__name__


def test_names_no_path_outside_the_repo():
    """No absolute path in the copy (the original names the upstream
    library's checkout by one): every path it gives is relative."""
    absolute = re.compile(r"(^|[\s`(])/\w")
    docs = [inspect.getdoc(obj) or "" for obj in
            (treplay, treplay.MRBPKernels, treplay.vmc_replay,
             treplay.dmc_replay, treplay.VmcReplayResult,
             treplay.DmcReplayResult)]
    assert not any(absolute.search(doc) for doc in docs)
    assert not absolute.search(inspect.getsource(treplay))
    assert absolute.search(inspect.getsource(jreplay))
    assert "the upstream library" in treplay.__doc__


def test_kernel_parameters_are_the_originals(spec, jspec):
    got, want = treplay.MRBPKernels(spec), jreplay.MRBPKernels(jspec)
    assert vars(got) == vars(want)


@pytest.mark.parametrize("seed", range(4))
def test_kernels_bit_equal_to_the_original(spec, jspec, seed):
    got, want = treplay.MRBPKernels(spec), jreplay.MRBPKernels(jspec)
    pos = np.random.default_rng(100 + seed).uniform(0, SC, size=NOP)
    assert got.wf_abs_log(pos) == want.wf_abs_log(pos)
    e_got, d_got = got.energy_and_drift(pos)
    e_want, d_want = want.energy_and_drift(pos)
    assert e_got == e_want
    np.testing.assert_array_equal(d_got, d_want)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_vmc_replay_bit_equal_to_the_original(jspec, chains, name):
    _same_fields(chains[name],
                 jreplay.vmc_replay(jspec, **_chain_kwargs(name)))


def test_dmc_replay_bit_equal_to_the_original(jspec, dmc_start, dmc_run):
    _same_fields(dmc_run, jreplay.dmc_replay(jspec, **dmc_start[2]))


# -- the copy's kernels against the port's model functions ---------------

@pytest.mark.parametrize("seed", range(4))
def test_wf_and_energy(spec, seed):
    """As ``tests/test_reference_replay.py::test_wf_and_energy``: the
    serial kernels and the port's vectorized model functions (their
    plain versions, on the CPU) at f64 round-off."""
    kern = treplay.MRBPKernels(spec)
    funcs = tmrbp.core_funcs(spec)
    pos = np.random.default_rng(8).uniform(0, SC, size=(4, NOP))[seed]
    wf_np = kern.wf_abs_log(pos)
    e_np, d_np = kern.energy_and_drift(pos)
    tpos = torch.as_tensor(pos)
    wf_fw, e_fw = (float(x) for x in
                   funcs.log_psi_and_energy(tpos, spec.cfc_params))
    e2_fw, d_fw = funcs.energy_and_drift(tpos, spec.cfc_params)
    assert wf_fw == pytest.approx(wf_np, rel=1e-12)
    assert e_fw == pytest.approx(e_np, rel=1e-12)
    assert float(e2_fw) == pytest.approx(e_np, rel=1e-12)
    np.testing.assert_allclose(d_fw.numpy(), d_np, rtol=1e-11, atol=1e-11)


# -- the port's samplers driven by the copy's draws -----------------------

@pytest.fixture(scope="module")
def port_chains(spec, chains):
    out = {}
    for name, ref in chains.items():
        c = CHAINS[name]
        sampling = tvmc.Sampling(spec, move_spread=c["move_spread"],
                                 rng_seed=c["rng_seed"], num_walkers=1,
                                 gaussian=c["gaussian"])
        state = sampling.build_state(_chain_start(name), device="cpu")
        pos, wf, accepted = sampling.replay_chain(state, ref.moves_u,
                                                  ref.accept_u)
        out[name] = (pos[:, 0].numpy(), wf[:, 0].numpy(),
                     accepted[:, 0].numpy())
    return out


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_accept_decisions_identical(chains, port_chains, name):
    ref = chains[name]
    np.testing.assert_array_equal(port_chains[name][2], ref.accepted)
    # The chain mixes; sqrt(dt) Gaussian moves accept most proposals.
    low, high = (0.5, 0.999) if CHAINS[name]["gaussian"] else (0.05, 0.95)
    assert low < ref.accepted.mean() < high


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_positions_bit_exact(chains, port_chains, name):
    np.testing.assert_array_equal(port_chains[name][0], chains[name].pos[1:])


def test_wavefunction_at_roundoff(chains, port_chains):
    np.testing.assert_allclose(port_chains["uniform"][1],
                               chains["uniform"].wf_abs_log[1:],
                               rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def port_dmc(dmc_start, dmc_run):
    sampling, state, _ = dmc_start
    out = sampling.replay_states(state, dmc_run.comb_u,
                                 dmc_run.diffusion_noise)
    return {name: value.numpy() for name, value in out.items()}


def _live(ref):
    nts, max_w = ref.cloning_refs.shape
    return np.arange(max_w)[None, :] < ref.num_walkers[:, None]


def test_branching_tables_identical(dmc_run, port_dmc):
    ref, out = dmc_run, port_dmc
    np.testing.assert_array_equal(out["num_walkers"], ref.num_walkers)
    live = _live(ref)
    np.testing.assert_array_equal(np.where(live, out["parent"], 0),
                                  np.where(live, ref.cloning_refs, 0))
    # The population fluctuates (branching is active).
    assert ref.num_walkers.min() != ref.num_walkers.max()


def test_trajectory_at_roundoff(dmc_run, port_dmc):
    ref, out = dmc_run, port_dmc
    live = _live(ref)
    np.testing.assert_allclose(
        np.where(live[:, :, None], out["pos"], 0.0),
        np.where(live[:, :, None], ref.next_pos, 0.0), rtol=0, atol=5e-11)
    np.testing.assert_allclose(
        np.where(live, out["energies"], 0.0),
        np.where(live, ref.next_energies, 0.0), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        np.where(live, out["weights"], 0.0),
        np.where(live, ref.next_weights, 0.0), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["energy", "ref_energy", "accum_energy"])
def test_controller_at_roundoff(dmc_run, port_dmc, name):
    np.testing.assert_allclose(port_dmc[name], getattr(dmc_run, name),
                               rtol=1e-10)
