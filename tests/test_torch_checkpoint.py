"""Checkpoint and resume of the port's procedures on one device.

* A run killed right after a checkpoint and restored from the file ends
  equal, bit for bit, to the uninterrupted run: every container of the
  result and the final state; with the cut inside a multi-block
  forward-walking window, inside a CM-diffusion window and inside the ITC
  fill.  The in-memory payload handed to ``checkpoint_hook`` resumes to
  the same result without a file.
* A light checkpoint drops the ITC ring buffer and its pure accumulators:
  everything but the ITC estimator still resumes bit-exactly.
* A schema-2 checkpoint the JAX package wrote restores in the port, and
  one the port wrote restores in the JAX package: the blocks completed
  before the cut come back bit for bit and the run finishes.
"""

import h5py
import numpy as np
import pytest
import torch

from phd_qmclib_torch.qmc_exec import dmc as tdmc, vmc as tvmc
from phd_qmclib_torch.samplers import dmc as tsampler
from phd_qmclib_tpu.qmc_exec import dmc as jdmc

from .test_torch_exec_utils import MODEL_CONFIG, assert_same, to_numpy

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore")

NTS = 8
DMC_CONFIG = dict(
    model_spec=dict(MODEL_CONFIG), time_step=1e-2, max_num_walkers=64,
    target_num_walkers=48, num_blocks=6, num_time_steps_block=NTS,
    burn_in_blocks=1, rng_seed=7, dtype="float64", est_every=2,
    block_offset=4, checkpoint_every=2,
    density_spec={"num_bins": 6, "pfw_num_time_steps": 3 * NTS},
    ssf_spec={"num_modes": 4, "pfw_num_time_steps": 3 * NTS},
    obd_spec={"num_pos": 3, "as_pure_est": False, "est_every_mult": 2},
    pair_corr_spec={"num_bins": 5, "est_every_mult": 2,
                    "pfw_num_time_steps": 3 * NTS},
    cm_diffusion_spec={"window_blocks": 3},
    itc_spec={"num_modes": 3, "num_lags": 40, "as_pure_est": True,
              "pfw_num_time_steps": 3 * NTS})


class _Killed(RuntimeError):
    """The run dies right after a checkpoint."""


def _kill_at(at_blocks, kept):
    def hook(resume_input):
        if resume_input.resume["blocks_completed"] == at_blocks:
            kept.append(resume_input)
            raise _Killed
    return hook


def _start(proc):
    return tdmc.ProcInput.from_model_sys_conf_spec(
        tdmc.ModelSysConfSpec(), proc, device="cpu")


def _same_results(a, b, skip=()):
    for name in tsampler.State._fields:
        if name in skip:
            continue
        assert_same(getattr(a.state, name), getattr(b.state, name), name)
    if not skip:
        assert_same(a.data, b.data)


@pytest.mark.parametrize("keep", (False, True))
@pytest.mark.parametrize("cut", (2, 4))
def test_dmc_kill_and_restore_is_bit_exact(tmp_path, cut, keep):
    """Windows are blocks [0-2] and [3-5]: the cut after block 2 is inside
    the first, after block 4 inside the second; the ITC buffer (40 lags,
    4 measured steps a block) is still filling at both."""
    config = dict(DMC_CONFIG, keep_iter_data=keep)
    if keep:
        # The per-step ITC series exists for the mixed estimator only.
        config["itc_spec"] = {"num_modes": 3, "num_lags": 40}
    whole_proc = tdmc.Proc.from_config(config)
    assert whole_proc.sampling.pfw_window_blocks(NTS) == 3
    start = _start(whole_proc)
    whole = whole_proc.exec(start)

    ckpt = str(tmp_path / "ckpt.h5")
    proc = whole_proc.evolve({"checkpoint_file": ckpt})
    kept = []
    with pytest.raises(_Killed):
        proc.exec(start, checkpoint_hook=_kill_at(cut, kept))

    proc2, resume_input = tdmc.Proc.restore_checkpoint(ckpt, device="cpu")
    # The ORIGINAL configuration (the stored config has no checkpoint
    # fields, in either package).
    assert proc2.as_config() == whole_proc.as_config()
    resume = resume_input.resume
    assert resume["blocks_completed"] == cut
    assert (resume["it_offset"], resume["it_burn"], resume["it_next"]) \
        == (4, 1, 1 + cut)
    assert sorted(resume["aux"]) == sorted(kept[0].resume["aux"])
    assert resume_input.state.itc_filled == 4 * cut
    resumed = proc2.evolve({"checkpoint_file": None}).exec(resume_input)
    _same_results(resumed, whole)
    # The payload in memory is the file's: it resumes to the same end.
    in_memory = kept[0]
    assert_same(in_memory.resume["accum"], resume["accum"])
    assert_same({k: to_numpy(v) for k, v in in_memory.resume["aux"].items()},
                resume["aux"])
    _same_results(whole_proc.exec(in_memory), whole)


def test_dmc_light_checkpoint_restarts_only_the_itc_fill(tmp_path):
    whole_proc = tdmc.Proc.from_config(DMC_CONFIG)
    start = _start(whole_proc)
    whole = whole_proc.exec(start)
    ckpt = str(tmp_path / "light.h5")
    proc = whole_proc.evolve({"checkpoint_file": ckpt,
                              "checkpoint_light": True})
    with pytest.raises(_Killed):
        proc.exec(start, checkpoint_hook=_kill_at(4, []))
    with h5py.File(ckpt, "r") as fp:
        assert "itc_buf" not in fp["checkpoint/dmc/state"]
        assert sorted(fp["checkpoint/dmc/resume/aux"]) \
            == ["aux_density", "aux_g2", "aux_ssf"]
    proc2, resume_input = tdmc.Proc.restore_checkpoint(ckpt, device="cpu")
    assert resume_input.state.itc_buf is None
    resumed = proc2.evolve({"checkpoint_file": None}).exec(resume_input)
    _same_results(resumed, whole, skip=("itc_buf", "itc_filled"))
    for name in ("energy", "weight", "num_walkers", "density", "ss_factor",
                 "one_body_dm", "cm_diffusion", "pair_corr"):
        assert_same(getattr(resumed.data.blocks, name),
                    getattr(whole.data.blocks, name), name)
    # The fill restarted after block 4: two blocks of 4 measured steps.
    assert int(resumed.state.itc_filled) == 8
    assert int(whole.state.itc_filled) == 24
    itc, itc_whole = resumed.data.blocks.itc, whole.data.blocks.itc
    # The first window came whole from the checkpoint; the second lost
    # what the buffer held before the cut: sums and counts together.
    assert_same(itc.lag_sums[0], itc_whole.lag_sums[0])
    assert (itc.lag_counts[1] < itc_whole.lag_counts[1]).any()
    assert np.isfinite(itc.lag_sums).all()


def test_dmc_checkpoints_cross_the_packages(tmp_path, monkeypatch):
    config = dict(DMC_CONFIG, time_step=1e-3)
    # 1) JAX writes, the port restores.
    jckpt = str(tmp_path / "jax.h5")
    jproc = jdmc.Proc.from_config(dict(config, checkpoint_file=jckpt))
    jstart = jdmc.ProcInput.from_model_sys_conf_spec(
        jdmc.ModelSysConfSpec(), jproc)
    jwhole = jproc.evolve({"checkpoint_file": None}).exec(jstart)
    original = jdmc.Proc._write_checkpoint

    def dying(self, state, blocks_completed, *args, **kwargs):
        original(self, state, blocks_completed, *args, **kwargs)
        if blocks_completed == 4:
            raise _Killed

    with monkeypatch.context() as mp:
        mp.setattr(jdmc.Proc, "_write_checkpoint", dying)
        with pytest.raises(_Killed):
            jproc.exec(jstart)
    proc, resume_input = tdmc.Proc.restore_checkpoint(jckpt, device="cpu")
    assert proc.as_config() == jproc.as_config()
    assert resume_input.resume["blocks_completed"] == 4
    assert sorted(resume_input.resume["aux"]) == [
        "aux_density", "aux_g2", "aux_itc", "aux_itc_cnt", "aux_ssf"]
    assert resume_input.state.itc_buf.shape == (64, 40, 3, 2)
    resumed = proc.evolve({"checkpoint_file": None}).exec(resume_input)
    blocks, jblocks = resumed.data.blocks, jwhole.data.blocks
    # Before the cut: JAX's blocks, bit for bit (window 0, blocks 0-3).
    np.testing.assert_array_equal(blocks.energy.totals[:4],
                                  jblocks.energy.totals[:4])
    np.testing.assert_array_equal(blocks.density.totals[0],
                                  jblocks.density.totals[0])
    np.testing.assert_array_equal(blocks.one_body_dm.totals[:4],
                                  jblocks.one_body_dm.totals[:4])
    # After it: the port's own streams, the same physics.
    assert blocks.energy.totals.shape == jblocks.energy.totals.shape
    assert blocks.density.totals.shape == jblocks.density.totals.shape == \
        (2, 6)
    assert blocks.energy.mean == pytest.approx(jblocks.energy.mean, rel=0.02)
    # Σ density = N at the end of the carried window too.
    assert blocks.density.mean.sum() == pytest.approx(5.0, rel=1e-12)

    # 2) The port writes, JAX restores.
    tckpt = str(tmp_path / "torch.h5")
    tproc = tdmc.Proc.from_config(dict(config, checkpoint_file=tckpt))
    start = _start(tproc)
    whole = tproc.evolve({"checkpoint_file": None}).exec(start)
    with pytest.raises(_Killed):
        tproc.exec(start, checkpoint_hook=_kill_at(4, []))
    jproc2, jinput = jdmc.Proc.restore_checkpoint(tckpt)
    assert jproc2.as_config() == tproc.as_config()
    jresumed = jproc2.evolve({"checkpoint_file": None}).exec(jinput)
    np.testing.assert_array_equal(jresumed.data.blocks.energy.totals[:4],
                                  whole.data.blocks.energy.totals[:4])
    assert jresumed.data.blocks.energy.mean == pytest.approx(
        whole.data.blocks.energy.mean, rel=0.02)


def test_legacy_checkpoint_without_a_resume_group(tmp_path):
    proc = tdmc.Proc.from_config(dict(DMC_CONFIG, num_blocks=3,
                                      checkpoint_file=str(tmp_path / "c.h5")))
    proc.exec(_start(proc))
    with h5py.File(tmp_path / "c.h5", "a") as fp:
        del fp["checkpoint/dmc/resume"]
    proc2, resume_input = tdmc.Proc.restore_checkpoint(
        str(tmp_path / "c.h5"), device="cpu")
    assert resume_input.resume is None
    out = proc2.evolve({"checkpoint_file": None}).exec(resume_input)
    assert np.isfinite(out.data.blocks.energy.mean)


# -- the sampler's resume arguments ---------------------------------------------

def test_blocks_resume_arguments():
    """``start_block_idx`` past the burn-in keeps the ITC fill and the CM
    window; before it, the fill restarts as at block 0."""
    proc = tdmc.Proc.from_config(DMC_CONFIG)
    sampling, state = proc.sampling, _start(proc).state
    whole = sampling.blocks(state, NTS, burn_in_blocks=1, block_offset=4)
    blocks = [next(whole) for _ in range(4)]
    cut = blocks[2]
    assert sorted(cut.aux_carry) == ["aux_density", "aux_g2", "aux_itc",
                                     "aux_itc_cnt", "aux_ssf"]
    assert blocks[0].aux_carry is None  # the burn-in block
    resumed = next(sampling.blocks(cut.last_state, NTS, burn_in_blocks=1,
                                   block_offset=4, start_block_idx=3,
                                   aux_init=cut.aux_carry))
    assert_same(resumed, blocks[3])
    # Without the carry the window's accumulators restart from zero.
    bare = next(sampling.blocks(cut.last_state, NTS, burn_in_blocks=1,
                                block_offset=4, start_block_idx=3))
    assert_same(bare.iter_props, blocks[3].iter_props)
    assert not torch.equal(bare.iter_density, blocks[3].iter_density)
    # A start inside the burn-in restarts the fill.
    again = next(sampling.blocks(cut.last_state, NTS, burn_in_blocks=4,
                                 block_offset=4, start_block_idx=3))
    assert int(again.last_state.itc_filled) == 0


def test_state_data_blocks_and_states():
    proc = tdmc.Proc.from_config({k: v for k, v in DMC_CONFIG.items()
                                  if k not in ("itc_spec",
                                               "cm_diffusion_spec")})
    sampling, state = proc.sampling, _start(proc).state
    ens, block = next(sampling.state_data_blocks(state, NTS, thin=2,
                                                 block_offset=4))
    plain = next(sampling.blocks(state, NTS, burn_in_blocks=1,
                                 block_offset=4))
    assert ens["pos"].shape == (NTS // 2, 64, 5)
    assert ens["energies"].shape == ens["weights"].shape == (NTS // 2, 64)
    assert block.iter_density is None
    assert_same(block.iter_props, plain.iter_props)
    assert torch.equal(ens["pos"][-1], plain.last_state.pos)
    with pytest.raises(ValueError, match="divisible by thin"):
        next(sampling.state_data_blocks(state, NTS, thin=3))
    # One step a block: for a sampling whose estimators measure every
    # step.
    plain_proc = tdmc.Proc.from_config(
        {k: v for k, v in DMC_CONFIG.items()
         if not k.endswith("_spec") or k == "model_spec"} | {"est_every": 1})
    first = next(plain_proc.sampling.states(state))
    assert first.pos.shape == state.pos.shape
    assert state.confs.shape == (64, 2, 5) and state.max_num_walkers == 64
    assert torch.equal(state.confs[:, 1], state.drift)


# -- VMC -------------------------------------------------------------------------

VMC_CONFIG = dict(
    model_spec=dict(MODEL_CONFIG), move_spread=0.25, num_blocks=5,
    num_steps_block=8, burn_in_blocks=1, num_walkers=8, rng_seed=77,
    dtype="float64", block_offset=2, checkpoint_every=2,
    ssf_spec={"num_modes": 4}, obd_spec={"num_pos": 3})


@pytest.mark.parametrize("keep", (False, True))
def test_vmc_kill_and_restore_is_bit_exact(tmp_path, keep):
    whole_proc = tvmc.Proc.from_config(dict(VMC_CONFIG,
                                            keep_iter_data=keep))
    start = tvmc.ProcInput.from_model_sys_conf_spec(
        tvmc.ModelSysConfSpec(), whole_proc, device="cpu")
    whole = whole_proc.exec(start)
    ckpt = str(tmp_path / "vmc.h5")
    proc = whole_proc.evolve({"checkpoint_file": ckpt})
    kept = []
    with pytest.raises(_Killed):
        proc.exec(start, checkpoint_hook=_kill_at(2, kept))
    proc2, resume_input = tvmc.Proc.restore_checkpoint(ckpt, device="cpu")
    assert proc2.as_config() == whole_proc.as_config()
    assert resume_input.resume["blocks_completed"] == 2
    assert resume_input.resume["it_next"] == 3
    for candidate in (resume_input, kept[0]):
        resumed = whole_proc.exec(candidate)
        assert_same(resumed.data, whole.data)
        for name in ("pos", "wf_abs_log", "energy", "move_stat"):
            assert_same(getattr(resumed.state, name),
                        getattr(whole.state, name), name)
