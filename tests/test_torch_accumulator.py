"""The port's block accumulators against the JAX package's.

``_BlockAccumulator`` and ``_VmcBlockAccumulator`` are NumPy copies, so
the same seeded NumPy block data, folded by both and packaged, must give
a ``SamplingData`` equal field by field and bit for bit, with equal
reblocked means and errors.  The snapshot of a half-filled accumulator
must restore into a fresh one (of either package) and end equal to the
uninterrupted one.
"""
import itertools
import warnings

import h5py
import numpy as np
import pytest
import torch

from phd_qmclib_torch.qmc_exec import dmc as tdmc, vmc as tvmc
from phd_qmclib_tpu.qmc_exec import dmc as jdmc, vmc as jvmc

from .test_torch_exec_utils import (MODEL_CONFIG, assert_same,
                                    assert_same_statistics)

torch.set_num_threads(1)

NTS = 8
NUM_BLOCKS = 4
OBD_MULT, G2_MULT, ITC_MULT = 2, 2, 2

# keep_iter_data x (pure, window blocks) x est_every x ITC x CM diffusion.
DMC_CASES = list(itertools.product(
    (False, True), ((False, 1), (True, 1), (True, 2)), (1, 2),
    (None, "mixed", "pure"), (False, True)))


def _dmc_config(keep, pure, window, est_every, itc, cmd):
    pfw = {"pfw_num_time_steps": window * NTS} if pure and window > 1 \
        else {}
    config = dict(
        model_spec=dict(MODEL_CONFIG), time_step=1e-3, max_num_walkers=64,
        target_num_walkers=48, num_blocks=NUM_BLOCKS,
        num_time_steps_block=NTS, burn_in_blocks=1, rng_seed=11,
        dtype="float64", keep_iter_data=keep, est_every=est_every,
        density_spec=dict(num_bins=6, as_pure_est=pure, **pfw),
        ssf_spec=dict(num_modes=4, as_pure_est=pure, **pfw),
        obd_spec=dict(num_pos=3, as_pure_est=pure,
                      est_every_mult=OBD_MULT, **pfw),
        pair_corr_spec=dict(num_bins=5, as_pure_est=pure,
                            est_every_mult=G2_MULT, **pfw))
    if itc is not None:
        config["itc_spec"] = dict(num_modes=3, num_lags=2,
                                  est_every_mult=ITC_MULT)
        if itc == "pure":
            config["itc_spec"].update(as_pure_est=True, **pfw)
    if cmd:
        config["cm_diffusion_spec"] = dict(window_blocks=2)
    return config


def _dmc_block(rng, config):
    """One block's per-step arrays in the shapes ``Proc.exec`` hands to
    ``add``."""
    k = config["est_every"]
    block = dict(
        energy=rng.normal(24.0, 1.0, NTS),
        weight=rng.uniform(40.0, 56.0, NTS),
        num_walkers=rng.integers(40, 56, NTS).astype(np.float64),
        ref_energy=rng.normal(24.0, 0.1, NTS),
        accum_energy=rng.normal(24.0, 0.1, NTS),
        iter_density=rng.uniform(0, 50, (NTS // k, 6)),
        iter_ssf=rng.uniform(0, 50, (NTS // k, 4, 3)),
        iter_obd=rng.uniform(0, 50, (NTS // (k * OBD_MULT), 3)),
        iter_g2=rng.uniform(0, 50, (NTS // (k * G2_MULT), 5)))
    if "itc_spec" in config:
        rows = NTS // (k * ITC_MULT)
        block["iter_itc"] = rng.normal(0, 50, (rows, 3, 3))
        block["iter_itc_nw"] = rng.uniform(0, 50, (rows, 3))
    if "cm_diffusion_spec" in config:
        block["iter_cmd"] = rng.uniform(0, 5, (NTS // k, 2))
    return block


def _dmc_blocks(config, seed):
    rng = np.random.default_rng(seed)
    return [_dmc_block(rng, config) for _ in range(NUM_BLOCKS)]


def _fold(accumulator, blocks, start=0):
    for idx, block in enumerate(blocks[start:], start):
        block = dict(block)
        accumulator.add(idx, *(block.pop(name) for name in (
            "energy", "weight", "num_walkers", "ref_energy",
            "accum_energy")), **block)
    return accumulator


def _procs(config):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jdmc.Proc.from_config(config), tdmc.Proc.from_config(config)


@pytest.mark.parametrize("keep,pure_window,est_every,itc,cmd", DMC_CASES)
def test_dmc_accumulator_matches_jax(keep, pure_window, est_every, itc,
                                     cmd):
    config = _dmc_config(keep, *pure_window, est_every, itc, cmd)
    blocks = _dmc_blocks(config, seed=len(repr(config)))
    jproc, tproc = _procs(config)
    jacc = _fold(jdmc._BlockAccumulator(jproc), blocks)
    tacc = _fold(tdmc._BlockAccumulator(tproc), blocks)
    assert tacc.window == jacc.window == pure_window[1]
    jdata, tdata = jacc.package(), tacc.package()
    assert (tdata.series is None) == (not keep)
    assert_same(jdata, tdata)
    assert_same_statistics(jdata.blocks, tdata.blocks)


SNAPSHOT_CASES = [(False, (True, 2), 1, "pure", True),
                  (True, (False, 1), 2, "mixed", True),
                  (False, (True, 1), 2, None, False)]


@pytest.mark.parametrize("keep,pure_window,est_every,itc,cmd",
                         SNAPSHOT_CASES)
def test_dmc_snapshot_restores_in_both_packages(tmp_path, keep,
                                                pure_window, est_every,
                                                itc, cmd):
    """A snapshot cut inside a two-block window: the in-memory payload
    equals what the JAX accumulator writes and reads back, the file the
    port writes reads back equal, and each restores into a fresh
    accumulator of either package that ends equal to the uninterrupted
    one."""
    config = _dmc_config(keep, *pure_window, est_every, itc, cmd)
    blocks = _dmc_blocks(config, seed=5)
    jproc, tproc = _procs(config)
    whole = _fold(tdmc._BlockAccumulator(tproc), blocks).package()
    cut = 3
    jhalf = _fold(jdmc._BlockAccumulator(jproc), blocks[:cut])
    thalf = _fold(tdmc._BlockAccumulator(tproc), blocks[:cut])
    payload = thalf.snapshot()
    with h5py.File(tmp_path / "snap.h5", "w") as fp:
        jhalf.save_snapshot(fp.require_group("jax"))
        thalf.save_snapshot(fp.require_group("torch"))
        from_jax = jdmc._BlockAccumulator.load_snapshot(fp["jax"])
        from_torch = tdmc._BlockAccumulator.load_snapshot(fp["torch"])
        assert sorted(fp["jax/arrays"]) == sorted(fp["torch/arrays"])
    assert_same(from_jax, payload)
    assert_same(from_torch, payload)
    # The payload is a copy: folding on does not change it.
    _fold(thalf, blocks, start=cut)
    assert_same(from_torch, payload)
    for make, restore_from in ((lambda: tdmc._BlockAccumulator(tproc),
                                from_jax),
                               (lambda: tdmc._BlockAccumulator(tproc),
                                payload),
                               (lambda: jdmc._BlockAccumulator(jproc),
                                payload)):
        fresh = make()
        fresh.restore(restore_from)
        assert_same(_fold(fresh, blocks, start=cut).package(), whole)


def test_dmc_restore_refuses_another_configuration():
    config = _dmc_config(False, True, 1, 1, "pure", True)
    payload = _fold(tdmc._BlockAccumulator(_procs(config)[1]),
                    _dmc_blocks(config, 1)).snapshot()
    other = dict(config)
    del other["itc_spec"]
    jacc = jdmc._BlockAccumulator(_procs(other)[0])
    tacc = tdmc._BlockAccumulator(_procs(other)[1])
    with pytest.raises(ValueError) as jerr:
        jacc.restore(payload)
    with pytest.raises(ValueError) as terr:
        tacc.restore(payload)
    assert str(terr.value) == str(jerr.value)


# -- VMC ---------------------------------------------------------------------

VMC_NS, VMC_BLOCKS, VMC_W = 8, 3, 6
VMC_CASES = list(itertools.product((False, True), (1, 2), (False, True)))


def _vmc_config(keep, est_every, estimators):
    config = dict(model_spec=dict(MODEL_CONFIG), move_spread=0.25,
                  rng_seed=7, num_blocks=VMC_BLOCKS,
                  num_steps_block=VMC_NS, burn_in_blocks=1,
                  num_walkers=VMC_W, dtype="float64",
                  keep_iter_data=keep, est_every=est_every)
    if estimators:
        config.update(ssf_spec=dict(num_modes=4),
                      obd_spec=dict(num_pos=3, est_every_mult=2),
                      pair_corr_spec=dict(num_bins=5, est_every_mult=2))
    return config


def _vmc_blocks(config, seed):
    rng = np.random.default_rng(seed)
    k = config["est_every"]
    blocks = []
    for _ in range(VMC_BLOCKS):
        block = dict(wf_abs_log=rng.normal(-3.0, 1.0, VMC_NS),
                     energy=rng.normal(24.0, 1.0, VMC_NS),
                     move_stat=rng.uniform(0, 1, VMC_NS),
                     accept_rate=float(rng.uniform(0, 1)))
        if "ssf_spec" in config:
            block.update(
                iter_ssf=rng.uniform(0, 50, (VMC_NS // k, 4, 3)),
                iter_obd=rng.uniform(0, 6, (VMC_NS // (2 * k), 3)),
                iter_g2=rng.uniform(0, 6, (VMC_NS // (2 * k), 5)))
        blocks.append(block)
    return blocks


def _vmc_fold(accumulator, blocks, start=0):
    for idx, block in enumerate(blocks[start:], start):
        block = dict(block)
        accumulator.add(idx, *(block.pop(name) for name in (
            "wf_abs_log", "energy", "move_stat", "accept_rate")), **block)
    return accumulator


@pytest.mark.parametrize("keep,est_every,estimators", VMC_CASES)
def test_vmc_accumulator_matches_jax(tmp_path, keep, est_every,
                                     estimators):
    config = _vmc_config(keep, est_every, estimators)
    blocks = _vmc_blocks(config, seed=est_every + 2 * keep)
    jproc = jvmc.Proc.from_config(config)
    tproc = tvmc.Proc.from_config(config)
    jacc = _vmc_fold(jvmc._VmcBlockAccumulator(jproc), blocks)
    tacc = _vmc_fold(tvmc._VmcBlockAccumulator(tproc), blocks)
    assert tacc.mean_accept_rate == jacc.mean_accept_rate
    jdata, tdata = jacc.package(), tacc.package()
    assert_same(jdata, tdata)
    assert_same_statistics(jdata.blocks, tdata.blocks)

    # A snapshot after two blocks, through a file of each package.
    jhalf = _vmc_fold(jvmc._VmcBlockAccumulator(jproc), blocks[:2])
    thalf = _vmc_fold(tvmc._VmcBlockAccumulator(tproc), blocks[:2])
    with h5py.File(tmp_path / "snap.h5", "w") as fp:
        jhalf.save_snapshot(fp.require_group("jax"))
        thalf.save_snapshot(fp.require_group("torch"))
        from_jax = jvmc._VmcBlockAccumulator.load_snapshot(fp["jax"])
        from_torch = tvmc._VmcBlockAccumulator.load_snapshot(fp["torch"])
    assert_same(from_jax, thalf.snapshot())
    assert_same(from_torch, thalf.snapshot())
    fresh = tvmc._VmcBlockAccumulator(tproc)
    fresh.restore(from_jax)
    assert_same(_vmc_fold(fresh, blocks, start=2).package(), tdata)
