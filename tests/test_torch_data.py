"""The port's result containers (``qmc_exec.data.{dmc,vmc}``) against
the JAX package's: NumPy copies on the port's own ``stats.reblock``.

The same block data, packaged by both packages' accumulators, must
export to HDF5 groups equal path by path, dtype by dtype and bit for bit;
each package must read the other's group back into equal containers;
and every derived observable the containers offer must come out equal
bit for bit.
"""

import h5py
import numpy as np
import pytest
import torch

from phd_qmclib_torch.qmc_exec import dmc as tdmc, vmc as tvmc
from phd_qmclib_torch.qmc_exec.data import dmc as tdata, vmc as tvdata
from phd_qmclib_tpu.qmc_exec import dmc as jdmc, vmc as jvmc
from phd_qmclib_tpu.qmc_exec.data import dmc as jdata, vmc as jvdata

from . import test_torch_accumulator as acc
from .test_torch_exec_utils import (assert_same, assert_same_statistics,
                                    assert_same_tree, h5_tree)

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore")

CASES = [(False, (False, 1), 1, "mixed", True),
         (False, (True, 2), 2, "pure", True),
         (True, (False, 1), 2, "mixed", True),
         (True, (True, 1), 1, None, False)]


def _packaged(case):
    config = acc._dmc_config(case[0], *case[1], *case[2:])
    blocks = acc._dmc_blocks(config, seed=9)
    jproc, tproc = acc._procs(config)
    return (acc._fold(jdmc._BlockAccumulator(jproc), blocks).package(),
            acc._fold(tdmc._BlockAccumulator(tproc), blocks).package())


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_dmc_data_files_are_interchangeable(tmp_path, case):
    jpack, tpack = _packaged(case)
    with h5py.File(tmp_path / "data.h5", "w") as fp:
        jpack.hdf5_export(fp.require_group("jax"))
        tpack.hdf5_export(fp.require_group("torch"))
        assert_same_tree(h5_tree(fp["jax"]), h5_tree(fp["torch"]))
        # Each package reads the other's group.
        from_jax = tdata.SamplingData.from_hdf5_data(fp["jax"])
        from_torch = jdata.SamplingData.from_hdf5_data(fp["torch"])
    assert_same(from_jax, tpack)
    assert_same(from_torch, tpack)
    assert_same_statistics(from_jax.blocks, jpack.blocks)


def test_dmc_derived_observables_match_jax():
    jpack, tpack = _packaged(CASES[0])
    jb, tb = jpack.blocks, tpack.blocks
    nop, size = 5, 5.0
    r_grid = np.linspace(0.1, 2.5, 7)
    assert_same(tb.pair_corr.pair_correlation(nop, size),
                jb.pair_corr.pair_correlation(nop, size))
    assert_same(tb.ss_factor.pair_correlation(r_grid, nop, size),
                jb.ss_factor.pair_correlation(r_grid, nop, size))
    assert_same(tb.ss_factor.density_profile(r_grid, nop, size),
                jb.ss_factor.density_profile(r_grid, nop, size))
    assert_same(tb.ss_factor.feynman_spectrum(nop, size),
                jb.ss_factor.feynman_spectrum(nop, size))
    assert_same(tb.ss_factor.sound_speed(nop, size),
                jb.ss_factor.sound_speed(nop, size))
    assert_same(tb.cm_diffusion.effective_mass_ratio(),
                jb.cm_diffusion.effective_mass_ratio())
    assert_same(tb.cm_diffusion.tau_grid, jb.cm_diffusion.tau_grid)
    for name in ("mean", "mean_error", "normalized", "momenta", "tau_grid"):
        assert_same(getattr(tb.itc, name), getattr(jb.itc, name), name)
    assert_same(tb.itc.effective_energy(), jb.itc.effective_energy())
    assert_same(tb.itc.excitation_fit(), jb.itc.excitation_fit())
    # Blocks add up (two runs merged) alike.
    assert_same(tb.merge(tb), jb.merge(jb))
    assert_same(tb.energy.reblock.opt_block_size,
                jb.energy.reblock.opt_block_size)


@pytest.mark.parametrize("keep,est_every", ((False, 1), (True, 2)))
def test_vmc_data_files_are_interchangeable(tmp_path, keep, est_every):
    config = acc._vmc_config(keep, est_every, True)
    blocks = acc._vmc_blocks(config, seed=4)
    jpack = acc._vmc_fold(jvmc._VmcBlockAccumulator(
        jvmc.Proc.from_config(config)), blocks).package()
    tpack = acc._vmc_fold(tvmc._VmcBlockAccumulator(
        tvmc.Proc.from_config(config)), blocks).package()
    with h5py.File(tmp_path / "data.h5", "w") as fp:
        jpack.hdf5_export(fp.require_group("jax"))
        tpack.hdf5_export(fp.require_group("torch"))
        assert_same_tree(h5_tree(fp["jax"]), h5_tree(fp["torch"]))
        from_jax = tvdata.SamplingData.from_hdf5_data(fp["jax"])
        from_torch = jvdata.SamplingData.from_hdf5_data(fp["torch"])
    assert_same(from_jax, tpack)
    assert_same(from_torch, tpack)
    assert_same_statistics(from_jax.blocks, jpack.blocks)
    nop, size = 5, 5.0
    assert_same(tpack.blocks.pair_corr.pair_correlation(nop, size),
                jpack.blocks.pair_corr.pair_correlation(nop, size))
    assert_same(tpack.blocks.ss_factor.feynman_spectrum(nop, size),
                jpack.blocks.ss_factor.feynman_spectrum(nop, size))
    assert_same(tpack.blocks.ss_factor.sound_speed(nop, size),
                jpack.blocks.ss_factor.sound_speed(nop, size))


def test_data_modules_do_not_import_h5py_at_the_top():
    """The containers take open groups; they never open a file."""
    for module in (tdata, tvdata):
        assert not hasattr(module, "h5py")
