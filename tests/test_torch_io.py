"""The port's HDF5 handlers (``qmc_exec.io``) against the JAX package's:
files both ways.

* A result the port dumps has the layout the JAX handler writes for the
  same result (path by path, dtype by dtype, bit for bit), loads in
  ``phd_qmclib_tpu.qmc_exec.io`` with equal state arrays, config and
  data, and is reported by ``phd_qmclib_tpu.qmc_exec.report.report_hdf5``.
* A result the JAX package dumps loads in the port with equal arrays, and
  the port continues the run from it.
* The four result files of the upstream library under ``tests/fixtures``
  (both legacy state layouts) load in the port as they do in the JAX
  package; the stored energies and drifts are reproduced by the port's
  functions to 1e-9.
"""
import pathlib

import h5py
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.qmc_exec import dmc as tdmc, io as tio, vmc as tvmc
from phd_qmclib_tpu.qmc_exec import dmc as jdmc, io as jio, vmc as jvmc
from phd_qmclib_tpu.qmc_exec.report import report_hdf5

from .test_torch_exec_utils import (MODEL_CONFIG, assert_same,
                                    assert_same_tree, h5_tree, to_numpy)

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore")

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

DMC_CONFIG = dict(
    model_spec=dict(MODEL_CONFIG), time_step=1e-2, max_num_walkers=64,
    target_num_walkers=48, num_blocks=4, num_time_steps_block=8,
    burn_in_blocks=1, rng_seed=31, dtype="float64", est_every=2,
    block_offset=2,
    density_spec={"num_bins": 6}, ssf_spec={"num_modes": 4,
                                            "as_pure_est": False},
    obd_spec={"num_pos": 3, "est_every_mult": 2},
    pair_corr_spec={"num_bins": 5, "as_pure_est": False},
    cm_diffusion_spec={"window_blocks": 2},
    itc_spec={"num_modes": 3, "num_lags": 2})
VMC_CONFIG = dict(
    model_spec=dict(MODEL_CONFIG), move_spread=0.25, num_blocks=3,
    num_steps_block=16, burn_in_blocks=1, num_walkers=8, rng_seed=77,
    dtype="float64", ssf_spec={"num_modes": 4}, obd_spec={"num_pos": 3},
    pair_corr_spec={"num_bins": 5, "est_every_mult": 2}, gaussian=True)

DMC_STATE_FIELDS = ("pos", "drift", "energies", "weights", "masks", "energy",
                    "weight", "ref_energy", "accum_energy", "total_energy",
                    "total_weight", "cmd_accum", "itc_buf", "itc_filled")
VMC_STATE_FIELDS = ("pos", "wf_abs_log", "energy", "move_stat")


def _same_states(a, b, fields):
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            x, y = to_numpy(x), to_numpy(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    if "num_walkers" in type(a)._fields and "masks" in type(a)._fields:
        assert int(to_numpy(a.num_walkers).sum()) \
            == int(to_numpy(b.num_walkers).sum())


@pytest.fixture(scope="module")
def torch_dmc_result():
    proc = tdmc.Proc.from_config(DMC_CONFIG)
    start = tdmc.ProcInput.from_model_sys_conf_spec(
        tdmc.ModelSysConfSpec(), proc, device="cpu")
    return proc.exec(start)


@pytest.fixture(scope="module")
def torch_vmc_result():
    proc = tvmc.Proc.from_config(VMC_CONFIG)
    start = tvmc.ProcInput.from_model_sys_conf_spec(
        tvmc.ModelSysConfSpec(), proc, device="cpu")
    return proc.exec(start)


@pytest.mark.parametrize("keep", (False, True))
def test_dmc_file_of_the_port_loads_in_jax(tmp_path, torch_dmc_result,
                                           keep):
    result = torch_dmc_result
    if keep:
        proc = result.proc.evolve({"keep_iter_data": True})
        result = proc.exec(tdmc.ProcInput(result.state))
    path = str(tmp_path / "out.h5")
    tio.DmcHDF5FileHandler(path, "run").dump(result)
    # The JAX handler writes the same tree for the same result, but for
    # the width of the walker count it was handed (an int64 tensor).
    jio.DmcHDF5FileHandler(path, "by-jax").dump(result)
    with h5py.File(path, "r") as fp:
        ours, theirs = h5_tree(fp["run"]), h5_tree(fp["by-jax"])
        assert ours["dmc/state/shard_num_walkers"].dtype == np.int32
        theirs["dmc/state/shard_num_walkers"] = \
            theirs["dmc/state/shard_num_walkers"].astype(np.int32)
        assert_same_tree(ours, theirs)

    loaded = jio.DmcHDF5FileHandler(path, "run").load()
    _same_states(loaded.state, result.state, DMC_STATE_FIELDS)
    assert to_numpy(loaded.state.num_walkers).shape == (1,)
    assert loaded.proc.as_config() == result.proc.as_config()
    assert_same(loaded.data, result.data)
    assert (loaded.data.series is not None) == keep
    text = report_hdf5(path, group="run")
    assert "== DMC result ==" in text and "E/N" in text
    # And back into the port.
    again = tio.DmcHDF5FileHandler(path, "run").load(device="cpu")
    _same_states(again.state, result.state,
                 DMC_STATE_FIELDS + ("num_walkers",))
    assert again.proc == result.proc
    assert_same(again.data, result.data)


def test_dmc_file_of_jax_loads_in_the_port(tmp_path):
    config = dict(DMC_CONFIG, num_blocks=2)
    jproc = jdmc.Proc.from_config(config)
    jresult = jproc.exec(jdmc.ProcInput.from_model_sys_conf_spec(
        jdmc.ModelSysConfSpec(), jproc))
    path = str(tmp_path / "jax.h5")
    jio.DmcHDF5FileHandler(path, "run").dump(jresult)
    loaded = tio.DmcHDF5FileHandler(path, "run").load(device="cpu")
    _same_states(loaded.state, jresult.state, DMC_STATE_FIELDS)
    assert loaded.state.num_walkers.dtype == torch.int64
    assert loaded.state.num_walkers.dim() == 0
    assert loaded.state.itc_filled.dtype == torch.int32
    assert loaded.proc.as_config() == jproc.as_config()
    assert_same(loaded.data, jresult.data)
    # The port continues the JAX run from its state.
    proc = loaded.proc.evolve({"num_blocks": 2, "burn_in_blocks": 0,
                               "block_offset": 9})
    out = proc.exec(tdmc.ProcInput.from_result(loaded, proc))
    energy = out.data.blocks.energy.mean / 5
    assert energy == pytest.approx(jresult.data.blocks.energy.mean / 5,
                                   rel=0.05)
    assert 0 < int(out.state.num_walkers) <= 64


def test_vmc_files_go_both_ways(tmp_path, torch_vmc_result):
    result = torch_vmc_result
    path = str(tmp_path / "vmc.h5")
    tio.VmcHDF5FileHandler(path, "run").dump(result)
    jio.VmcHDF5FileHandler(path, "by-jax").dump(result)
    with h5py.File(path, "r") as fp:
        assert_same_tree(h5_tree(fp["run"]), h5_tree(fp["by-jax"]))
    loaded = jio.VmcHDF5FileHandler(path, "run").load()
    _same_states(loaded.state, result.state, VMC_STATE_FIELDS)
    assert loaded.proc.as_config() == result.proc.as_config()
    assert_same(loaded.data, result.data)
    assert "== VMC result ==" in report_hdf5(path, group="run",
                                              sampling_type="vmc")

    jproc = jvmc.Proc.from_config(VMC_CONFIG)
    jresult = jproc.exec(jvmc.ProcInput.from_model_sys_conf_spec(
        jvmc.ModelSysConfSpec(), jproc))
    jio.VmcHDF5FileHandler(path, "jax-run").dump(jresult)
    back = tio.VmcHDF5FileHandler(path, "jax-run").load(device="cpu")
    _same_states(back.state, jresult.state, VMC_STATE_FIELDS)
    assert back.state.ssf_parts is None and back.state.obd_parts is None
    assert_same(back.data, jresult.data)
    # A loaded state has no carried parts: the sampler computes them.
    config = dict(back.proc.as_config(), num_blocks=2, burn_in_blocks=0)
    del config["pair_corr_spec"]  # the every-step mode carries the parts
    proc = tvmc.Proc.from_config(config)
    out = proc.exec(tvmc.ProcInput.from_result(back, proc))
    assert np.isfinite(out.data.blocks.energy.mean)
    assert np.isfinite(out.data.blocks.ss_factor.mean).all()


DMC_FIXTURES = [("test-dmc-ssf-results.h5", "ssf-data-group"),
                ("test-dmc-density-results.h5", "density-data-group")]
VMC_FIXTURES = [("test-vmc-results.h5", "test-group"),
                ("test-vmc-ssf-results.h5", "ssf-data-group")]


@pytest.mark.parametrize("name,group", DMC_FIXTURES)
def test_dmc_fixture_loads_as_in_jax(name, group):
    """The legacy ``props`` layout, the numba-era config keys."""
    ours = tio.DmcHDF5FileHandler(str(FIXTURES / name), group).load(
        device="cpu")
    theirs = jio.DmcHDF5FileHandler(str(FIXTURES / name), group).load()
    _same_states(ours.state, theirs.state, DMC_STATE_FIELDS)
    assert ours.proc.as_config() == theirs.proc.as_config()
    assert_same(ours.data, theirs.data)
    assert ours.state.pos.shape == (512, 8)
    # The stored walker energies and drifts against the port's functions.
    live = ~to_numpy(ours.state.masks)
    physical = tmrbp.PhysicalFuncs(ours.proc.model_spec, device="cpu")
    energy = to_numpy(physical.energy(ours.state.pos))
    drift = to_numpy(physical.drift(ours.state.pos))
    assert np.abs(energy - to_numpy(ours.state.energies))[live].max() < 1e-9
    assert np.abs(drift - to_numpy(ours.state.drift))[live].max() < 1e-9


@pytest.mark.parametrize("name,group", VMC_FIXTURES)
def test_vmc_fixture_loads_as_in_jax(name, group):
    """The legacy single-configuration state: the energy is recomputed
    from the model (to 1e-10 of the JAX package's)."""
    ours = tio.VmcHDF5FileHandler(str(FIXTURES / name), group).load(
        device="cpu")
    theirs = jio.VmcHDF5FileHandler(str(FIXTURES / name), group).load()
    _same_states(ours.state, theirs.state,
                 ("pos", "wf_abs_log", "move_stat"))
    np.testing.assert_allclose(to_numpy(ours.state.energy),
                               to_numpy(theirs.state.energy), rtol=1e-10)
    assert ours.proc.as_config() == theirs.proc.as_config()
    assert_same(ours.data, theirs.data)
    physical = tmrbp.PhysicalFuncs(ours.proc.model_spec, device="cpu")
    assert float(physical.wf_abs_log(ours.state.pos)[0]) == pytest.approx(
        float(ours.state.wf_abs_log[0]), abs=1e-9)


def test_port_resumes_from_a_fixture_state():
    name, group = DMC_FIXTURES[0]
    result = tio.DmcHDF5FileHandler(str(FIXTURES / name), group).load(
        device="cpu")
    proc = result.proc.evolve({
        "num_blocks": 2, "num_time_steps_block": 16, "burn_in_blocks": 0,
        "rng_seed": 123, "dtype": "float64", "ssf_spec": None})
    out = proc.exec(tdmc.ProcInput.from_result(result, proc))
    assert out.data.blocks.energy.mean / 8 == pytest.approx(
        result.data.blocks.energy.mean / 8, rel=0.05)


def test_proc_spec_attrs_normalize(tmp_path, torch_dmc_result):
    """``save_proc`` drops ``None``s; ``load_proc`` turns NumPy scalars
    and bytes back into Python values."""
    config = torch_dmc_result.proc.as_config()
    handler = tio.DmcHDF5FileHandler(str(tmp_path / "p.h5"), "g")
    with h5py.File(tmp_path / "p.h5", "w") as fp:
        handler.save_proc(dict(config), fp.require_group("spec"))
        fp["spec"].attrs["dtype"] = np.bytes_(b"float64")
        raw = dict(fp["spec"].attrs.items())
        proc = handler.load_proc(fp["spec"])
    assert isinstance(raw["keep_iter_data"], np.bool_)
    assert isinstance(raw["dtype"], bytes)
    assert proc.as_config() == config
    assert type(proc.keep_iter_data) is bool and proc.dtype == "float64"
    assert "num_mesh_devices" not in raw  # None is not an attr


def test_dump_replace_policy_and_missing_groups(tmp_path, torch_dmc_result):
    path = str(tmp_path / "r.h5")
    handler = tio.DmcHDF5FileHandler(path, "g")
    handler.dump(torch_dmc_result)
    with pytest.raises(tio.HDF5FileHandlerGroupError,
                       match="name already exists"):
        handler.dump(torch_dmc_result)
    tio.DmcHDF5FileHandler(path, "g", dump_replace=True).dump(
        torch_dmc_result)
    with pytest.raises(tio.HDF5FileHandlerGroupError, match="no 'g/vmc'"):
        tio.VmcHDF5FileHandler(path, "g").load(device="cpu")
    with pytest.raises(ValueError, match="needs a 'group' entry"):
        tio.DmcHDF5FileHandler.from_config(
            {"type": "HDF5_FILE", "location": "x.h5"})
    made = tio.DmcHDF5FileHandler.from_config(
        {"type": "HDF5_FILE", "location": "x.h5", "group": "g"})
    assert made.location_path.is_absolute() and made.sampling_type == "dmc"


def test_sharded_state_raises_by_name(tmp_path, torch_dmc_result):
    """A stored ``shard_num_walkers`` of several entries is no longer
    refused: the global view of a sharded state loads with one count per
    shard, in both packages, and a one-device sampling re-lays it out."""
    path = str(tmp_path / "s.h5")
    tio.DmcHDF5FileHandler(path, "g").dump(torch_dmc_result)
    num = int(torch_dmc_result.state.num_walkers)
    half = torch_dmc_result.state.max_num_walkers // 2
    counts = [num - num // 2, num // 2]
    with h5py.File(path, "a") as fp:
        # The same walkers as two shards: the second shard's at `half`.
        confs = fp["g/dmc/state/confs"][()]
        confs[half:half + counts[1]] = confs[counts[0]:num]
        fp["g/dmc/state/confs"][...] = confs
        mask = np.ones(2 * half, dtype=bool)
        mask[:counts[0]] = mask[half:half + counts[1]] = False
        fp["g/dmc/state/props/mask"][...] = mask
        del fp["g/dmc/state/shard_num_walkers"]
        fp["g/dmc/state"].create_dataset(
            "shard_num_walkers", data=np.array(counts, dtype=np.int32))
    loaded = tio.DmcHDF5FileHandler(path, "g").load(device="cpu")
    jloaded = jio.DmcHDF5FileHandler(path, "g").load()
    assert loaded.state.num_walkers.tolist() == counts \
        == np.asarray(jloaded.state.num_walkers).tolist()
    one = loaded.proc.sampling.adapt_state_shards(loaded.state)
    assert int(one.num_walkers) == num
    np.testing.assert_array_equal(one.pos[:num].numpy(),
                                  torch_dmc_result.state.pos[:num].numpy())
    # Written again, it keeps its shards.
    again = str(tmp_path / "t.h5")
    tio.DmcHDF5FileHandler(again, "g").dump(loaded)
    with h5py.File(again, "r") as fp:
        assert fp["g/dmc/state/shard_num_walkers"][()].tolist() == counts
        assert int(fp["g/dmc/state"].attrs["num_walkers"]) == num


def test_load_defaults_to_the_card(tmp_path, torch_dmc_result):
    """No device named: the state goes to the GPU, or the call raises."""
    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without CUDA")
    path = str(tmp_path / "d.h5")
    tio.DmcHDF5FileHandler(path, "g").dump(torch_dmc_result)
    with pytest.raises((RuntimeError, AssertionError)):
        tio.DmcHDF5FileHandler(path, "g").load()
