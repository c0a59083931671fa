"""Sharded procedures of the port on gloo ranks, in f64 on the CPU.

``num_mesh_devices`` runs a procedure's block loop on that many ranks
(``qmc_exec.sharded``); its files and checkpoints hold the global view,
the JAX package's layout: a sharded file or checkpoint of either package
loads and resumes in the other, and under another shard count.  A
killed sharded run resumes bit-exactly; a forced shard collapse logs the
JAX package's warning and goes on from a rebalanced state; each row of a
``fused_sweep_mesh`` sweep is its standalone sharded run, bit for bit.
"""
import dataclasses
import logging
import re

import h5py
import numpy as np
import torch
import yaml
from click.testing import CliRunner

from phd_qmclib_torch import mrbp_cli
from phd_qmclib_torch.qmc_exec import cli_app, dmc as tdmc, io as tio
from phd_qmclib_torch.qmc_exec.logging import exec_logger
from phd_qmclib_tpu.qmc_exec import dmc as jdmc, io as jio

from .test_torch_exec_utils import MODEL_CONFIG, assert_same

torch.set_num_threads(1)

#: A sharded run with every window that crosses blocks: the pure
#: estimators' (two blocks), the CM diffusion's, and a cadence rebalance.
SHARDED = dict(
    model_spec=dict(MODEL_CONFIG), time_step=1e-2, max_num_walkers=64,
    target_num_walkers=48, num_blocks=4, num_time_steps_block=8,
    burn_in_blocks=1, rng_seed=29, dtype="float64", est_every=2,
    density_spec={"num_bins": 6, "pfw_num_time_steps": 16},
    ssf_spec={"num_modes": 3, "pfw_num_time_steps": 16},
    cm_diffusion_spec={"window_blocks": 2}, rebalance_every=2,
    num_mesh_devices=2)


def _config(tmp_path, proc, name="run"):
    return {"meta": {"name": "sharded"}, "app_spec": [{
        "proc": proc,
        "proc_input": {"type": "MODEL_SYS_CONF", "dist_type": "RANDOM"},
        "proc_output": {"type": "HDF5_FILE",
                        "location": str(tmp_path / f"{name}.h5"),
                        "group": "dmc"}}]}


def test_cli_runs_a_sharded_config_and_its_checkpoint_resumes(tmp_path):
    """``start --device cpu`` on ``num_mesh_devices: 2``: two gloo ranks.
    The file holds the global state (two shard counts) and loads in the
    JAX package; the checkpoint cut at block 3 of 4, inside a
    forward-walking window, resumes in the port to the uninterrupted
    run's data bit for bit, and in the JAX package."""
    ckpt = str(tmp_path / "run.ckpt.h5")
    proc = dict(SHARDED, checkpoint_file=ckpt, checkpoint_every=3)
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(_config(tmp_path, proc)))
    result = CliRunner().invoke(mrbp_cli.make_cli("dmc"),
                                ["start", str(path), "--device", "cpu"])
    assert result.exit_code == 0, result.output
    with h5py.File(tmp_path / "run.h5", "r") as fp:
        counts = fp["dmc/dmc/state/shard_num_walkers"][()]
        assert counts.shape == (2,)
        assert int(fp["dmc/dmc/state"].attrs["num_walkers"]) \
            == int(counts.sum())
    ours = tio.DmcHDF5FileHandler(str(tmp_path / "run.h5"), "dmc").load(
        device="cpu")
    theirs = jio.DmcHDF5FileHandler(str(tmp_path / "run.h5"), "dmc").load()
    assert ours.state.num_walkers.tolist() \
        == np.asarray(theirs.state.num_walkers).tolist()
    # The checkpoint: its rebalance cadence, and a bit-exact resume.
    with h5py.File(ckpt, "r") as fp:
        assert fp["checkpoint/dmc/state/shard_num_walkers"].shape == (2,)
        assert "aux" in fp["checkpoint/dmc/resume"]
    rproc, rinput = tdmc.Proc.restore_checkpoint(ckpt, device="cpu")
    resumed = rproc.exec(rinput)
    assert_same(resumed.data, ours.data)
    assert_same(resumed.state, ours.state)
    # The JAX package resumes it on its own 2-device mesh.
    jproc, jinput = jdmc.Proc.restore_checkpoint(ckpt)
    assert np.asarray(jinput.state.num_walkers).shape == (2,)
    assert np.isfinite(jproc.exec(jinput).data.blocks.energy.mean)


def test_jax_sharded_checkpoint_resumes_in_the_port_on_any_layout(
        tmp_path):
    """A file and a checkpoint the JAX package writes from a 2-shard run
    load in the port; the checkpoint resumes on 2 ranks (as stored), on 4
    and on one device (re-laid out)."""
    ckpt = str(tmp_path / "jax.ckpt.h5")
    proc = jdmc.Proc.from_config(dict(SHARDED, checkpoint_file=ckpt,
                                      checkpoint_every=3))
    jresult = proc.exec(jdmc.ProcInput.from_model_sys_conf_spec(
        jdmc.ModelSysConfSpec(), proc))
    jio.DmcHDF5FileHandler(str(tmp_path / "jax.h5"), "dmc").dump(jresult)
    loaded = tio.DmcHDF5FileHandler(str(tmp_path / "jax.h5"), "dmc").load(
        device="cpu")
    assert loaded.state.num_walkers.tolist() \
        == np.asarray(jresult.state.num_walkers).tolist()
    rproc, rinput = tdmc.Proc.restore_checkpoint(ckpt, device="cpu")
    assert rinput.state.num_walkers.shape == (2,)
    for devices, want in ((None, ()), (4, (4,)), (2, (2,))):
        run = rproc.evolve({"num_mesh_devices": devices})
        result = run.exec(rinput)
        assert tuple(result.state.num_walkers.shape) == want
        assert np.isfinite(result.data.blocks.energy.mean)
        np.testing.assert_allclose(result.data.blocks.density.mean.sum(),
                                   MODEL_CONFIG["boson_number"], rtol=1e-9)


#: The JAX package's warning (``qmc_exec/dmc.py:778-787``), its counts
#: left open.
COLLAPSE = re.compile(
    r"walker population collapsed on a shard \(per-shard counts "
    r"\[[0-9, ]+\]\); rebalanced the surviving walkers evenly across "
    r"shards and resumed \(forward-walking window restarted; the "
    r"interrupted window contributes no sample\)\. Consider "
    r"rebalance_every or a larger target_num_walkers\.")


def test_forced_shard_collapse_logs_and_resumes(caplog):
    """All walkers packed into the first shards of four, two empty: the
    first block's counts show the collapse, every rank takes the same
    decision, and the run goes on from the rebalanced state with the
    interrupted forward-walking window dropped (the JAX package's
    ``test_forced_shard_collapse_on_full_surface`` at tier-1 depth)."""
    config = dict(SHARDED, num_mesh_devices=4, max_num_walkers=64,
                  target_num_walkers=32, num_blocks=6, rebalance_every=None,
                  obd_spec={"num_pos": 3, "pfw_num_time_steps": 16},
                  pair_corr_spec={"num_bins": 4, "pfw_num_time_steps": 16},
                  itc_spec={"num_modes": 3, "num_lags": 2})
    proc = tdmc.Proc.from_config(config)
    start = tdmc.ProcInput.from_model_sys_conf_spec(
        tdmc.ModelSysConfSpec(), proc, device="cpu")
    state = start.state
    # Pack the valid walkers into slots 0..31: shards 2 and 3 empty.
    valid = ~state.masks
    num = int(valid.sum())
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    packed = {name: getattr(state, name)[order]
              for name in ("pos", "drift", "energies", "weights")}
    masks = torch.arange(64) >= num
    state = state._replace(**packed, masks=masks, num_walkers=torch.tensor(
        [16, 16, 0, 0]))
    exec_logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger=exec_logger.name):
            result = proc.exec(tdmc.ProcInput(state))
    finally:
        exec_logger.propagate = False
    warned = [rec.getMessage() for rec in caplog.records
              if "collapsed" in rec.getMessage()]
    assert warned and all(COLLAPSE.fullmatch(text) for text in warned)
    blocks = result.data.blocks
    assert np.isfinite(blocks.energy.mean)
    # Windows of two blocks: fewer samples than the three of an
    # uninterrupted run, each a whole window.
    assert 1 <= blocks.density.totals.shape[0] < 3
    np.testing.assert_allclose(blocks.density.mean.sum(),
                               MODEL_CONFIG["boson_number"], rtol=1e-9)
    for name in ("ss_factor", "one_body_dm", "pair_corr"):
        assert np.all(np.isfinite(getattr(blocks, name).mean))
    assert result.state.num_walkers.min() > 0


def test_fused_sweep_mesh_rows_are_their_sharded_runs(tmp_path):
    """``fused_sweep_mesh: [2, 2]`` on four gloo ranks: each row's file
    is its standalone 2-shard run's, bit for bit."""
    rows = [dict(SHARDED, num_mesh_devices=None, rebalance_every=None,
                 model_spec=dict(MODEL_CONFIG, interaction_strength=gn),
                 rng_seed=seed)
            for gn, seed in ((0.5, 41), (2.0, 42))]
    config = {"meta": {"name": "mesh sweep"}, "fused_sweep": True,
              "fused_sweep_mesh": [2, 2], "app_spec": [
                  _config(tmp_path, row, f"row{r}")["app_spec"][0]
                  for r, row in enumerate(rows)]}
    app = cli_app.CLIApp.from_config(config, "dmc")
    results = app.exec(device="cpu")
    for r, (row, fused) in enumerate(zip(rows, results)):
        proc = tdmc.Proc.from_config(dict(row, num_mesh_devices=2))
        alone = proc.exec(tdmc.ProcInput.from_model_sys_conf_spec(
            tdmc.ModelSysConfSpec(), proc, device="cpu"))
        assert_same(fused.data, alone.data)
        assert_same(fused.state, alone.state)
        loaded = tio.DmcHDF5FileHandler(str(tmp_path / f"row{r}.h5"),
                                        "dmc").load(device="cpu")
        assert_same(loaded.data, alone.data)
        assert dataclasses.asdict(fused.proc)["num_mesh_devices"] is None
