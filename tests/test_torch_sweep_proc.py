"""The port's fused sweep execution (``qmc_exec.sweep``, ``CLIApp`` with
``fused_sweep``) on the CPU in f64.

Each fused row's result equals its sequential ``Proc.exec``, field by
field and bit for bit; checkpoints are all-or-none and per row, a killed
fused run restores from its rows' files to the uninterrupted result, and
a row's checkpoint resumes as a standalone run; a fused CLI run writes
per row the file the sequential run writes, which the JAX package's
``report_hdf5`` reads; the validation errors are the JAX package's.
"""
import shutil

import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.qmc_exec import cli_app, config as tconfig
from phd_qmclib_torch.qmc_exec import dmc as tdmc_exec
from phd_qmclib_torch.qmc_exec import io as tio
from phd_qmclib_torch.qmc_exec import vmc as tvmc_exec
from phd_qmclib_torch.qmc_exec.sweep import SweepProc, VmcSweepProc
from phd_qmclib_tpu.models import mrbp as jmrbp
from phd_qmclib_tpu.qmc_exec import dmc as jdmc_exec
from phd_qmclib_tpu.qmc_exec import report as jreport
from phd_qmclib_tpu.qmc_exec import sweep as jsweep
from phd_qmclib_tpu.qmc_exec import vmc as jvmc_exec
from tests.test_torch_exec_utils import assert_same, assert_same_tree, h5_tree

torch.set_num_threads(1)

GNS = (0.5, 2.0)


def _spec_kw(gn, sc=6.0):
    return dict(lattice_depth=10.0, lattice_ratio=1.0, interaction_strength=gn,
                boson_number=6, supercell_size=sc, tbf_contact_cutoff=0.25)


def _dmc_proc(pkg, mrbp, gn, sc=6.0, **overrides):
    kwargs = dict(model_spec=mrbp.Spec(**_spec_kw(gn, sc)), time_step=1e-3,
                  max_num_walkers=48, target_num_walkers=32,
                  num_blocks=3, num_time_steps_block=8,
                  burn_in_blocks=1, rng_seed=23, dtype="float64",
                  density_spec=pkg.DensityEstSpec(num_bins=12),
                  ssf_spec=pkg.SSFEstSpec(num_modes=4),
                  obd_spec=pkg.OBDEstSpec(num_pos=5),
                  pair_corr_spec=pkg.PairCorrEstSpec(num_bins=6))
    kwargs.update(overrides)
    return pkg.Proc(**kwargs)


def _vmc_proc(pkg, mrbp, gn, sc=6.0, **overrides):
    kwargs = dict(model_spec=mrbp.Spec(**_spec_kw(gn, sc)), move_spread=0.25,
                  num_blocks=2, num_steps_block=16, burn_in_blocks=1,
                  num_walkers=8, rng_seed=61, dtype="float64",
                  ssf_spec=pkg.SSFEstSpec(num_modes=3),
                  pair_corr_spec=pkg.PairCorrEstSpec(num_bins=6))
    kwargs.update(overrides)
    return pkg.Proc(**kwargs)


def _input(pkg, proc):
    return pkg.ProcInput.from_model_sys_conf_spec(
        pkg.ModelSysConfSpec(dist_type="RANDOM"), proc, device="cpu")


# Rows that differ in coupling, in time step and seed, and in supercell.
DMC_ROWS = {
    "coupling": [dict(gn=0.5), dict(gn=2.0, rng_seed=24)],
    "time_step": [dict(gn=1.0), dict(gn=1.0, time_step=2e-3, rng_seed=5)],
    "supercell": [dict(gn=1.0), dict(gn=1.0, sc=8.0, rng_seed=7)],
    "cm_itc": [dict(gn=0.5, num_blocks=4,
                    cm_diffusion_spec=tdmc_exec.CMDiffusionEstSpec(
                        window_blocks=2), itc_spec=tdmc_exec.ITCEstSpec(
                        num_modes=3, num_lags=4)),
               dict(gn=2.0, rng_seed=24, num_blocks=4,
                    cm_diffusion_spec=tdmc_exec.CMDiffusionEstSpec(
                        window_blocks=2), itc_spec=tdmc_exec.ITCEstSpec(
                        num_modes=3, num_lags=4))],
}


@pytest.mark.parametrize("rows", sorted(DMC_ROWS))
def test_sweep_proc_matches_sequential_exec(rows):
    procs = tuple(_dmc_proc(tdmc_exec, tmrbp, **kw) for kw in DMC_ROWS[rows])
    inputs = [_input(tdmc_exec, p) for p in procs]
    fused = SweepProc(procs).exec(inputs)
    for proc, inp, result in zip(procs, inputs, fused):
        alone = proc.exec(tdmc_exec.ProcInput(inp.state))
        assert_same(result.data, alone.data)
        assert_same(result.state, alone.state, "state")


@pytest.mark.parametrize("gaussian", [False, True])
def test_vmc_sweep_proc_matches_sequential_exec(gaussian):
    procs = (_vmc_proc(tvmc_exec, tmrbp, 0.5, gaussian=gaussian),
             _vmc_proc(tvmc_exec, tmrbp, 2.0, sc=8.0, rng_seed=62,
                       move_spread=0.3, gaussian=gaussian))
    inputs = [_input(tvmc_exec, p) for p in procs]
    fused = VmcSweepProc(procs).exec(inputs)
    for proc, inp, result in zip(procs, inputs, fused):
        alone = proc.exec(tvmc_exec.ProcInput(inp.state))
        assert_same(result.data, alone.data)
        assert_same(result.state, alone.state, "state")


# -- validation: the JAX package's texts -----------------------------------------

def _same_error(make_ours, make_theirs):
    with pytest.raises(ValueError) as ours:
        make_ours()
    with pytest.raises(ValueError) as theirs:
        make_theirs()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("bad", [
    "empty", "blocks", "mesh_devices", "ckpt_some", "ckpt_same",
    "ckpt_every"])
@pytest.mark.parametrize("kind", ["dmc", "vmc"])
def test_sweep_proc_validation_matches_jax(kind, bad):
    def procs(pkg, mrbp):
        make = _dmc_proc if kind == "dmc" else _vmc_proc
        rows = {
            "empty": [],
            "blocks": [{}, dict(num_blocks=5)],
            "mesh_devices": [dict(num_mesh_devices=0)],
            "ckpt_some": [dict(checkpoint_file="a.h5"), {}],
            "ckpt_same": [dict(checkpoint_file="a.h5"),
                          dict(checkpoint_file="a.h5")],
            "ckpt_every": [dict(checkpoint_file="a.h5", checkpoint_every=1),
                           dict(checkpoint_file="b.h5",
                                checkpoint_every=2)],
        }[bad]
        return tuple(make(pkg, mrbp, 0.5 + r, **kw)
                     for r, kw in enumerate(rows))

    ours_cls = SweepProc if kind == "dmc" else VmcSweepProc
    theirs_cls = jsweep.SweepProc if kind == "dmc" else jsweep.VmcSweepProc
    tpkg, jpkg = ((tdmc_exec, jdmc_exec) if kind == "dmc"
                  else (tvmc_exec, jvmc_exec))
    _same_error(lambda: ours_cls(procs(tpkg, tmrbp)),
                lambda: theirs_cls(procs(jpkg, jmrbp)))


@pytest.mark.parametrize("bad", ["inputs", "resume_some", "resume_blocks",
                                 "stream"])
def test_sweep_exec_errors_match_jax(bad):
    procs = tuple(_dmc_proc(tdmc_exec, tmrbp, gn) for gn in GNS)
    inputs = [_input(tdmc_exec, p) for p in procs]
    resume = {"blocks_completed": 1, "it_offset": 0, "it_burn": 1,
              "it_next": 2, "rebalance_pending": False}
    if bad == "inputs":
        inputs = inputs[:1]
        text = "one ProcInput per procedure"
    elif bad == "resume_some":
        inputs[0] = tdmc_exec.ProcInput(inputs[0].state, resume=resume)
        text = "fused sweep resume is all-or-none"
    elif bad == "resume_blocks":
        inputs = [tdmc_exec.ProcInput(pi.state, resume=dict(
            resume, blocks_completed=1 + r)) for r, pi in enumerate(inputs)]
        text = "fused sweep rows must resume from the same block"
    else:
        inputs = [tdmc_exec.ProcInput(pi.state, resume=dict(
            resume, it_offset=3)) for pi in inputs]
        text = "checkpoint stream position diverged"
    with pytest.raises(ValueError, match=text):
        SweepProc(procs).exec(inputs)


# -- checkpoints ------------------------------------------------------------------

class _Killed(RuntimeError):
    """A kill right after a round of row checkpoints."""


@pytest.mark.parametrize("kind", ["dmc", "vmc"])
def test_killed_sweep_restores_from_its_row_checkpoints(tmp_path, kind):
    pkg, make, sweep_cls = ((tdmc_exec, _dmc_proc, SweepProc)
                            if kind == "dmc"
                            else (tvmc_exec, _vmc_proc, VmcSweepProc))
    extra = dict(num_blocks=4) if kind == "dmc" else dict(num_blocks=3)
    procs = tuple(make(pkg, tmrbp, gn, rng_seed=30 + r, checkpoint_every=1,
                       checkpoint_file=str(tmp_path / f"row{r}.h5"), **extra)
                  for r, gn in enumerate(GNS))
    inputs = [_input(pkg, p) for p in procs]
    whole = sweep_cls(procs).exec(inputs)

    def kill(row_inputs):
        if row_inputs[0].resume["blocks_completed"] == 2:
            raise _Killed

    with pytest.raises(_Killed):
        sweep_cls(procs).exec(inputs, checkpoint_hook=kill)
    restored = [pkg.Proc.restore_checkpoint(str(tmp_path / f"row{r}.h5"),
                                            device="cpu")
                for r in range(len(GNS))]
    assert all(pi.resume["blocks_completed"] == 2 for _, pi in restored)
    resumed = sweep_cls(tuple(p for p, _ in restored)).exec(
        [pi for _, pi in restored])
    for want, got in zip(whole, resumed):
        assert_same(got.data, want.data)
    # A row's checkpoint is its standalone checkpoint: it resumes unfused.
    proc, pin = restored[1]
    assert_same(proc.exec(pin).data, whole[1].data)


def test_in_memory_sweep_checkpoint_per_row_is_the_standalone_one():
    procs = tuple(_dmc_proc(tdmc_exec, tmrbp, gn, checkpoint_every=2,
                            pair_corr_spec=None, obd_spec=None,
                            density_spec=tdmc_exec.DensityEstSpec(
                                num_bins=12, pfw_num_time_steps=16))
                  for gn in GNS)
    inputs = [_input(tdmc_exec, p) for p in procs]
    rounds = []
    SweepProc(procs).exec(inputs, checkpoint_hook=rounds.append)
    assert len(rounds) == 1 and len(rounds[0]) == 2
    for proc, inp, row in zip(procs, inputs, rounds[0]):
        alone = []
        proc.exec(tdmc_exec.ProcInput(inp.state), checkpoint_hook=alone.append)
        assert_same(row.resume, alone[0].resume, "resume")
        assert_same(row.state, alone[0].state, "state")


# -- the application layer ----------------------------------------------------------

def _app_config(out_dir, fused, kind):
    rows = []
    for i, gn in enumerate(GNS):
        proc = (_dmc_proc if kind == "dmc" else _vmc_proc)(
            tdmc_exec if kind == "dmc" else tvmc_exec, tmrbp, gn,
            rng_seed=41 + i).as_config()
        rows.append({"proc": proc,
                     "proc_input": {"type": "MODEL_SYS_CONF",
                                    "dist_type": "RANDOM"},
                     "proc_output": {"type": "HDF5_FILE",
                                     "location": str(out_dir / f"row{i}.h5"),
                                     "group": kind}})
    config = {"meta": {"name": "fused sweep test"}, "app_spec": rows}
    if fused:
        config["fused_sweep"] = True
    return config


@pytest.mark.parametrize("kind", ["dmc", "vmc"])
def test_cli_fused_sweep_writes_the_sequential_files(tmp_path, kind):
    for sub in ("fused", "seq"):
        (tmp_path / sub).mkdir()
    fused = cli_app.CLIApp.from_config(
        _app_config(tmp_path / "fused", True, kind), kind)
    assert fused.fused_sweep
    fused.exec(device="cpu")
    seq = cli_app.CLIApp.from_config(
        _app_config(tmp_path / "seq", False, kind), kind)
    assert not seq.fused_sweep
    seq.exec(device="cpu")
    import h5py

    for i in range(len(GNS)):
        paths = [tmp_path / sub / f"row{i}.h5" for sub in ("fused", "seq")]
        trees = []
        for path in paths:
            with h5py.File(path, "r") as fp:
                tree = h5_tree(fp)
            trees.append({k: v for k, v in tree.items()
                          if not k.endswith("@created")})
        assert_same_tree(*trees)
        reports = [jreport.report_hdf5(str(path)).replace(str(path), "")
                   for path in paths]
        assert reports[0] == reports[1]


def test_start_command_runs_a_fused_sweep(tmp_path):
    """``mrbp_cli dmc start`` of a two-row fused config writes each row's
    sequential file."""
    click = pytest.importorskip("click.testing")
    import yaml

    from phd_qmclib_torch import mrbp_cli

    for sub in ("fused", "seq"):
        (tmp_path / sub).mkdir()
        path = tmp_path / f"{sub}.yml"
        path.write_text(yaml.safe_dump(_app_config(
            tmp_path / sub, sub == "fused", "dmc")))
        result = click.CliRunner().invoke(
            mrbp_cli.make_cli("dmc"), ["start", str(path), "--device", "cpu"])
        assert result.exit_code == 0, result.output
    for i in range(len(GNS)):
        loaded = [tio.DmcHDF5FileHandler(
            str(tmp_path / sub / f"row{i}.h5"), "dmc").load(device="cpu")
            for sub in ("fused", "seq")]
        assert_same(loaded[0].data, loaded[1].data)


def test_fused_sweep_keys_follow_jax(tmp_path):
    """``fused_sweep`` parses as in the JAX package; ``fused_sweep_mesh``
    fails the JAX package's checks with its texts, a valid one parses
    (its run: ``tests/test_torch_mesh_proc.py``) and a mesh of other
    rows than procedures fails at the run with the JAX package's text;
    a wf_opt stanza cannot ride a fused sweep."""
    from phd_qmclib_tpu.qmc_exec import cli_app as jcli_app

    base = _app_config(tmp_path, True, "dmc")
    assert cli_app.CLIApp.from_config(base, "dmc").fused_sweep
    for extra in ({"fused_sweep": False, "fused_sweep_mesh": [2, 2]},
                  {"fused_sweep_mesh": [3]},
                  {"fused_sweep_mesh": [0, 2]}):
        _same_error(
            lambda: cli_app.CLIApp.from_config(dict(base, **extra), "dmc"),
            lambda: jcli_app.CLIApp.from_config(dict(base, **extra), "dmc"))
    meshed = dict(base, fused_sweep_mesh=[len(GNS), 1])
    assert cli_app.CLIApp.from_config(meshed, "dmc").fused_sweep_mesh \
        == (len(GNS), 1)
    wrong = dict(base, fused_sweep_mesh=[len(GNS) + 1, 1])
    _same_error(
        lambda: cli_app.CLIApp.from_config(wrong, "dmc").exec(device="cpu"),
        lambda: jcli_app.CLIApp.from_config(wrong, "dmc").exec())
    wf_opt = dict(base, app_spec=[{"proc_type": "wf_opt"}])
    _same_error(lambda: cli_app.CLIApp.from_config(wf_opt, "dmc"),
                lambda: jcli_app.CLIApp.from_config(wf_opt, "dmc"))


def test_single_procedure_runs_unfused(tmp_path):
    config = _app_config(tmp_path, True, "dmc")
    config["app_spec"] = config["app_spec"][:1]
    app = cli_app.CLIApp.from_config(config, "dmc")
    (result,) = app.exec(device="cpu")
    proc, pin = app.app_spec[0].build_input(device="cpu")
    assert_same(result.data, proc.exec(pin).data)


def test_example_sweep_parses_like_jax(tmp_path):
    """The shipped EOS example: four rows that share the sweep's static
    structure, each with its own coupling and seed."""
    from pathlib import Path

    from phd_qmclib_tpu.qmc_exec import cli_app as jcli_app
    from phd_qmclib_tpu.qmc_exec import config as jconfig

    src = Path(__file__).resolve().parent.parent / "examples" \
        / "eos_fused_sweep.yml"
    shutil.copy(src, tmp_path)
    ours = cli_app.CLIApp.from_config(
        tconfig.Loader().load(tmp_path / src.name), "dmc")
    theirs = jcli_app.CLIApp.from_config(
        jconfig.Loader().load(tmp_path / src.name), "dmc")
    assert ours.fused_sweep and theirs.fused_sweep
    assert [s.proc.as_config() for s in ours.app_spec] \
        == [s.proc.as_config() for s in theirs.app_spec]
    sweep = SweepProc(tuple(s.proc for s in ours.app_spec)).sweep
    assert [s.model_spec.interaction_strength for s in sweep.samplings] \
        == [0.25, 0.5, 1.0, 2.0]
    assert np.unique([s.rng_seed for s in sweep.samplings]).size == 4
