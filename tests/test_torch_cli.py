"""The port's config loader, application layer and command line
(``qmc_exec.config``, ``qmc_exec.cli_app``, ``mrbp_cli``) on the CPU.

* The loader and the templates give what the JAX package's give (equal
  dicts, equal rendered files).
* ``start`` and ``proc-template`` run through click's ``CliRunner`` on
  the configs of ``tests/qmc_exec/fixtures``, and the result files load
  in the JAX package.
* A continuation run that takes a result file as its input advances
  ``block_offset`` past the blocks already consumed.
* ``resume`` finishes a killed run from its checkpoint file to the
  uninterrupted result, bit for bit.
* The shipped examples go through the application layer unedited but
  for their depth (``Proc.evolve``), checkpoints included.
* What the port cannot honour raises by name; with no CUDA and no
  ``--device`` the commands fail.
"""
import pathlib
import shutil
from dataclasses import replace

import h5py
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from phd_qmclib_torch import mrbp_cli
from phd_qmclib_torch.qmc_exec import (cli_app, config as tconfig,
                                       dmc as tdmc, io as tio, vmc as tvmc)
from phd_qmclib_torch.qmc_exec.proc import ModelSysConfSpec
from phd_qmclib_tpu.qmc_exec import config as jconfig, io as jio

from .test_torch_exec_utils import assert_same

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore")

ROOT = pathlib.Path(__file__).parent.parent
FIXTURES = ROOT / "tests" / "qmc_exec" / "fixtures"
EXAMPLES = ROOT / "examples"


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    for path in FIXTURES.iterdir():
        shutil.copy(path, tmp_path)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _invoke(sampling_type, args):
    result = CliRunner().invoke(mrbp_cli.make_cli(sampling_type), args)
    return result


# -- loader and templates ---------------------------------------------------------

@pytest.mark.parametrize("name", ("dmc-cli-app-spec.yml",
                                  "vmc-cli-app-spec.yml"))
def test_loader_matches_jax(workdir, name):
    ours = tconfig.Loader().load(workdir / name)
    theirs = jconfig.Loader().load(workdir / name)
    assert ours == theirs
    location = ours["app_spec"][0]["proc_output"]["location"]
    assert pathlib.Path(location).is_absolute()


def test_loader_edges_match_jax(tmp_path):
    (tmp_path / "c.toml").write_text(
        '[meta]\nname = "t"\n[main_proc_set]\n'
        'proc = { checkpoint_file = "ck.h5" }\n'
        'input = { type = "MODEL_SYS_CONF" }\n'
        'output = { type = "HDF5_FILE", location = "o.h5", group = "g" }\n')
    ours = tconfig.Loader().load(tmp_path / "c.toml")
    assert ours == jconfig.Loader().load(tmp_path / "c.toml")
    stanza = ours["app_spec"][0]
    assert stanza["proc"]["checkpoint_file"] == str(tmp_path / "ck.h5")
    assert stanza["proc_output"]["location"] == str(tmp_path / "o.h5")
    for bad, match in (("noext", "no extension"), ("c.json", "unknown")):
        with pytest.raises(IOError, match=match):
            tconfig.Loader().load(tmp_path / bad)


def test_template_renders_as_in_jax(workdir):
    for mod, out in ((tconfig, "ours.yml"), (jconfig, "theirs.yml")):
        mod.Template(workdir / "dmc-template.yml.j2",
                     vars=mrbp_cli.TEMPLATE_VARS).save(workdir / out)
    ours = yaml.safe_load((workdir / "ours.yml").read_text())
    theirs = yaml.safe_load((workdir / "theirs.yml").read_text())
    assert ours["app_spec"][0]["proc"] == theirs["app_spec"][0]["proc"]
    assert ours["app_spec"][0]["proc"]["model_spec"]["lattice_depth"] \
        == pytest.approx(np.pi ** 2)
    assert ours["meta"]["description"] == "generated from dmc-template.yml"
    assert ours["app_spec"][0]["proc_output"]["location"] == "./ours.h5"


# -- the commands -------------------------------------------------------------------

def test_dmc_start(workdir):
    result = _invoke("dmc", ["start", "dmc-cli-app-spec.yml",
                             "--device", "cpu"])
    assert result.exit_code == 0, result.output
    out = workdir / "test-out-file.h5"
    with h5py.File(out, "r") as fp:
        assert "dmc-proc-ID0/dmc/state/confs" in fp
        assert "dmc-proc-ID0/dmc/data/blocks/energy/totals" in fp
        assert "dmc-proc-ID0/dmc/data/blocks/one_body_dm" in fp
    ours = tio.DmcHDF5FileHandler(str(out), "dmc-proc-ID0").load(
        device="cpu")
    theirs = jio.DmcHDF5FileHandler(str(out), "dmc-proc-ID0").load()
    assert ours.proc.as_config() == theirs.proc.as_config()
    assert ours.proc.num_blocks == 4 and ours.proc.burn_in_blocks == 1
    assert_same(ours.data, theirs.data)
    assert ours.data.blocks.energy.mean / 5 == pytest.approx(4.9, abs=0.1)


def test_vmc_start(workdir):
    result = _invoke("vmc", ["start", "vmc-cli-app-spec.yml",
                             "--device", "cpu"])
    assert result.exit_code == 0, result.output
    with h5py.File(workdir / "vmc-out.h5", "r") as fp:
        assert "vmc-proc-ID0/vmc/state/sys_conf" in fp
        assert "vmc-proc-ID0/vmc/data/blocks/ss_factor" in fp
        assert "vmc-proc-ID0/vmc/data/blocks/one_body_dm" in fp
    theirs = jio.VmcHDF5FileHandler(str(workdir / "vmc-out.h5"),
                                    "vmc-proc-ID0").load()
    assert theirs.proc.num_walkers == 8
    assert np.isfinite(theirs.data.blocks.energy.mean)


def test_proc_template_and_start(workdir):
    result = _invoke("dmc", ["proc-template", "dmc-template.yml.j2", "-o",
                             "run.yml"])
    assert result.exit_code == 0, result.output
    assert "Output file successfully saved" in result.output
    rendered = yaml.safe_load((workdir / "run.yml").read_text())
    assert rendered["app_spec"][0]["proc"]["model_spec"]["lattice_depth"] \
        == pytest.approx(9.8696, rel=1e-4)
    # An existing file is kept unless -r is given.
    again = _invoke("dmc", ["proc-template", "dmc-template.yml.j2", "-o",
                            "run.yml"])
    assert again.exit_code != 0 and isinstance(again.exception, IOError)
    assert _invoke("dmc", ["proc-template", "dmc-template.yml.j2", "-o",
                           "run.yml", "-r"]).exit_code == 0
    # Without -o: a dated, hostname-tagged name in the directory.
    assert _invoke("dmc", ["proc-template",
                           "dmc-template.yml.j2"]).exit_code == 0
    assert len(list(workdir.glob("mrbp-dmc-conf_*@*.yml"))) == 1
    result = _invoke("dmc", ["start", "run.yml", "--device", "cpu"])
    assert result.exit_code == 0, result.output
    assert (workdir / "run.h5").exists()


def test_commands_default_to_the_card(workdir):
    if torch.cuda.is_available():
        pytest.skip("this check is of a machine without CUDA")
    result = _invoke("dmc", ["start", "dmc-cli-app-spec.yml"])
    assert result.exit_code != 0
    assert isinstance(result.exception, (RuntimeError, AssertionError))
    assert not (workdir / "test-out-file.h5").exists()
    listing = _invoke("dmc", ["--help"]).output
    for command in ("start", "proc-template", "resume"):
        assert command in listing
    assert "[default: cuda]" in _invoke("dmc", ["start", "--help"]).output


def test_console_scripts_are_declared():
    text = (ROOT / "pyproject.toml").read_text()
    assert 'mrbp-dmc-torch = "phd_qmclib_torch.mrbp_cli:dmc_cli"' in text
    assert 'mrbp-vmc-torch = "phd_qmclib_torch.mrbp_cli:vmc_cli"' in text
    assert callable(mrbp_cli.dmc_cli) and callable(mrbp_cli.vmc_cli)


# -- continuation runs ------------------------------------------------------------

def test_continuation_run_advances_block_offset(workdir):
    assert _invoke("dmc", ["start", "dmc-cli-app-spec.yml", "--device",
                           "cpu"]).exit_code == 0
    raw = yaml.safe_load((workdir / "dmc-cli-app-spec.yml").read_text())
    stanza = raw["app_spec"][0]
    stanza["proc_input"] = {"type": "HDF5_FILE",
                            "location": "./test-out-file.h5",
                            "group": "dmc-proc-ID0"}
    stanza["proc_output"]["location"] = "./restart-out.h5"
    (workdir / "restart.yml").write_text(yaml.safe_dump(raw))
    app = cli_app.CLIApp.from_config(
        tconfig.Loader().load(workdir / "restart.yml"), "dmc")
    proc, proc_input = app.app_spec[0].build_input(device="cpu")
    # 1 burn-in + 4 blocks consumed from offset 0.
    assert app.app_spec[0].proc.block_offset == 0
    assert proc.block_offset == 5
    assert proc_input.resume is None
    assert _invoke("dmc", ["start", "restart.yml", "--device",
                           "cpu"]).exit_code == 0
    first = jio.DmcHDF5FileHandler(str(workdir / "test-out-file.h5"),
                                   "dmc-proc-ID0").load()
    second = jio.DmcHDF5FileHandler(str(workdir / "restart-out.h5"),
                                    "dmc-proc-ID0").load()
    assert (first.proc.block_offset, second.proc.block_offset) == (0, 5)
    # A third run, from the second, goes on from there.
    stanza["proc_input"]["location"] = "./restart-out.h5"
    (workdir / "third.yml").write_text(yaml.safe_dump(raw))
    app3 = cli_app.CLIApp.from_config(
        tconfig.Loader().load(workdir / "third.yml"), "dmc")
    assert app3.app_spec[0].build_input(device="cpu")[0].block_offset == 10
    # An explicit, larger offset is kept; another seed needs none.
    spec = app.app_spec[0]
    keep = replace(spec, proc=spec.proc.evolve({"block_offset": 40}))
    assert keep._continuation_proc(first.proc).block_offset == 40
    other = replace(spec, proc=spec.proc.evolve({"rng_seed": 5}))
    assert other._continuation_proc(first.proc).block_offset == 0


# -- resume -----------------------------------------------------------------------

class _Killed(RuntimeError):
    pass


@pytest.mark.parametrize("sampling_type", ("dmc", "vmc"))
def test_resume_command_finishes_a_killed_run(workdir, sampling_type):
    name = f"{sampling_type}-cli-app-spec.yml"
    config = tconfig.Loader().load(workdir / name)
    config["app_spec"][0]["proc"].update(checkpoint_file="ck.h5",
                                         checkpoint_every=1)
    app = cli_app.CLIApp.from_config(config, sampling_type)
    proc, start = app.app_spec[0].build_input(device="cpu")
    whole = proc.evolve({"checkpoint_file": None}).exec(start)

    def hook(resume_input):
        if resume_input.resume["blocks_completed"] == 2:
            raise _Killed

    with pytest.raises(_Killed):
        proc.exec(start, checkpoint_hook=hook)
    result = _invoke(sampling_type, ["resume", "ck.h5", "resumed.h5",
                                     "--no-checkpointing", "--device",
                                     "cpu"])
    assert result.exit_code == 0, result.output
    assert f"Resuming at block 2/{proc.num_blocks}" in result.output
    handler = (tio.DmcHDF5FileHandler if sampling_type == "dmc"
               else tio.VmcHDF5FileHandler)
    resumed = handler(str(workdir / "resumed.h5"), "resumed").load(
        device="cpu")
    assert_same(resumed.data, whole.data)
    assert torch.equal(resumed.state.pos, whole.state.pos)
    bad = _invoke(sampling_type, ["resume", name, "x.h5", "--device",
                                  "cpu"])
    assert bad.exit_code != 0
    assert f"not a readable {sampling_type} checkpoint" in bad.output


# -- the shipped examples -----------------------------------------------------------

#: What ``Proc.evolve`` cuts of the production example for a CPU: the
#: system's size, the walkers and the depth, and with them the cadence
#: that a 32-step block can hold.  Every estimator, the light checkpoint
#: and both handlers stay as shipped.
DMC_EXAMPLE_CUT = {
    "model_spec": {"boson_number": 8, "supercell_size": 8.0},
    "max_num_walkers": 96, "target_num_walkers": 64, "num_blocks": 2,
    "burn_in_blocks": 1, "num_time_steps_block": 32, "est_every": 1,
    "ssf_spec": {"pfw_num_time_steps": 32}, "checkpoint_every": 1,
    "cm_diffusion_spec": tdmc.CMDiffusionEstSpec(window_blocks=2),
    "dtype": "float64",
}


def test_dmc_production_example_runs_through_the_application(tmp_path):
    shutil.copy(EXAMPLES / "dmc_production.yml", tmp_path)
    config = tconfig.Loader().load(tmp_path / "dmc_production.yml")
    assert config == jconfig.Loader().load(tmp_path / "dmc_production.yml")
    app = cli_app.CLIApp.from_config(config, "dmc")
    spec = app.app_spec[0]
    assert spec.proc.checkpoint_file == str(
        tmp_path / "dmc_production.ckpt.h5")
    assert spec.proc.checkpoint_light and spec.proc.itc_spec.as_pure_est
    assert isinstance(spec.proc_input, ModelSysConfSpec)
    cut = replace(app, app_spec=[replace(
        spec, proc=spec.proc.evolve(DMC_EXAMPLE_CUT))])
    (result,) = cut.exec(device="cpu")
    blocks = result.data.blocks
    for name in ("density", "ss_factor", "one_body_dm", "cm_diffusion",
                 "pair_corr", "itc"):
        assert getattr(blocks, name) is not None, name
    assert blocks.density.mean.sum() == pytest.approx(8.0, rel=1e-12)
    assert np.isfinite(blocks.energy.mean)
    loaded = jio.DmcHDF5FileHandler(str(tmp_path / "dmc_production.h5"),
                                    "run1").load()
    assert_same(loaded.data, result.data)
    # The light checkpoint after the last block resumes to the result.
    with h5py.File(tmp_path / "dmc_production.ckpt.h5", "r") as fp:
        assert "itc_buf" not in fp["checkpoint/dmc/state"]
        assert fp["checkpoint/dmc/resume"].attrs["blocks_completed"] == 2
    proc, resume_input = tdmc.Proc.restore_checkpoint(
        str(tmp_path / "dmc_production.ckpt.h5"), device="cpu")
    assert_same(proc.exec(resume_input).data, result.data)


def test_vmc_example_runs_through_the_application(tmp_path):
    shutil.copy(EXAMPLES / "vmc_variational.yml", tmp_path)
    config = tconfig.Loader().load(tmp_path / "vmc_variational.yml")
    app = cli_app.CLIApp.from_config(config, "vmc")
    spec = app.app_spec[0]
    assert spec.proc_input.dist_type == "REGULAR"
    cut = replace(app, app_spec=[replace(spec, proc=spec.proc.evolve({
        "model_spec": {"boson_number": 8, "supercell_size": 8.0},
        "num_walkers": 16, "num_blocks": 2, "burn_in_blocks": 1,
        "num_steps_block": 64, "checkpoint_every": 1,
        "dtype": "float64"}))])
    (result,) = cut.exec(device="cpu")
    assert (tmp_path / "vmc_variational.ckpt.h5").exists()
    loaded = jio.VmcHDF5FileHandler(str(tmp_path / "vmc_variational.h5"),
                                    "run1").load()
    assert_same(loaded.data, result.data)
    assert result.data.blocks.one_body_dm.mean[0] == pytest.approx(1.0)


# -- refused by name ----------------------------------------------------------------

def test_unsupported_stanzas_raise_by_name(workdir):
    base = tconfig.Loader().load(workdir / "dmc-cli-app-spec.yml")
    # fused_sweep runs as in the JAX package; fused_sweep_mesh fails the
    # JAX package's checks, and a valid one (a sweep over R x W ranks)
    # parses (it runs in tests/test_torch_mesh_proc.py).
    assert cli_app.CLIApp.from_config(dict(base, fused_sweep=True),
                                      "dmc").fused_sweep
    with pytest.raises(ValueError, match="fused_sweep_mesh needs"):
        cli_app.CLIApp.from_config(dict(base, fused_sweep_mesh=[2, 2]),
                                   "dmc")
    meshed = cli_app.CLIApp.from_config(
        dict(base, fused_sweep=True, fused_sweep_mesh=[2, 2]), "dmc")
    assert meshed.fused_sweep and meshed.fused_sweep_mesh == (2, 2)
    # Switched off, the key is accepted.
    app = cli_app.CLIApp.from_config(dict(base, fused_sweep=False), "dmc")
    assert app.meta.tags == "#qmc - #dmc - #multi-rods"
    assert app.app_spec[0].proc_id == 101
    # A wf_opt stanza with neither a VMC proc nor a stored result: the
    # JAX package's TypeError.
    wf_opt = dict(base, app_spec=[{"proc_type": "wf_opt"}] + base["app_spec"])
    with pytest.raises(TypeError, match="needs either a VMC proc"):
        cli_app.CLIApp.from_config(wf_opt, "dmc")
    with pytest.raises(TypeError, match="unknown handler type"):
        cli_app.get_io_handler({"type": "FTP"}, "dmc")
    stanza = dict(base["app_spec"][0],
                  proc_output={"type": "MODEL_SYS_CONF"})
    with pytest.raises(TypeError, match="single accepted output"):
        cli_app.AppSpec.from_config(stanza, "dmc")
    assert isinstance(cli_app.get_io_handler(
        {"type": "HDF5_FILE", "location": "a.h5", "group": "g"}, "vmc"),
        tio.VmcHDF5FileHandler)
    assert cli_app.AppMeta.from_config({"tags": "plain"}).tags == "plain"


# -- the config dicts of chip_smoke.py ----------------------------------------------

def _example_proc(name):
    raw = yaml.safe_load((EXAMPLES / name).read_text())
    return raw["app_spec"][0]["proc"]


@pytest.mark.parametrize("name,mod,attr", (
    ("dmc_production.yml", tdmc, "PRODUCTION_PROC"),
    ("vmc_variational.yml", tvmc, "VARIATIONAL_PROC")))
def test_chip_smoke_dicts_are_the_examples(name, mod, attr):
    """A GPU machine need not have PyYAML: ``chip_smoke.py`` carries the
    examples' ``proc`` stanzas as dicts.  They equal the files key for
    key but for the checkpoint keys, which they leave out; the depth keys
    they carry are the files' too."""
    import chip_smoke

    ours = getattr(chip_smoke, attr)
    example = _example_proc(name)
    checkpoint_keys = {k for k in chip_smoke.PROC_DEPTH_KEYS
                       if k.startswith("checkpoint")}
    assert "checkpoint_file" in example
    assert set(ours) == set(example) - checkpoint_keys
    example = {k: v for k, v in example.items() if k not in checkpoint_keys}
    # Through the procedure: YAML 1.1 reads 1e-3 as a string.
    assert mod.Proc.from_config(ours) == mod.Proc.from_config(example)
    assert mod.Proc.from_config(ours).as_config() \
        == mod.Proc.from_config(example).as_config()
    for key in ("num_blocks", "burn_in_blocks"):
        assert ours[key] == example[key]


@pytest.mark.parametrize("row", range(4))
def test_chip_smoke_eos_dicts_are_the_example(row):
    """Phase S1 runs ``examples/eos_fused_sweep.yml`` from dicts: each
    row's ``proc`` stanza (anchors and merge keys resolved) equal to the
    file's, key for key and through the procedure."""
    import chip_smoke

    raw = yaml.safe_load((EXAMPLES / "eos_fused_sweep.yml").read_text())
    assert raw["fused_sweep"] is True and len(raw["app_spec"]) == 4
    example = raw["app_spec"][row]["proc"]
    ours = chip_smoke.EOS_PROCS[row]
    assert set(ours) == set(example)
    assert tdmc.Proc.from_config(ours) == tdmc.Proc.from_config(example)
    assert tdmc.Proc.from_config(ours).as_config() \
        == tdmc.Proc.from_config(example).as_config()


def test_chip_smoke_production_dict_is_g3s_sampling():
    """R1 holds ``Proc.exec`` against G3: the two must be one sampling
    once R1 has set its listed keys (an unset forward-walking window is a
    procedure's one block)."""
    import chip_smoke

    assert set(chip_smoke.R1_SAMPLING_KEYS) == {
        "num_walkers_control_factor", "cm_diffusion_spec"}
    proc = tdmc.Proc.from_config(chip_smoke.PRODUCTION_PROC).evolve({
        "num_walkers_control_factor": 0.125})
    got, want = proc.sampling, chip_smoke.bench_sampling(
        **chip_smoke.G3_ESTIMATORS)
    assert got.model_spec == want.model_spec
    for name in ("time_step", "max_num_walkers", "target_num_walkers",
                 "num_walkers_control_factor", "rng_seed", "est_every",
                 "cm_diffusion_est", "cm_window_blocks", "ref_compat"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("density_est_spec", "ssf_est_spec", "obd_est_spec",
                 "pair_corr_est_spec", "itc_est_spec"):
        ours, theirs = getattr(got, name), getattr(want, name)
        assert (ours.pfw_num_time_steps or 512) == \
            (theirs.pfw_num_time_steps or 512) == 512, name
        assert replace(ours, pfw_num_time_steps=None) \
            == replace(theirs, pfw_num_time_steps=None), name
    bench = tdmc.Proc.from_config(chip_smoke.BENCH_PROC)
    assert bench.sampling == chip_smoke.bench_sampling()
    assert (bench.num_blocks, bench.burn_in_blocks) == (2, 6)
