"""The port's report of stored results (``qmc_exec.report``) and its
``analyze`` command against the JAX package's, on the CPU.

The same text and the same JSON for the same file: the four
``tests/fixtures/*.h5`` (written by the upstream library), files the
port writes (DMC with every estimator, VMC, the rows of dt, population
and size sweeps) and a file the JAX package writes; ``sweep_fit_hdf5``
for dt, nw and fs, ``describe_sweep_fit``, ``describe_extrapolated``,
the error texts; ``analyze`` through click's ``CliRunner``, option for
option.
"""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from phd_qmclib_torch import mrbp_cli as tcli
from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.qmc_exec import dmc as tdmc_exec
from phd_qmclib_torch.qmc_exec import io as tio
from phd_qmclib_torch.qmc_exec import report as treport
from phd_qmclib_torch.qmc_exec import vmc as tvmc_exec
from phd_qmclib_tpu import mrbp_cli as jcli
from phd_qmclib_tpu.qmc_exec import io as jio
from phd_qmclib_tpu.qmc_exec import report as jreport

torch.set_num_threads(1)

FIXTURES = sorted((Path(__file__).resolve().parent / "fixtures").glob("*.h5"))


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _both(name, *args, **kwargs):
    """``name`` of both packages' reports: values, or the error text."""
    out = []
    for mod in (treport, jreport):
        try:
            out.append(_quiet(getattr(mod, name), *args, **kwargs))
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
    return out


def _as_json(value) -> str:
    """A summary as JSON text, so that NaN entries compare equal."""
    return json.dumps(value, sort_keys=True, default=str)


def _model(nop=5, sc=None, v0=0.0, gn=1.0):
    return tmrbp.Spec(lattice_depth=v0, lattice_ratio=1.0,
                      interaction_strength=gn, boson_number=nop,
                      supercell_size=float(sc or nop), tbf_contact_cutoff=0.3)


def _dmc(model, seed=7, **kw):
    base = dict(model_spec=model, time_step=2e-3, max_num_walkers=48,
                target_num_walkers=32, num_blocks=4,
                num_time_steps_block=8, burn_in_blocks=1, rng_seed=seed,
                dtype="float64")
    base.update(kw)
    proc = tdmc_exec.Proc(**base)
    return proc.exec(tdmc_exec.ProcInput.from_model_sys_conf_spec(
        tdmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device="cpu"))


def _vmc(model, seed=3, **kw):
    base = dict(model_spec=model, move_spread=0.3, num_blocks=3,
                num_steps_block=16, burn_in_blocks=1, num_walkers=16,
                rng_seed=seed, dtype="float64",
                ssf_spec=tvmc_exec.SSFEstSpec(num_modes=4),
                obd_spec=tvmc_exec.OBDEstSpec(num_pos=4),
                pair_corr_spec=tvmc_exec.PairCorrEstSpec(num_bins=6))
    base.update(kw)
    proc = tvmc_exec.Proc(**base)
    return proc.exec(tvmc_exec.ProcInput.from_model_sys_conf_spec(
        tvmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device="cpu"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Result files the port writes: ``full.h5`` (DMC with every
    estimator, a lattice model), ``vmc.h5`` (its VMC partner), and the
    sweeps: ``dt.h5`` (groups ``dt0..dt2``), ``nw.h5`` (walker targets),
    ``fs.h5`` (sizes at one density)."""
    root = tmp_path_factory.mktemp("report")
    lattice = _model(v0=4.0)
    est = dict(density_spec=tdmc_exec.DensityEstSpec(num_bins=10),
               ssf_spec=tdmc_exec.SSFEstSpec(num_modes=4),
               obd_spec=tdmc_exec.OBDEstSpec(num_pos=4),
               pair_corr_spec=tdmc_exec.PairCorrEstSpec(num_bins=6),
               cm_diffusion_spec=tdmc_exec.CMDiffusionEstSpec(),
               itc_spec=tdmc_exec.ITCEstSpec(num_modes=3, num_lags=4))
    paths = {name: str(root / f"{name}.h5")
             for name in ("full", "vmc", "mixed", "dt", "nw", "fs")}
    mixed = {name: type(spec)(**dict(spec.__dict__, as_pure_est=False))
             for name, spec in est.items()
             if hasattr(spec, "as_pure_est")}
    _quiet(lambda: tio.DmcHDF5FileHandler(paths["full"], "run").dump(
        _dmc(lattice, **est)))
    _quiet(lambda: tio.DmcHDF5FileHandler(paths["mixed"], "run").dump(
        _dmc(lattice, **mixed)))
    _quiet(lambda: tio.VmcHDF5FileHandler(paths["vmc"], "var").dump(
        _vmc(lattice)))
    for i, dt in enumerate((4e-3, 1e-3, 2e-3)):
        _quiet(lambda: tio.DmcHDF5FileHandler(paths["dt"], f"dt{i}").dump(
            _dmc(_model(), seed=7 + i, time_step=dt)))
    for i, target in enumerate((16, 32, 24)):
        _quiet(lambda: tio.DmcHDF5FileHandler(paths["nw"], f"nw{i}").dump(
            _dmc(_model(), seed=9 + i, target_num_walkers=target)))
    for i, nop in enumerate((4, 6, 5)):
        _quiet(lambda: tio.DmcHDF5FileHandler(paths["fs"], f"n{i}").dump(
            _dmc(_model(nop=nop), seed=11 + i)))
    return paths


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A result file the JAX package writes."""
    from phd_qmclib_tpu.models import mrbp as jmrbp
    from phd_qmclib_tpu.qmc_exec import dmc as jdmc_exec

    path = str(tmp_path_factory.mktemp("jaxreport") / "jax.h5")
    proc = jdmc_exec.Proc(
        model_spec=jmrbp.Spec(lattice_depth=4.0, lattice_ratio=1.0,
                              interaction_strength=1.0, boson_number=5,
                              supercell_size=5.0, tbf_contact_cutoff=0.3),
        time_step=2e-3, max_num_walkers=32, target_num_walkers=24,
        num_blocks=3, num_time_steps_block=8, burn_in_blocks=1, rng_seed=4,
        dtype="float64", ssf_spec=jdmc_exec.SSFEstSpec(num_modes=3),
        density_spec=jdmc_exec.DensityEstSpec(num_bins=8))
    result = _quiet(proc.exec, jdmc_exec.ProcInput.from_model_sys_conf_spec(
        jdmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc))
    jio.DmcHDF5FileHandler(path, "jax").dump(result)
    return path


# -- report_hdf5 -----------------------------------------------------------------

@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_report_of_the_fixtures_equals_jax(fixture, as_json):
    ours, theirs = _both("report_hdf5", str(fixture), as_json=as_json)
    assert ours == theirs


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", ["full", "mixed", "vmc", "dt", "fs"])
def test_report_of_port_files_equals_jax(files, name, full):
    ours, theirs = _both("report_hdf5", files[name], full=full)
    assert ours == theirs and "==" in ours
    ours, theirs = _both("report_hdf5", files[name], as_json=True)
    assert ours == theirs
    assert json.loads(ours)


@pytest.mark.parametrize("as_json", [False, True])
def test_report_of_a_jax_file_equals_jax(jax_file, as_json):
    ours, theirs = _both("report_hdf5", jax_file, as_json=as_json)
    assert ours == theirs


def test_report_filters_and_error_texts(files, tmp_path):
    assert treport.find_result_groups(files["dt"]) \
        == jreport.find_result_groups(files["dt"])
    for kw in (dict(group="dt1"), dict(group="nope"),
               dict(sampling_type="vmc")):
        ours, theirs = _both("report_hdf5", files["dt"], **kw)
        assert ours == theirs
    assert _both("report_hdf5", files["dt"], group="nope")[0][0] \
        == "ValueError"
    # A checkpoint-only file: the hint to resume it.
    proc = tdmc_exec.Proc(model_spec=_model(), time_step=2e-3,
                          max_num_walkers=16, target_num_walkers=8,
                          num_blocks=2, num_time_steps_block=4,
                          rng_seed=1, dtype="float64",
                          checkpoint_file=str(tmp_path / "ckpt.h5"),
                          checkpoint_every=1)
    _quiet(proc.exec, tdmc_exec.ProcInput.from_model_sys_conf_spec(
        tdmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device="cpu"))
    ours, theirs = _both("report_hdf5", str(tmp_path / "ckpt.h5"))
    assert ours == theirs and "CHECKPOINT" in ours[1]


def test_summaries_of_results_in_memory_equal_jax(files):
    """``summarize`` and ``describe_*`` on loaded results (a state on the
    CPU; the card's runs report from memory the same way)."""
    dmc = tio.DmcHDF5FileHandler(files["full"], "run").load(device="cpu")
    jdmc = jio.DmcHDF5FileHandler(files["full"], "run").load()
    assert _as_json(_quiet(treport.summarize, dmc, "dmc")) \
        == _as_json(_quiet(jreport.summarize, jdmc, "dmc"))
    assert _quiet(treport.describe_dmc, dmc, full=True) \
        == _quiet(jreport.describe_dmc, jdmc, full=True)
    vmc = tio.VmcHDF5FileHandler(files["vmc"], "var").load(device="cpu")
    jvmc = jio.VmcHDF5FileHandler(files["vmc"], "var").load()
    assert _quiet(treport.describe_vmc, vmc) \
        == _quiet(jreport.describe_vmc, jvmc)


def test_extrapolated_estimators_equal_jax(files):
    pair = (tio.DmcHDF5FileHandler(files["mixed"], "run").load(device="cpu"),
            tio.VmcHDF5FileHandler(files["vmc"], "var").load(device="cpu"))
    jpair = (jio.DmcHDF5FileHandler(files["mixed"], "run").load(),
             jio.VmcHDF5FileHandler(files["vmc"], "var").load())
    assert _as_json(_quiet(treport.summarize_extrapolated, *pair)) \
        == _as_json(_quiet(jreport.summarize_extrapolated, *jpair))
    for full in (False, True):
        assert _quiet(treport.describe_extrapolated, *pair, full=full) \
            == _quiet(jreport.describe_extrapolated, *jpair, full=full)


# -- the sweep fits ----------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("kind", ["dt", "nw", "fs"])
def test_sweep_fit_equals_jax(files, kind, order):
    ours, theirs = _both("sweep_fit_hdf5", files[kind], kind, order=order)
    assert _as_json(ours) == _as_json(theirs)
    if isinstance(ours, dict):
        assert ours["num_points"] == 3
        assert treport.describe_sweep_fit(ours) \
            == jreport.describe_sweep_fit(theirs)


@pytest.mark.parametrize("case", ["too_few", "prefix", "wrong_kind_file"])
def test_sweep_fit_error_texts_equal_jax(files, case):
    args = {"too_few": (files["full"], "dt"),
            "prefix": (files["dt"], "dt"),
            "wrong_kind_file": (files["vmc"], "nw")}[case]
    kw = dict(group_prefix="zz") if case == "prefix" else {}
    ours, theirs = _both("sweep_fit_hdf5", *args, **kw)
    assert ours == theirs and ours[0] == "ValueError"
    assert "needs at least two stored DMC results" in ours[1]


# -- analyze ---------------------------------------------------------------------

ANALYZE = {
    "default": ("dmc", "full", []),
    "full_tables": ("dmc", "full", ["--full"]),
    "group": ("dmc", "dt", ["-g", "dt1"]),
    "json": ("dmc", "full", ["--json"]),
    "dt_fit": ("dmc", "dt", ["--dt-fit"]),
    "dt_fit_json": ("dmc", "dt", ["--dt-fit", "--json"]),
    "dt_fit_prefix": ("dmc", "dt", ["--dt-fit", "-g", "dt"]),
    "dt_fit_order2": ("dmc", "dt", ["--dt-fit", "--dt-fit-order", "2"]),
    "dt_fit_order0": ("dmc", "dt", ["--dt-fit", "--dt-fit-order", "0"]),
    "nw_fit": ("dmc", "nw", ["--nw-fit"]),
    "fs_fit": ("dmc", "fs", ["--fs-fit", "--json"]),
    "no_match": ("dmc", "dt", ["--dt-fit", "-g", "zz"]),
    "extrapolate": ("dmc", "mixed", ["--extrapolate-with", "@vmc"]),
    "extrapolate_json": ("dmc", "mixed", ["--extrapolate-with", "@vmc",
                                          "--vmc-group", "var", "--json"]),
    "vmc": ("vmc", "vmc", []),
    "vmc_dt_fit": ("vmc", "vmc", ["--dt-fit"]),
    "vmc_extrapolate": ("vmc", "vmc", ["--extrapolate-with", "@vmc"]),
    "wrong_group": ("dmc", "full", ["-g", "nope"]),
}


@pytest.mark.parametrize("case", sorted(ANALYZE))
def test_analyze_equals_jax(files, case):
    from click.testing import CliRunner

    kind, name, options = ANALYZE[case]
    options = [files["vmc"] if o == "@vmc" else o for o in options]
    args = ["analyze", files[name], *options]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = CliRunner().invoke(tcli.make_cli(kind), args)
        theirs = CliRunner().invoke(
            jcli.dmc_cli if kind == "dmc" else jcli.vmc_cli, args)
    assert ours.exit_code == theirs.exit_code, ours.output
    assert ours.output == theirs.output
    assert type(ours.exception) is type(theirs.exception)


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_analyze_of_the_fixtures_equals_jax(fixture):
    from click.testing import CliRunner

    kind = "vmc" if "vmc" in fixture.stem else "dmc"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = [CliRunner().invoke(cli, ["analyze", str(fixture), "--json"])
                for cli in (tcli.make_cli(kind),
                            jcli.dmc_cli if kind == "dmc" else jcli.vmc_cli)]
    assert outs[0].exit_code == outs[1].exit_code == 0
    assert outs[0].output == outs[1].output
    assert np.isfinite(json.loads(outs[0].output)[0]["energy_per_particle"]
                       if "energy_per_particle" in json.loads(
                           outs[0].output)[0] else 0.0)
