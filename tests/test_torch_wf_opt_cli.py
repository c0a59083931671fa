"""The ``proc_type: wf_opt`` stanza of the port's application layer
(``qmc_exec.cli_app.WFOptAppSpec``, ``CLIApp``) on the CPU, against the
JAX package's.

* ``examples/wf_opt_pipeline.yml`` parses like the JAX package parses it,
  and ``chip_smoke.py``'s dicts of it (phase W1) equal the file.
* From one stored VMC result (a file the port writes, which both
  packages read), the stanza gives the JAX stanza's rm* (float64).
* Inline on the CPU, rm* and the orbital v0* reach the DMC stanza after
  it.  (An inline VMC stage cannot be compared with the JAX package's:
  the random streams differ.)
"""
import pathlib

import numpy as np
import pytest
import torch
import yaml

from phd_qmclib_torch.models import mrbp as tmrbp
from phd_qmclib_torch.qmc_exec import (cli_app, config as tconfig,
                                       dmc as tdmc, io as tio, vmc as tvmc)
from phd_qmclib_tpu.qmc_exec import cli_app as jcli_app, config as jconfig

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore")

EXAMPLE = pathlib.Path(__file__).parent.parent / "examples" \
    / "wf_opt_pipeline.yml"
MODEL = {"lattice_depth": 10.0, "lattice_ratio": 1,
         "interaction_strength": 4.0, "boson_number": 8,
         "supercell_size": 8.0, "tbf_contact_cutoff": 1.0}
VMC_PROC = {"model_spec": MODEL, "move_spread": 0.25, "num_blocks": 3,
            "num_steps_block": 64, "burn_in_blocks": 1, "num_walkers": 64,
            "rng_seed": 44, "dtype": "float64"}
DMC_PROC = {"model_spec": MODEL, "time_step": 1e-3, "max_num_walkers": 48,
            "target_num_walkers": 32, "num_blocks": 2,
            "num_time_steps_block": 8, "burn_in_blocks": 0, "rng_seed": 45,
            "dtype": "float64"}


def _stanza_fields(stanza):
    return (stanza.vmc_proc.as_config(), stanza.num_sys_confs,
            stanza.method, stanza.ref_energy, stanza.verbose,
            stanza.opt_obf_lattice_depth, stanza.proc_input.dist_type)


def test_example_pipeline_parses_like_jax(tmp_path):
    (tmp_path / EXAMPLE.name).write_text(EXAMPLE.read_text())
    ours = tconfig.Loader().load(tmp_path / EXAMPLE.name)
    assert ours == jconfig.Loader().load(tmp_path / EXAMPLE.name)
    app = cli_app.CLIApp.from_config(ours, "dmc")
    japp = jcli_app.CLIApp.from_config(ours, "dmc")
    stanza, dmc_spec = app.app_spec
    assert isinstance(stanza, cli_app.WFOptAppSpec)
    assert _stanza_fields(stanza) == _stanza_fields(japp.app_spec[0])
    assert stanza.vmc_proc.num_walkers == 512 and stanza.method == "grad"
    assert dmc_spec.proc.as_config() == japp.app_spec[1].proc.as_config()
    assert dmc_spec.proc_output.location.endswith("wf-opt-dmc-out.h5")


def test_chip_smoke_dicts_are_the_example():
    """``chip_smoke.py`` (W1) carries the pipeline as dicts: the wf_opt
    stanza whole, and the DMC stanza's ``proc``."""
    import chip_smoke

    raw = yaml.safe_load(EXAMPLE.read_text())
    stanza, dmc_stanza = raw["app_spec"]
    assert chip_smoke.WF_OPT_STANZA == stanza
    ours = cli_app.WFOptAppSpec.from_config(chip_smoke.WF_OPT_STANZA)
    assert _stanza_fields(ours) == _stanza_fields(
        cli_app.WFOptAppSpec.from_config(stanza))
    # Through the procedure: YAML 1.1 reads 2.5e-4 as a string.
    assert tdmc.Proc.from_config(chip_smoke.WF_OPT_DMC_PROC).as_config() \
        == tdmc.Proc.from_config(dmc_stanza["proc"]).as_config()
    assert set(chip_smoke.WF_OPT_DMC_PROC) == set(dmc_stanza["proc"])


def test_stanza_from_a_stored_vmc_result_gives_jax_rm(tmp_path):
    """Both packages' stanzas read one stored VMC result (the port's
    file) and agree on rm* (the gradient method; the DE optimum is held
    to JAX's in ``test_torch_wf_opt.py``)."""
    proc = tvmc.Proc.from_config(dict(VMC_PROC))
    result = proc.exec(tvmc.ProcInput.from_model_sys_conf_spec(
        tvmc.ModelSysConfSpec(dist_type="RANDOM"), proc, device="cpu"))
    path = str(tmp_path / "vmc-store.h5")
    tio.VmcHDF5FileHandler(path, group="var").dump(result)
    config = {"proc_type": "wf_opt", "method": "grad", "num_sys_confs": 64,
              "input": {"type": "HDF5_FILE", "location": path,
                        "group": "var"}}
    ours = cli_app.WFOptAppSpec.from_config(config).exec(device="cpu")
    theirs = jcli_app.WFOptAppSpec.from_config(config).exec()
    assert isinstance(ours, tmrbp.Spec)
    np.testing.assert_allclose(ours.tbf_contact_cutoff,
                               theirs.tbf_contact_cutoff, rtol=1e-6)
    assert ours.tbf_contact_cutoff != MODEL["tbf_contact_cutoff"]


def test_inline_pipeline_propagates_rm_and_orbital_depth(tmp_path):
    """VMC -> joint optimization -> DMC on the CPU: both optimized knobs,
    inside their bounds, reach the DMC stanza."""
    config = {"meta": {"name": "wf-opt pipeline"}, "app_spec": [
        {"proc_type": "wf_opt", "method": "grad", "num_sys_confs": 64,
         "opt_obf_lattice_depth": True, "proc": VMC_PROC,
         "input": {"type": "MODEL_SYS_CONF", "dist_type": "RANDOM"}},
        {"proc": DMC_PROC,
         "proc_input": {"type": "MODEL_SYS_CONF", "dist_type": "RANDOM"},
         "proc_output": {"type": "HDF5_FILE",
                         "location": str(tmp_path / "out.h5"),
                         "group": "dmc-at-rm-star"}}]}
    opt_spec, dmc_result = cli_app.CLIApp.from_config(
        config, "dmc").exec(device="cpu")
    lo, hi = 0.05, (0.5 - 5e-3) * MODEL["supercell_size"]
    assert lo <= opt_spec.tbf_contact_cutoff <= hi
    assert MODEL["lattice_depth"] / 8 <= opt_spec.obf_lattice_depth \
        <= 4 * MODEL["lattice_depth"]
    dmc_spec = dmc_result.proc.model_spec
    assert dmc_spec.tbf_contact_cutoff == opt_spec.tbf_contact_cutoff
    assert dmc_spec.obf_lattice_depth == opt_spec.obf_lattice_depth
    assert np.isfinite(dmc_result.data.blocks.energy.mean)
    assert (tmp_path / "out.h5").exists()


def test_stanza_validation_matches_jax():
    bare = {"proc_type": "wf_opt", "input": {"type": "MODEL_SYS_CONF"}}
    with pytest.raises(TypeError) as ours:
        cli_app.WFOptAppSpec.from_config(bare)
    with pytest.raises(TypeError) as theirs:
        jcli_app.WFOptAppSpec.from_config(bare)
    assert str(ours.value) == str(theirs.value)
    assert "stored VMC result" in str(ours.value)
    # A wf_opt stanza cannot ride a fused sweep: the JAX package's text.
    config = {"fused_sweep": True, "app_spec": [
        {"proc_type": "wf_opt", "proc": VMC_PROC}]}
    with pytest.raises(ValueError, match="fused sweep") as ours:
        cli_app.CLIApp.from_config(config, "dmc")
    with pytest.raises(ValueError) as theirs:
        jcli_app.CLIApp.from_config(config, "dmc")
    assert str(ours.value) == str(theirs.value)
