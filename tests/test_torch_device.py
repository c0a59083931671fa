"""The port's entry points run on the card unless the caller asks for
the CPU: their ``device`` defaults to ``"cuda"``, and on a host without
CUDA a call that names no device raises instead of running on the CPU.
The plain versions keep the CPU."""
import inspect

import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import pairwise, prng
from phd_qmclib_torch.qmc_exec import cli_app, dmc as dmc_exec, io as io_exec
from phd_qmclib_torch.qmc_exec import vmc as vmc_exec
from phd_qmclib_torch.samplers import dmc, vmc

torch.set_num_threads(1)

ENTRY_POINTS = {
    "dmc.Sampling.build_state": dmc.Sampling.build_state,
    "vmc.Sampling.build_state": vmc.Sampling.build_state,
    "dmc.state_from_numpy": dmc.state_from_numpy,
    "dmc.aux_from_numpy": dmc.aux_from_numpy,
    "vmc.state_from_numpy": vmc.state_from_numpy,
    "pairwise.pack_params": pairwise.pack_params,
    "prng.normal": prng.normal,
    "prng.philox_words": prng.philox_words,
    "mrbp.PhysicalFuncs.from_model_spec":
        mrbp.PhysicalFuncs.from_model_spec,
    "qmc_exec.dmc.ProcInput.from_model_sys_conf_spec":
        dmc_exec.ProcInput.from_model_sys_conf_spec,
    "qmc_exec.vmc.ProcInput.from_model_sys_conf_spec":
        vmc_exec.ProcInput.from_model_sys_conf_spec,
    "qmc_exec.dmc.Proc.restore_checkpoint":
        dmc_exec.Proc.restore_checkpoint,
    "qmc_exec.vmc.Proc.restore_checkpoint":
        vmc_exec.Proc.restore_checkpoint,
    "qmc_exec.io.HDF5FileHandler.load": io_exec.HDF5FileHandler.load,
    "qmc_exec.io.DmcHDF5FileHandler.load_state":
        io_exec.DmcHDF5FileHandler.load_state,
    "qmc_exec.io.VmcHDF5FileHandler.load_state":
        io_exec.VmcHDF5FileHandler.load_state,
    "qmc_exec.cli_app.AppSpec.build_input": cli_app.AppSpec.build_input,
    "qmc_exec.cli_app.AppSpec.exec": cli_app.AppSpec.exec,
    "qmc_exec.cli_app.CLIApp.exec": cli_app.CLIApp.exec,
}
PLAIN = {"prng.normal_plain": prng.normal_plain,
         "prng.philox_words_plain": prng.philox_words_plain}

SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=8, supercell_size=8.0, tbf_contact_cutoff=0.4)


def _default_device(fn):
    return inspect.signature(fn).parameters["device"].default


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    assert _default_device(ENTRY_POINTS[name]) == "cuda"


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_versions_default_to_the_cpu(name):
    assert _default_device(PLAIN[name]) == "cpu"


def _dmc_build(confs, **kw):
    sampling = dmc.Sampling(mrbp.Spec(**SPEC), time_step=1e-2,
                            max_num_walkers=8, target_num_walkers=6,
                            rng_seed=3)
    return sampling.build_state(confs, **kw).pos


def _vmc_build(confs, **kw):
    sampling = vmc.Sampling(mrbp.Spec(**SPEC), move_spread=0.4, rng_seed=3,
                            num_walkers=6)
    return sampling.build_state(confs, **kw).pos


def _proc_input(mod, config):
    def build(confs, **kw):
        proc = mod.Proc.from_config(dict(config, model_spec=SPEC,
                                         rng_seed=3, dtype="float64"))
        return mod.ProcInput.from_model_sys_conf_spec(
            mod.ModelSysConfSpec(), proc, **kw).state.pos
    return build


CALLS = {
    "qmc_exec.dmc.ProcInput.from_model_sys_conf_spec": _proc_input(
        dmc_exec, dict(time_step=1e-2, max_num_walkers=8,
                       target_num_walkers=6)),
    "qmc_exec.vmc.ProcInput.from_model_sys_conf_spec": _proc_input(
        vmc_exec, dict(move_spread=0.4, num_walkers=6)),
    "mrbp.PhysicalFuncs": lambda confs, **kw: mrbp.PhysicalFuncs(
        mrbp.Spec(**SPEC), **kw).energy(confs),
    "dmc.Sampling.build_state": _dmc_build,
    "vmc.Sampling.build_state": _vmc_build,
    "pairwise.pack_params": lambda confs, **kw: pairwise.pack_params(
        mrbp.Spec(**SPEC).cfc_params, torch.float64, **kw),
    "prng.normal": lambda confs, **kw: prng.normal(5, 17, confs.shape, **kw),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_a_call_without_a_device_runs_on_the_card_or_raises(name):
    """No default quietly lands on the CPU: without CUDA the call
    raises; with it, the result lies on the card.  Asked for, the CPU
    still works."""
    confs = np.random.default_rng(0).uniform(0, 8.0, (6, 8))
    call = CALLS[name]
    if torch.cuda.is_available():
        assert call(confs).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call(confs)
    assert call(confs, device="cpu").device.type == "cpu"
