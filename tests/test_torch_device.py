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


CALLS = {
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
