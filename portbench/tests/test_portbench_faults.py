"""The check catches a broken timed path.  Each test drives a whole run
of a cell cut to a CPU's size (set-up, the window through the
execution layer, the capture and the judge; the look for a card is
skipped) with a fault planted in the program's step, and sees
``correct`` come out false; a sound run comes out true, and the
control, the plain reference in TF32 in the program's place, fails.
The DMC cells also see the move broken underneath: the noise at the
width ``sqrt(dt)`` where it is ``sqrt(2 dt)``, and the drift term left
out.  The fault across cards (an exchange left out) has no cell here:
every cell runs on one card."""
import functools
import math

import pytest
import torch

import capture
import control
import judge
import run
from conftest import tiny_cell

from phd_qmclib_torch.samplers import dmc as dmc_sampler, vmc as vmc_sampler

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234
CELLS = ["dmc-n128-production", "dmc-n128-bare", "vmc-n64-sk",
         "vmc-n64-variational"]


def _correct(cell) -> bool:
    result, _ = run.execute(cell, SEED, 0.3, False, CPU, "cpu")
    return result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    assert _correct(tiny_cell(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    cell = tiny_cell(workload, walkers=256, slots=272)
    readings = control.readings_for_seed(cell, SEED, 0.3, CPU)
    correct, _ = judge.verdict(judge.Readings(readings["control"]),
                               cell.limits)
    assert not correct


def _frozen_dmc(step):
    def broken(self, state, *args):
        _, e_prev, branch = step(self, state, *args)
        return state, e_prev, branch
    return broken


def _half_dmc(step):
    """The second half of the slots left out of the move, the ensemble
    energy the mean over the rest."""
    def broken(self, state, *args):
        new, e_prev, branch = step(self, state, *args)
        half = new.pos.shape[1] // 2
        pos, energies = new.pos.clone(), new.energies.clone()
        pos[:, half:] = state.pos[:, half:]
        energies[:, half:] = state.energies[:, half:]
        energy = 2 * torch.where(branch.valid[:, :half],
                                 energies[:, :half], 0.0).sum(-1)
        return new._replace(pos=pos, energies=energies,
                            energy=energy), e_prev, branch
    return broken


def _altered_dmc(step):
    def broken(self, state, *args):
        new, e_prev, branch = step(self, state, *args)
        energies = new.energies.clone()
        energies[:, 0] *= 1.01
        return new._replace(energies=energies), e_prev, branch
    return broken


def _frozen_vmc(step):
    def broken(self, state, *args):
        step(self, state, *args)
        return state
    return broken


def _half_vmc(step):
    def broken(self, state, *args):
        new = step(self, state, *args)
        half = new.pos.shape[1] // 2
        fields = {}
        for name in ("pos", "wf_abs_log", "energy"):
            value = getattr(new, name).clone()
            value[:, half:] = getattr(state, name)[:, half:]
            fields[name] = value
        return new._replace(**fields)
    return broken


def _altered_vmc(step):
    def broken(self, state, *args):
        new = step(self, state, *args)
        log_psi = new.wf_abs_log.clone()
        log_psi[:, 0] += 0.01 * log_psi.abs().mean()
        return new._replace(wf_abs_log=log_psi)
    return broken


FAULTS = {"frozen": (_frozen_dmc, _frozen_vmc),
          "half": (_half_dmc, _half_vmc),
          "altered": (_altered_dmc, _altered_vmc)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(monkeypatch, workload, fault):
    cell = tiny_cell(workload)
    sampler = dmc_sampler if cell.sampler == "dmc" else vmc_sampler
    make = FAULTS[fault][0 if cell.sampler == "dmc" else 1]
    monkeypatch.setattr(sampler.Sampling, "_step",
                        make(sampler.Sampling.__dict__["_step"]))
    assert not _correct(cell)


def _narrow_noise(step):
    """The diffusion's noise at the width ``sqrt(dt)``."""
    def broken(self, state, e_prev_slots, comb_u, xi, consts):
        return step(self, state, e_prev_slots, comb_u, xi / math.sqrt(2.0),
                    consts)
    return broken


def _no_drift(diffuse):
    """The move without its drift term."""
    def broken(self, cpos, cdrift, *args):
        return diffuse(self, cpos, torch.zeros_like(cdrift), *args)
    return broken


MOVE_FAULTS = {"narrow_noise": ("_step", _narrow_noise),
               "no_drift": ("_diffuse", _no_drift)}


@pytest.mark.parametrize("fault", sorted(MOVE_FAULTS))
@pytest.mark.parametrize("workload", CELLS[:2])
def test_a_broken_move_is_not_correct(monkeypatch, workload, fault):
    name, make = MOVE_FAULTS[fault]
    monkeypatch.setattr(dmc_sampler.Sampling, name,
                        make(dmc_sampler.Sampling.__dict__[name]))
    assert not _correct(tiny_cell(workload))


def test_an_altered_estimator_row_is_not_correct(monkeypatch):
    estimate = dmc_sampler.Sampling.__dict__["_estimate"]

    @functools.wraps(estimate)
    def broken(self, *args):
        aux, rows, state = estimate(self, *args)
        if "obd" in rows:
            rows = dict(rows, obd=rows["obd"] * 1.01)
        return aux, rows, state

    monkeypatch.setattr(dmc_sampler.Sampling, "_estimate", broken)
    assert not _correct(tiny_cell("dmc-n128-production"))


def test_a_changed_step_method_is_named(monkeypatch):
    """A step method whose parameters are not those the capture reads
    stops the run with an error that names it."""
    estimate = dmc_sampler.Sampling.__dict__["_estimate"]

    def renamed(self, consts, aux, perm, itc_perm, branch, state, index):
        return estimate(self, consts, aux, perm, itc_perm, branch, state,
                        index)

    monkeypatch.setattr(dmc_sampler.Sampling, "_estimate", renamed)
    with pytest.raises(capture.CaptureError, match="Sampling._estimate"):
        _correct(tiny_cell("dmc-n128-production"))
