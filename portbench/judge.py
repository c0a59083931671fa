"""The comparison that decides ``correct``.

The plain reference (``reference/``) follows the program one step at a
time from the program's own state, at the steps :mod:`capture` recorded,
and each number below is the widest gap between what the program
produced there and what the reference works out, in float64 on the
card:

* ``start_gap``: the energies and drift (DMC) or log|psi| and energies
  (VMC) that the program's set-up computed for the walkers the harness
  made, against the reference's, relative to the mean |E| (|log psi|);
* ``comb_mismatches`` (DMC): children whose parent differs, plus the
  difference of the walker counts and of the masks: exact;
* ``decision_gap`` (VMC): the widest margin ``log|psi'| - log(u)/2 -
  log|psi|`` by which a chain's accept or reject went against the
  reference's;
* ``move_gap``: the widest distance (minimum image, lattice periods)
  between a moved walker and the reference's move of it, over the
  children whose parent is the reference's (one with another parent is
  a comb mismatch, and moved another walker): the noise, the drift term
  and the recast;
* ``energy_gap``, ``drift_gap``, ``logpsi_gap``: the widest gap of each
  walker's value, the reference's taken at the program's positions,
  over the mean |E|, the rms drift and the mean |log psi|;
* ``weight_gap`` (DMC): the widest relative gap of a branching weight,
  over the same children;
* ``ensemble_gap`` (DMC): the widest relative gap of the ensemble sums
  and the controller's energies;
* ``cmd_gap`` (DMC with CM diffusion): the widest gap of a walker's
  centre-of-mass displacement, in lattice periods, over the same
  children;
* ``est_gap.<name>``: an estimator's row (``itc`` with its counts and
  its ring buffer) at a measured step, the widest gap over the row's
  largest magnitude;
* ``handoff_mismatches``: elements of the window's final state that
  differ from the last recorded step's output, and of the first
  recorded step's input that differ from the state set-up handed the
  window: exact.

Gaps over the input state of each recorded step fold into the same
numbers.  A number is the largest over the recorded steps.
"""
import math

import torch

from reference import dmc as dmc_ref, vmc as vmc_ref

__all__ = ["Readings", "judge", "verdict"]


class Readings(dict):
    """Numbers by name, each the largest reading given."""

    def add(self, name: str, value: float):
        value = float(value)
        if math.isnan(value):
            value = math.inf
        self[name] = max(self.get(name, 0.0), value)


def _gap(got, want, scale=None) -> float:
    """The widest ``|got - want|`` over ``scale`` (default: the largest
    ``|want|``); infinite where the shapes differ."""
    if got is None or want is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    if got.numel() == 0:
        return 0.0
    got, want = got.to(want.device).double(), want.double()
    diff = float((got - want).abs().max())
    if scale is None:
        scale = float(want.abs().max())
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def _wrap_gap(got, want, length: float) -> float:
    d = got.to(want.device).double() - want.double()
    d = d - length * torch.round(d / length)
    return float(d.abs().max()) if d.numel() else 0.0


def _mismatches(got, want) -> int:
    if tuple(got.shape) != tuple(want.shape):
        return max(got.numel(), want.numel())
    return int((got.to(want.device) != want).sum())


def _to(record: dict, device, dtype=torch.float64) -> dict:
    out = {}
    for name, value in record.items():
        if isinstance(value, torch.Tensor):
            value = value.to(device)
            if value.is_floating_point():
                value = value.to(dtype)
        out[name] = value
    return out


def judge(cell, model, seed: int, block_offset: int, start: dict,
          records: dict, handoff: int, device) -> Readings:
    """The readings of one run: ``start`` the state set-up built,
    ``records`` the steps :mod:`capture` kept (by the step's index in the
    window), ``handoff`` the mismatches the harness counted."""
    r = Readings()
    r.add("handoff_mismatches", handoff)
    judge_step = _judge_dmc if cell.sampler == "dmc" else _judge_vmc
    _judge_start(cell, model, r, _to(start, device))
    spb = cell.steps_per_block
    for k in sorted(records):
        block, t = divmod(k, spb)
        judge_step(cell, model, r, records[k], seed, block_offset + block,
                   t, spb, device)
    return r


def _judge_start(cell, model, r, start):
    pos = start["pos"]
    if cell.sampler == "dmc":
        valid = ~start["masks"]
        energy, drift = model.energy_drift(pos[valid])
        scale = float(energy.abs().mean())
        r.add("start_gap", _gap(start["energies"][valid], energy, scale))
        r.add("start_gap", _gap(start["drift"][valid], drift,
                                float(drift.pow(2).mean().sqrt())))
    else:
        energy, _ = model.energy_drift(pos)
        log_psi = model.log_psi(pos)
        r.add("start_gap", _gap(start["energy"], energy,
                                float(energy.abs().mean())))
        r.add("start_gap", _gap(start["wf_abs_log"], log_psi,
                                float(log_psi.abs().mean())))


def _energy_drift_gaps(model, r, pos, energies, drift, names):
    """The program's ``energies`` and ``drift`` at its ``pos`` against the
    reference's; returns the reference's energies."""
    ref_e, ref_f = model.energy_drift(pos)
    r.add(names[0], _gap(energies, ref_e, float(ref_e.abs().mean())))
    r.add(names[1], _gap(drift, ref_f, float(ref_f.pow(2).mean().sqrt())))
    return ref_e


def _judge_dmc(cell, model, r, record, seed, block_index, t, spb, device):
    proc, tproc = cell.config["proc"], cell.traffic["proc"]
    dt = float(proc["time_step"])
    state_in = record["in"]
    out = _to(record["out"], device)
    # The input state, as the program holds it.
    valid_in = ~state_in["masks"].to(device)
    in64 = _to(state_in, device)
    _energy_drift_gaps(model, r, in64["pos"][valid_in],
                       in64["energies"][valid_in], in64["drift"][valid_in],
                       ("energy_gap", "drift_gap"))
    ref = dmc_ref.step(model, proc, state_in, seed, block_index, t, spb,
                       torch.float64, device)
    valid = ref["valid"]
    parent = record["parent"].to(device)
    r.add("comb_mismatches",
          abs(int(out["num_walkers"]) - ref["num_walkers"])
          + _mismatches(parent[valid], ref["parent"][valid])
          + _mismatches(out["masks"], ~valid))
    if tuple(out["pos"].shape) != tuple(ref["pos"].shape) \
            or tuple(parent.shape) != tuple(valid.shape) \
            or not bool(valid.any()):
        r.add("move_gap", math.inf)
        return
    # The children the reference moves from the same parent.
    same = valid & (parent == ref["parent"])
    r.add("move_gap", _wrap_gap(out["pos"][same], ref["pos"][same],
                                model.p.length))
    new_e = _energy_drift_gaps(model, r, out["pos"][valid],
                               out["energies"][valid], out["drift"][valid],
                               ("energy_gap", "drift_gap"))
    w = dmc_ref.weights(new_e, ref["cenergy"][valid],
                        in64["ref_energy"], valid[valid], dt)
    kept = same[valid]
    r.add("weight_gap", _gap(out["weights"][valid][kept], w[kept]))
    r.add("weight_gap", float(out["weights"][~valid].abs().max())
          if bool((~valid).any()) else 0.0)
    for name in ("energy", "total_energy", "total_weight", "accum_energy",
                 "weight"):
        want = torch.as_tensor(ref[name]).double().cpu()
        r.add("ensemble_gap", _gap(out[name].reshape(()).cpu(), want))
    r.add("ensemble_gap", _gap(out["ref_energy"].reshape(()).cpu(),
                               torch.as_tensor(ref["ref_energy"]).double()
                               .cpu(), abs(float(ref["accum_energy"]))))
    if "cmd_accum" in ref:
        r.add("cmd_gap", _gap(out["cmd_accum"][same],
                              ref["cmd_accum"][same], 1.0)
              if "cmd_accum" in out else math.inf)
    est = record.get("est")
    if est is None:
        return
    rows, itc_buf, itc_filled = dmc_ref.estimate(model, tproc, est, ref,
                                                 torch.float64, device)
    got = est["rows"]
    for name in set(rows) | set(got):
        key = "est_gap." + ("itc" if name.startswith("itc") else name)
        r.add(key, _gap(got.get(name), rows.get(name)))
    if itc_buf is not None:
        r.add("est_gap.itc", _gap(est["itc_buf_out"].to(device)[valid],
                                  itc_buf[valid]))
        r.add("est_gap.itc", 0.0 if int(est["itc_filled_out"])
              == itc_filled else math.inf)


def _judge_vmc(cell, model, r, record, seed, block_index, t, spb, device):
    tproc = cell.traffic["proc"]
    state_in, out = _to(record["in"], device), _to(record["out"], device)
    draw_dtype = record["in"]["pos"].dtype
    # The input state, as the program holds it.
    lp_in = model.log_psi(state_in["pos"])
    r.add("logpsi_gap", _gap(state_in["wf_abs_log"], lp_in,
                             float(lp_in.abs().mean())))
    prop, u = vmc_ref.proposal(model, tproc, record["in"]["pos"], seed,
                               block_index, t, spb, draw_dtype,
                               torch.float64, device)
    margin = model.log_psi(prop) - (0.5 * torch.log(u.double())
                                    + state_in["wf_abs_log"])
    accepted = out["move_stat"].bool()
    wrong = accepted != (margin > 0)
    r.add("decision_gap", float(margin[wrong].abs().max())
          if bool(wrong.any()) else 0.0)
    expect = torch.where(accepted[:, None], prop, state_in["pos"])
    r.add("move_gap", _wrap_gap(out["pos"], expect, model.p.length))
    ref_e, _ = model.energy_drift(out["pos"])
    lp_out = model.log_psi(out["pos"])
    r.add("energy_gap", _gap(out["energy"], ref_e,
                             float(ref_e.abs().mean())))
    r.add("logpsi_gap", _gap(out["wf_abs_log"], lp_out,
                             float(lp_out.abs().mean())))
    # The every-step mode carries each chain's parts in its state.
    for name in ("ssf", "obd"):
        if out.get(f"{name}_parts") is not None:
            spec = tproc[f"{name}_spec"]
            for state in (out, state_in):
                r.add(f"est_gap.{name}", _gap(
                    state[f"{name}_parts"],
                    model.walker_estimator(name, state["pos"], spec)))
    for name, row in record.get("rows", {}).items():
        want = model.walker_estimator(name, out["pos"],
                                      tproc[f"{name}_spec"]).sum(0)
        r.add(f"est_gap.{name}", _gap(row.to(device), want))


def verdict(readings: Readings, limits: dict):
    """``(correct, checks)``: every limited number read, none above its
    limit and none read without one; ``checks`` pairs each number with
    its limit."""
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and value <= float(limit)
        correct = correct and ok
        checks[name] = {"value": value, "limit": float(limit)}
    for name in readings.keys() - limits.keys():
        # A number read with no limit was never set from readings.
        checks[name] = {"value": readings[name], "limit": None}
        correct = False
    return correct, checks
