"""Readings of the check's numbers for many seeds, and of its control.

    python3 portbench/control.py --workload NAME --seeds N [N ...]
        [--seconds S] [--out FILE]

For each seed it sets the cell up and runs a short window as
``run.py`` does, then judges twice what the window recorded: once the
program's own outputs (the readings that set each number's lower end),
and once the control's, the plain reference put in the program's place
and computed in TF32, the precision next below the configuration's
float32 (which runs with TF32 off), from the same inputs (the readings
that set the upper end).  The reference has no matrix product for the
card's TF32 mode to take, so the control computes in float32 and rounds
every result to TF32's 10-bit mantissa (:class:`TF32`): float32's range,
TF32's precision, in every operation.  Every number of both, per seed,
goes to standard output as one JSON line.  The benchmark's own runs
never run the control.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_map  # noqa: E402

import cells  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402
from reference import dmc as dmc_ref, vmc as vmc_ref  # noqa: E402
from reference.model import Model  # noqa: E402

CONTROL_DTYPE = torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest value with TF32's 10-bit
    mantissa, ties to even."""
    bits = x.view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & -0x2000
    return bits.view(torch.float32)


class TF32(TorchDispatchMode):
    """While installed, every float32 result of an operation is rounded
    to TF32: a new tensor as it is returned, one written in place where
    it is written.  A view is left as it is: it shows what was rounded
    when it was made."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {a.untyped_storage().data_ptr()
                  for a in (list(args) + list(kwargs.values()))
                  if isinstance(a, torch.Tensor)}
        mutable = func._schema.is_mutable

        def round_(t):
            if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
                return t
            if t.untyped_storage().data_ptr() not in inputs:
                return tf32_round(t)
            if mutable:
                t.copy_(tf32_round(t))
            return t

        return tree_map(round_, out)


def _dmc_control(cell, model, record, seed, block_index, t, device):
    """A DMC record whose outputs are the control's, from the program's
    inputs."""
    proc, tproc = cell.config["proc"], cell.traffic["proc"]
    spb = cell.steps_per_block
    dt = float(proc["time_step"])
    state_in = record["in"]
    low = dmc_ref.step(model, proc, state_in, seed, block_index, t, spb,
                       CONTROL_DTYPE, device, comb_dtype=CONTROL_DTYPE)
    valid = low["valid"]
    energies, drift = model.energy_drift(low["pos"])
    ref_before = state_in["ref_energy"].to(device, CONTROL_DTYPE)
    out = {"pos": low["pos"], "energies": energies, "drift": drift,
           "weights": dmc_ref.weights(energies, low["cenergy"], ref_before,
                                      valid, dt),
           "masks": ~valid,
           "num_walkers": torch.tensor(low["num_walkers"]),
           "energy": low["energy"], "weight": torch.tensor(low["weight"]),
           "total_energy": low["total_energy"],
           "total_weight": low["total_weight"],
           "accum_energy": low["accum_energy"],
           "ref_energy": low["ref_energy"]}
    if "cmd_accum" in low:
        out["cmd_accum"] = low["cmd_accum"]
    control = {"in": state_in, "out": out, "parent": low["parent"]}
    est = record.get("est")
    if est is not None:
        rows, buf, filled = dmc_ref.estimate(model, tproc, est, low,
                                             CONTROL_DTYPE, device)
        control["est"] = dict(est, rows=rows, itc_buf_out=buf,
                              itc_filled_out=filled)
    return control


def _vmc_control(cell, model, record, seed, block_index, t, device):
    """A VMC record whose outputs are the control's, from the program's
    inputs."""
    tproc = cell.traffic["proc"]
    state_in = {name: value.to(device) for name, value in
                record["in"].items()}
    low_in = {name: value.to(CONTROL_DTYPE) if value.is_floating_point()
              else value for name, value in state_in.items()}
    prop, u = vmc_ref.proposal(model, tproc, state_in["pos"], seed,
                               block_index, t, cell.steps_per_block,
                               state_in["pos"].dtype, CONTROL_DTYPE, device)
    lp_prop = model.log_psi(prop)
    energy_prop, _ = model.energy_drift(prop)
    accept = lp_prop > 0.5 * torch.log(u.to(CONTROL_DTYPE)) \
        + low_in["wf_abs_log"]
    out = {"pos": torch.where(accept[:, None], prop, low_in["pos"]),
           "wf_abs_log": torch.where(accept, lp_prop, low_in["wf_abs_log"]),
           "energy": torch.where(accept, energy_prop, low_in["energy"]),
           "move_stat": accept}
    for name in ("ssf", "obd"):
        field = f"{name}_parts"
        if field in low_in:
            shape = (-1,) + (1,) * (low_in[field].dim() - 1)
            out[field] = torch.where(
                accept.view(shape),
                model.walker_estimator(name, prop, tproc[f"{name}_spec"]),
                low_in[field])
    control = {"in": record["in"], "out": out}
    if "rows" in record:
        control["rows"] = {
            name: model.walker_estimator(name, out["pos"],
                                         tproc[f"{name}_spec"]).sum(0)
            for name in record["rows"]}
    return control


def control_readings(cell, model, seed, block_offset, start, records,
                     device) -> judge.Readings:
    """The check's numbers with the control in the program's place."""
    pos = start["pos"].to(device, CONTROL_DTYPE)
    with TF32():
        if cell.sampler == "dmc":
            energies, drift = model.energy_drift(pos)
            start = dict(start, energies=energies, drift=drift)
            make = _dmc_control
        else:
            energy, _ = model.energy_drift(pos)
            start = dict(start, energy=energy,
                         wf_abs_log=model.log_psi(pos))
            make = _vmc_control
    spb = cell.steps_per_block
    controls = {}
    for k, record in records.items():
        block, t = divmod(k, spb)
        with TF32():
            controls[k] = make(cell, model, record, seed,
                               block_offset + block, t, device)
    return judge.judge(cell, model, seed, block_offset, start, controls, 0,
                       device)


def readings_for_seed(cell, seed: int, seconds: float, device) -> dict:
    run = harness.set_up(cell, seed, seconds, device)
    window = harness.run_window(run, device, False)
    start, block_offset = run.start, run.warm_blocks
    del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    model = Model(cell.config["proc"]["model_spec"])
    program = judge.judge(cell, model, seed, block_offset, start,
                          window.records, window.handoff, device)
    control = control_readings(cell, model, seed, block_offset, start,
                               window.records, device)
    return {"seed": seed, "program": dict(program),
            "control": dict(control), "window_s": window.seconds,
            "blocks": window.num_blocks}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    cell = cells.load_cell(HERE.parent, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines = []
    for seed in args.seeds:
        line = json.dumps(dict(readings_for_seed(cell, seed, args.seconds,
                                                 device),
                               workload=args.workload))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
