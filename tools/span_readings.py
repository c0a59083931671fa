"""The program's spans read on the card, cell by cell, with the
benchmark's set-up: the per-layer readings of ``portbench/spans.py``,
and what tracing on costs the window.

    python3 tools/span_readings.py spans --workload W --seed N [--seed M]
        [--seconds S]
    python3 tools/span_readings.py cost --workload W --seed N
        [--seconds S] [--pairs P]

``spans``: for each seed, the cell's set-up as ``portbench/run.py``
makes it (``harness.set_up``), then one ``Proc.exec`` over the window's
blocks with the program's tracing on: the second block under
``torch.profiler`` (its spans go to the trace), the others to memory.
Prints one JSON line a seed: the readings of ``spans.READINGS`` that
apply to the cell's sampler, the yardstick's own readers on the same
block with the span events taken out, the checks of the attribution, and
each span's count, host, device and idle seconds.

``cost``: set-up once, then ``2 P`` windows from the same warmed state,
tracing on (the in-memory sink) and off in turns, on first in the odd
pairs; prints each window's rate and both medians.

Needs a CUDA device.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT)]

import torch  # noqa: E402

import cells  # noqa: E402
import harness  # noqa: E402
import spans  # noqa: E402
import yardstick  # noqa: E402
from phd_qmclib_torch.utils import tracing  # noqa: E402

#: The yardstick's readers, by sampler.
YARDSTICK = {"dmc": ("launches_per_step.dmc", "device_idle_pct.dmc",
                     "k1_roofline"),
             "vmc": ("launches_per_step.vmc", "device_idle_pct.vmc",
                     "k1_log_roofline")}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def window(run, device, profiler=None) -> float:
    """One ``Proc.exec`` over the window's blocks from the warmed state:
    its host seconds."""
    config = run.cell.proc_config(run.seed, run.num_blocks, run.warm_blocks)
    kwargs = {}
    if profiler is not None:
        config["checkpoint_every"] = 1
        kwargs["checkpoint_hook"] = profiler.hook
    proc = run.proc_module.Proc.from_config(config)
    proc_input = run.proc_module.ProcInput(run.state)
    harness._sync(device)
    t0 = time.perf_counter()
    proc.exec(proc_input, **kwargs)
    harness._sync(device)
    return time.perf_counter() - t0


def read_spans(cell, seed: int, seconds: float, device) -> dict:
    run = harness.set_up(cell, seed, seconds, device)
    profiler = harness.BlockProfiler(1, 1, device)
    tracing.enable()
    try:
        wall = window(run, device, profiler)
    finally:
        tracing.disable()
    records, dropped = tracing.take()
    harness.TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = harness.TRACE_DIR / f"spans-{cell.name}-{seed}.json"
    try:
        profiler.prof.export_chrome_trace(str(path))
        events = yardstick.read_chrome_trace(path)
    finally:
        path.unlink(missing_ok=True)
    found, rest = spans.split(events)
    trace = yardstick.reduce_trace(rest, cell.steps_per_block)
    trace["program_spans"] = spans.reduce_spans(found, rest)
    trace["host_spans"] = records
    sampler = cell.sampler
    readings = {name: fn(trace) for name, fn in spans.READINGS.items()
                if name.endswith("." + sampler)}
    yard = {name: cells.load_reader(name)(trace, cell)
            for name in YARDSTICK[sampler]}
    program = trace["program_spans"]
    device_s = sum(k["seconds"] for k in trace["kernels"].values())
    # The wall time of the blocks not profiled (the window's own time
    # holds the profiler's start and stop), a step.
    blocks = [(r.end_ns - r.start_ns) * 1e-6 / cell.steps_per_block
              for r in records if r.name == tracing.BLOCK]
    obd = program["spans"].get("estimators.obd")
    checks = {
        "unlaunched_share": program["unlaunched"]["seconds"]
        / max(device_s, 1e-30),
        "outside_share": program["outside"]["seconds"]
        / max(device_s, 1e-30),
        "lost_launches": program["lost"],
        "obd_share_of_busy": (obd["device_s"] / trace["busy_s"]
                              if obd and trace["busy_s"] else None),
        "block_ms_per_step": (sum(blocks) / len(blocks) if blocks
                              else None),
        "block_ms_per_step_median": (statistics.median(blocks)
                                     if blocks else None),
        "dropped": dropped,
    }
    return {"workload": cell.name, "seed": seed, "blocks": run.num_blocks,
            "window_s": wall, "readings": readings, "yardstick": yard,
            "busy_s": trace["busy_s"], "trace_window_s": trace["window_s"],
            "checks": checks, "program_spans": program}


def cost(cell, seed: int, seconds: float, pairs: int, device) -> dict:
    run = harness.set_up(cell, seed, seconds, device)
    steps = run.num_blocks * cell.steps_per_block
    rates = {"on": [], "off": []}
    for pair in range(pairs):
        order = ("on", "off") if pair % 2 == 0 else ("off", "on")
        for side in order:
            if side == "on":
                tracing.enable()
            try:
                wall = window(run, device)
            finally:
                tracing.disable()
            _, dropped = tracing.take()
            if dropped:
                raise RuntimeError(f"{dropped} spans dropped")
            rates[side].append(cell.walkers * steps / wall)
    return {"workload": cell.name, "seed": seed, "blocks": run.num_blocks,
            "rates": rates,
            "median_on": statistics.median(rates["on"]),
            "median_off": statistics.median(rates["off"]),
            "on_over_off": statistics.median(rates["on"])
            / statistics.median(rates["off"])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=("spans", "cost"))
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, action="append", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--pairs", type=int, default=6)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load_cell(ROOT, args.workload)
    for seed in args.seed:
        if args.mode == "spans":
            line = read_spans(cell, seed, args.seconds, device)
        else:
            line = cost(cell, seed, args.seconds, args.pairs, device)
        line.update(card=card(), torch=torch.__version__)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
