"""Run one cell of the benchmark of ``phd_qmclib_torch`` once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cards the cell asks
for.  It builds the cell's walkers from the seed, warms them by a block,
times one call of the program's execution layer over at least ``S``
seconds, checks what that call produced against the plain reference
(``judge.py``), and prints as its last line one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a profile of whole blocks of the call.  The
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.  It exits non-zero, printing no
result, without the cards, or where JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

import cells  # noqa: E402

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "phd_qmclib_tpu")
GIB = 1 << 30


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def end_to_end(cell, window, setup_s: float) -> dict:
    """The cell's end-to-end metrics, by name."""
    values = {
        "setup_s": setup_s,
        "walker_steps_per_s": cell.walkers * window.steps / window.seconds,
        "chain_steps_per_s": cell.walkers * window.steps / window.seconds,
        "peak_mem_gib": window.memory_peak_bytes / GIB,
    }
    rate = {"dmc": "walker_steps_per_s", "vmc": "chain_steps_per_s"}
    out = {}
    for metric in cell.end_to_end:
        name = metric["name"]
        if name in rate.values() and rate[cell.sampler] != name:
            raise ValueError(f"{name} is not a metric of a "
                             f"{cell.sampler} cell")
        out[name] = {"value": values[name], "unit": metric["unit"]}
    return out


def per_layer(cell, trace) -> dict:
    out = {}
    for metric in cell.per_layer:
        value = cells.load_reader(metric["name"])(trace, cell)
        if value is not None and math.isfinite(value):
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def _finite(value):
    return value if value is not None and math.isfinite(value) else None


def execute(cell, seed: int, seconds: float, traced: bool, device,
            kind: str):
    """One run of ``cell`` on ``device``: ``(result, checks)``, the
    result line's object and the numbers compared with their limits."""
    import harness
    import judge
    from reference.model import Model

    run = harness.set_up(cell, seed, seconds, device)
    window = harness.run_window(run, device, traced)
    setup_s = window.started - T0
    print(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {value:.3f} s" for name, value in run.phases.items())
        + f"; {run.warm_blocks} warm block(s), the last "
        f"{run.block_seconds:.3f} s; window {window.num_blocks} blocks "
        f"in {window.seconds:.3f} s"
        + (f"; traced {window.trace['steps'] // cell.steps_per_block} "
           f"whole block(s)" if window.trace else ""), file=sys.stderr)
    # The program's state goes before the reference runs on the card.
    start, block_offset = run.start, run.warm_blocks
    del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge.judge(cell, Model(cell.config["proc"]["model_spec"]),
                           seed, block_offset, start, window.records,
                           window.handoff, device)
    correct, checks = judge.verdict(readings, cell.limits)
    device_info = {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": window.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed}
    if traced:
        trace = window.trace
        result["metrics"] = per_layer(cell, trace) if trace else {}
        if trace:
            device_info.update(busy_s=trace["busy_s"],
                               window_s=trace["window_s"])
            result["breakdown"] = {"device_ops": trace["device_ops"],
                                   "idle_gaps": trace["idle_gaps"]}
    else:
        result["metrics"] = end_to_end(cell, window, setup_s)
    result["device"] = device_info
    result["checks"] = {name: {"value": _finite(c["value"]),
                               "limit": c["limit"]}
                        for name, c in checks.items()}
    return result, checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = cells.load_cell(HERE.parent, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace),
                             device, torch.cuda.get_device_name(device))
    found = forbidden_modules()
    if found:
        print(f"modules that a run may not load were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
