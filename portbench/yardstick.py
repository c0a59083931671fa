"""The yardstick's arithmetic: peaks, bounds, and the reduction of a
``torch.profiler`` Chrome trace.

Frozen here so that the program may change and the yardstick may not.
The peaks, the flop counts and ``bound``/``k1_bound`` are copied from
``chip_smoke.py`` (``PEAK_FP32_FLOPS``, ``PEAK_HBM_BYTES_PER_S``,
``K1_FLOPS_PER_PAIR``, ``K1_LOG_FLOPS_PER_PAIR``, ``F32_BYTES``,
``bound``, ``k1_bound``); the trace reduction takes the idea of
``tools/profile_steps.py`` (device time by kernel, launches per step)
with the busy time as the union of the device's intervals on the trace's
own timeline.
"""
import bisect
import json
from collections import defaultdict

__all__ = ["PEAK_FP32_FLOPS", "PEAK_HBM_BYTES_PER_S", "bound", "k1_bound",
           "read_chrome_trace", "reduce_trace"]

#: Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
#: sheet): FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
#: K1's flops per unordered pair, forward and log|psi|, as the CUDA
#: sources count them (fma = 2, a MUFU op = 1; compares, selects and
#: integer ops not counted, so the bound stays a least time).
K1_FLOPS_PER_PAIR, K1_LOG_FLOPS_PER_PAIR = 28, 40
F32_BYTES = 4
#: The kernels' parameter vector (``pairwise.PARAMS_SIZE``).
PARAMS_SIZE = 16


def bound(flops: float, num_bytes: float) -> dict:
    """The least time the card could take: the larger of the flops over
    the FP32 peak and the bytes (each input read once, each output
    written once) over the HBM rate."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = num_bytes / PEAK_HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return {"bound_ms": ops_ms, "bound_by": "operations",
                "bound_resource": "fp32"}
    return {"bound_ms": bytes_ms, "bound_by": "bytes",
            "bound_resource": "hbm"}


def k1_bound(walkers: int, nop: int, log_psi: bool) -> dict:
    """K1's bound: its unordered pairs' flops; positions and parameters
    in, drift, energy (and log|psi|) out."""
    pairs = walkers * nop * (nop - 1) // 2
    flops = pairs * (K1_LOG_FLOPS_PER_PAIR if log_psi else K1_FLOPS_PER_PAIR)
    values = (2 * walkers * nop + (2 if log_psi else 1) * walkers
              + PARAMS_SIZE)
    return bound(flops, F32_BYTES * values)


#: Chrome-trace categories of work on the device, and of the host's.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: How many entries each list of the breakdown keeps.
TOP = 10


def _union(intervals):
    """Merged ``(start, end)`` intervals, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _host_at(gap, host_events, first: int):
    """The host event that overlaps the gap ``(a, b)`` most, by name; the
    host's events are ``(start, end, name)`` sorted by start, and none
    before index ``first`` reaches the gap."""
    a, b = gap
    best, best_overlap = "no profiled host op", 0.0
    for i in range(first, len(host_events)):
        start, end, name = host_events[i]
        if start >= b:
            break
        overlap = min(end, b) - max(start, a)
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    return best


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 160
    letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.rstrip()[:160]


def reduce_trace(events, steps: int) -> dict:
    """A Chrome trace's events (``ts``, ``dur`` in microseconds) reduced
    to what the per-layer readers take: the window (first to last event
    of host or device), the device's busy time (the union of its
    intervals), its launches (kernels, copies, sets), its time by kernel
    name, and the idle gaps on the device named by the host event that
    overlaps each most, summed by name; ``steps`` is how many steps the
    traced blocks ran."""
    device, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((start, start + dur))
            entry = kernels[e["name"]]
            entry[0] += 1
            entry[1] += dur * 1e-6
        elif cat in HOST_CATS:
            host.append((start, start + dur, e["name"]))
    if not device:
        return {"steps": steps, "launches": 0, "busy_s": 0.0,
                "window_s": 0.0, "kernels": {}, "device_ops": [],
                "idle_gaps": []}
    host.sort()
    merged = _union(device)
    lo = min([merged[0][0]] + [h[0] for h in host])
    hi = max([merged[-1][1]] + [h[1] for h in host])
    gaps = [(a, b) for a, b in zip([lo] + [m[1] for m in merged],
                                   [m[0] for m in merged] + [hi]) if b > a]
    idle = defaultdict(float)
    # The host event lists are long: search only from the gap's start.
    starts = [h[0] for h in host]
    for a, b in gaps:
        first = max(0, bisect.bisect_left(starts, a) - 64)
        idle[_host_at((a, b), host, first)] += (b - a) * 1e-6
    busy = sum(b - a for a, b in merged) * 1e-6
    return {
        "steps": steps, "launches": len(device), "busy_s": busy,
        "window_s": (hi - lo) * 1e-6,
        "kernels": {name: {"count": c, "seconds": s}
                    for name, (c, s) in kernels.items()},
        "device_ops": sorted(([short_name(name), s]
                              for name, (c, s) in kernels.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([name, s] for name, s in idle.items()),
                            key=lambda x: -x[1])[:TOP]}


def read_chrome_trace(path) -> list:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace
