"""The reduction of the program's spans: which layer launched each
kernel, copy and set of a ``torch.profiler`` trace, and how long the
host spent in each layer outside the profiler.

The program (``phd_qmclib_torch.utils.tracing``) opens a span at each
layer boundary of its block loop: the block, the sampler's run of a
block's steps, each step, each estimator evaluation.  With its tracing on
it puts them in a running profiler's trace as ``user_annotation``
events, and outside the profiler into in-memory records of host times.
The names below are frozen here, as ``yardstick.py`` freezes its
arithmetic.

* :func:`split` takes the span events out of a trace, so that
  ``yardstick.reduce_trace`` reads the rest exactly as it reads a trace
  without spans (a block span over every idle gap would name them all);
* :func:`reduce_spans` gives, for each span name, its count, its host
  seconds, the device seconds of the work launched inside it (a device
  event is matched to its ``cuda_runtime``/``cuda_driver`` launch by
  ``args.correlation``, the launch to the innermost span around it on
  its thread) and the device's idle seconds while it was the host's
  innermost span;
* :func:`runs` pairs each sampler run of the in-memory records with its
  step count;
* :data:`READINGS` reads a per-layer metric from a trace dict that
  holds both under ``program_spans`` and ``host_spans``; each returns
  ``None`` where its spans are missing.

Nothing here imports the program.
"""
import bisect
import statistics
from collections import defaultdict

import yardstick

__all__ = ["READINGS", "SPANS", "reduce_spans", "runs", "split"]

BLOCK = "qmc_exec.block"
RUN = {"dmc": "samplers.dmc.run", "vmc": "samplers.vmc.run"}
STEP = {"dmc": "samplers.dmc.step", "vmc": "samplers.vmc.step"}
ESTIMATORS = ("estimators.obd", "estimators.ssf", "estimators.g2",
              "estimators.density", "estimators.itc")
SPANS = frozenset((BLOCK,) + tuple(RUN.values()) + tuple(STEP.values())
                  + ESTIMATORS)
#: The categories of a span in a Chrome trace: the host's range, and the
#: device's copy of it, which spans the kernels and is no work.
SPAN_CATS = ("user_annotation", "gpu_user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: The host calls that put a kernel, a copy or a set on the device.
WORK_CALLS = ("LaunchKernel", "Memcpy", "Memset")


def split(events):
    """``(span_events, other_events)``: the program's host spans, and
    every event else with the device's copies of the spans left out."""
    spans, rest = [], []
    for e in events:
        if e.get("cat") in SPAN_CATS and e.get("name") in SPANS:
            if e["cat"] == "user_annotation" and e.get("ph") == "X":
                spans.append(e)
        else:
            rest.append(e)
    return spans, rest


def _nest(spans):
    """Per thread, the spans' parents and the innermost-span timeline:
    ``(parent, timelines)``, ``parent[i]`` the index of span ``i``'s
    parent (``None`` at the top), ``timelines[(pid, tid)]`` sorted
    ``(start, end, i)`` segments in which span ``i`` is the innermost."""
    parent = [None] * len(spans)
    by_thread = defaultdict(list)
    for i, e in enumerate(spans):
        by_thread[(e.get("pid"), e.get("tid"))].append(i)
    timelines = {}
    for thread, members in by_thread.items():
        members.sort(key=lambda i: (float(spans[i]["ts"]),
                                    -float(spans[i]["dur"])))
        segments, stack = [], []   # stack: (end, index) of the open spans
        cursor = float("-inf")     # where the next segment starts
        for i in members + [None]:
            start = float("inf") if i is None else float(spans[i]["ts"])
            while stack and stack[-1][0] <= start:
                end, top = stack.pop()
                if end > cursor:
                    segments.append((cursor, end, top))
                    cursor = end
            if i is None:
                break
            end = start + float(spans[i]["dur"])
            if stack:
                # A child, clipped to its parent (times in whole
                # microseconds may overrun it by one).
                end = min(end, stack[-1][0])
                parent[i] = stack[-1][1]
                if start > cursor:
                    segments.append((cursor, start, stack[-1][1]))
            cursor = start
            stack.append((end, i))
        timelines[thread] = segments
    return parent, timelines


def _innermost(timeline, starts, t):
    """The span innermost at time ``t`` on a thread's timeline, or
    ``None``."""
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and timeline[k][0] <= t < timeline[k][1]:
        return timeline[k][2]
    return None


def reduce_spans(span_events, events) -> dict:
    """The spans of ``span_events`` (:func:`split`'s first list) against
    the other events of the same trace: ``{"spans": {name: {"count",
    "host_s", "device_s", "idle_s"}}, "launches", "unlaunched",
    "outside"}``.  ``device_s`` counts the work launched inside a span,
    its children's included; ``idle_s`` the device's idle time while the
    span was the innermost.  ``unlaunched`` is the device work whose
    launch the trace lacks, ``outside`` the work launched outside every
    span, each ``{"count", "seconds"}``; ``lost`` counts the launches of
    work whose device record the trace lacks (the profiler dropped
    it)."""
    parent, timelines = _nest(span_events)
    starts = {thread: [s[0] for s in tl] for thread, tl in timelines.items()}
    launches = {}
    work_calls = []
    device = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (
                (e.get("pid"), e.get("tid")), float(e["ts"]))
            if any(call in e["name"] for call in WORK_CALLS):
                work_calls.append(e["args"]["correlation"])
        elif cat in yardstick.DEVICE_CATS:
            device.append(e)
    recorded = {e.get("args", {}).get("correlation") for e in device}
    out = {name: {"count": 0, "host_s": 0.0, "device_s": 0.0,
                  "idle_s": 0.0} for name in {e["name"]
                                              for e in span_events}}
    for e in span_events:
        out[e["name"]]["count"] += 1
        out[e["name"]]["host_s"] += float(e["dur"]) * 1e-6
    unlaunched, outside = [0, 0.0], [0, 0.0]
    for e in device:
        seconds = float(e["dur"]) * 1e-6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unlaunched[0] += 1
            unlaunched[1] += seconds
            continue
        thread, t = launch
        i = _innermost(timelines.get(thread, []), starts.get(thread, []), t)
        if i is None:
            outside[0] += 1
            outside[1] += seconds
        while i is not None:
            out[span_events[i]["name"]]["device_s"] += seconds
            i = parent[i]
    # The device's idle gaps against each thread's innermost spans.
    busy = yardstick._union((float(e["ts"]),
                             float(e["ts"]) + float(e["dur"]))
                            for e in device)
    gaps = [(a, b) for a, b in zip([float("-inf")] + [m[1] for m in busy],
                                   [m[0] for m in busy] + [float("inf")])
            if b > a]
    for timeline in timelines.values():
        g = 0
        for start, end, i in timeline:
            while g < len(gaps) and gaps[g][1] <= start:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < end:
                overlap = min(end, gaps[k][1]) - max(start, gaps[k][0])
                out[span_events[i]["name"]]["idle_s"] += overlap * 1e-6
                k += 1
    return {"spans": out, "launches": len(device),
            "lost": sum(c not in recorded for c in work_calls),
            "unlaunched": {"count": unlaunched[0],
                           "seconds": unlaunched[1]},
            "outside": {"count": outside[0], "seconds": outside[1]}}


def runs(records, sampler: str) -> list:
    """``[(host seconds, steps)]`` of each of the sampler's runs among
    the in-memory span records ``(name, index, parent, start_ns,
    end_ns)``: a run's duration and the number of its step spans."""
    run, step = RUN[sampler], STEP[sampler]
    steps = defaultdict(int)
    for r in records:
        if r[0] == step:
            steps[r[2]] += 1
    return [((r[4] - r[3]) * 1e-9, steps[r[1]]) for r in records
            if r[0] == run]


def _host_ms_per_step(sampler):
    def read(trace):
        per_step = [seconds / steps * 1e3
                    for seconds, steps in runs(trace.get("host_spans") or (),
                                               sampler) if steps]
        return statistics.median(per_step) if per_step else None
    return read


def _span(trace, name):
    spans = (trace.get("program_spans") or {}).get("spans", {})
    span = spans.get(name)
    return span if span and span["count"] else None


def _ms_per_eval(name):
    def read(trace):
        span = _span(trace, name)
        return None if span is None \
            else span["device_s"] / span["count"] * 1e3
    return read


def _idle_in_step_pct(trace):
    span = _span(trace, STEP["dmc"])
    if span is None or not trace.get("window_s"):
        return None
    return 100.0 * span["idle_s"] / trace["window_s"]


#: Each per-layer metric that reads the spans: ``read(trace)``, where
#: ``trace`` is ``yardstick.reduce_trace``'s dict of the traced blocks
#: with ``program_spans`` (:func:`reduce_spans` of the same blocks) and
#: ``host_spans`` (the in-memory records of the blocks not traced).
READINGS = {
    "host_ms_per_step.dmc": _host_ms_per_step("dmc"),
    "host_ms_per_step.vmc": _host_ms_per_step("vmc"),
    "idle_in_step_pct.dmc": _idle_in_step_pct,
    "obd_ms_per_eval.dmc": _ms_per_eval("estimators.obd"),
    "obd_ms_per_eval.vmc": _ms_per_eval("estimators.obd"),
    "ssf_ms_per_eval.vmc": _ms_per_eval("estimators.ssf"),
}
