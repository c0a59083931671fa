"""The reduction of the program's spans on a synthetic Chrome trace: work
is attributed through its launch's correlation to the innermost span
around the launch, idle time to the innermost span on the host, and the
span events leave ``yardstick.reduce_trace``'s reading as it was."""
import pytest

import spans
import yardstick


def _x(cat, name, ts, dur, **args):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": 1, "tid": 1}
    if args:
        event["args"] = args
    return event


def _kernel(name, ts, dur, correlation):
    return dict(_x("kernel", name, ts, dur, correlation=correlation),
                pid=0, tid=7)


BLOCK, RUN, STEP, OBD = (spans.BLOCK, spans.RUN["dmc"], spans.STEP["dmc"],
                         "estimators.obd")
# A block [0, 100) holding a run [10, 90) of two steps [10, 30) and
# [30, 50), then an OBDM evaluation [60, 80).
SPANS = [
    _x("user_annotation", BLOCK, 0, 100),
    _x("user_annotation", RUN, 10, 80),
    _x("user_annotation", STEP, 10, 20),
    _x("user_annotation", STEP, 30, 20),
    _x("user_annotation", OBD, 60, 20),
]
OTHER = [
    # Launched in step 1 (at 12) and step 2 (at 31), in the OBDM
    # evaluation (at 61, 62), in the run between them (at 55), outside
    # every span (at 105); one kernel without its launch.
    _x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
    _kernel("step_kernel_a", 14, 6, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 31, 2, correlation=2),
    _kernel("step_kernel_b", 33, 4, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 55, 1, correlation=3),
    dict(_x("gpu_memset", "Memset", 56, 2, correlation=3), pid=0, tid=7),
    _x("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=4),
    _kernel("obd_kernel", 62, 10, 4),
    _x("cuda_driver", "cuLaunchKernel", 62, 1, correlation=5),
    _kernel("obd_kernel", 72, 10, 5),
    _x("cuda_runtime", "cudaMemcpyAsync", 105, 1, correlation=6),
    dict(_x("gpu_memcpy", "Memcpy DtoH", 106, 3, correlation=6), pid=0,
         tid=7),
    _kernel("orphan_kernel", 95, 1, 99),
    # A launch whose kernel the profiler dropped, and a call that
    # launches nothing.
    _x("cuda_runtime", "cudaLaunchKernel", 84, 1, correlation=7),
    _x("cuda_runtime", "cudaStreamSynchronize", 86, 1, correlation=8),
    _x("cpu_op", "aten::mul", 11, 2),
    # The device's copy of a span: no work.
    dict(_x("gpu_user_annotation", STEP, 14, 6), pid=0, tid=7),
]


def test_split_takes_out_the_spans_and_their_device_copies():
    found, rest = spans.split(SPANS + OTHER
                              + [_x("user_annotation", "mine", 0, 1)])
    assert found == SPANS
    assert all(e["cat"] != "gpu_user_annotation" for e in rest)
    assert _x("user_annotation", "mine", 0, 1) in rest


def test_filtering_the_spans_leaves_the_yardstick_reading_unchanged():
    found, rest = spans.split(SPANS + OTHER)
    assert yardstick.reduce_trace(rest, 2) \
        == yardstick.reduce_trace(OTHER, 2)
    # With them, the block span would name the idle gaps.
    gaps = dict(yardstick.reduce_trace(SPANS + OTHER, 2)["idle_gaps"])
    assert BLOCK in gaps


def test_work_goes_to_the_innermost_span_around_its_launch():
    found, rest = spans.split(SPANS + OTHER)
    out = spans.reduce_spans(found, rest)
    s = out["spans"]
    assert s[STEP]["count"] == 2 and s[OBD]["count"] == 1
    assert s[STEP]["host_s"] == pytest.approx(40e-6)
    assert s[STEP]["device_s"] == pytest.approx(10e-6)
    assert s[OBD]["device_s"] == pytest.approx(20e-6)
    # Inclusive: the run holds its steps, its memset and the evaluation.
    assert s[RUN]["device_s"] == pytest.approx(32e-6)
    assert s[BLOCK]["device_s"] == pytest.approx(32e-6)
    assert out["launches"] == 7
    assert out["lost"] == 1
    assert out["outside"] == {"count": 1, "seconds": pytest.approx(3e-6)}
    assert out["unlaunched"] == {"count": 1,
                                 "seconds": pytest.approx(1e-6)}


def test_idle_goes_to_the_innermost_span_on_the_host():
    found, rest = spans.split(SPANS + OTHER)
    s = spans.reduce_spans(found, rest)["spans"]
    # Busy: [14, 20), [33, 37), [56, 58), [62, 82), [95, 96), [106, 109).
    # Step 1 [10, 30): idle 10 - 6; step 2 [30, 50): 20 - 4.
    assert s[STEP]["idle_s"] == pytest.approx(30e-6)
    # The OBDM [60, 80): idle [60, 62).
    assert s[OBD]["idle_s"] == pytest.approx(2e-6)
    # The run's own time [50, 60) and [80, 90): idle 8 + 8.
    assert s[RUN]["idle_s"] == pytest.approx(16e-6)
    # The block's own time [0, 10) and [90, 100): 10 + 9.
    assert s[BLOCK]["idle_s"] == pytest.approx(19e-6)


def test_a_child_that_overruns_its_parent_is_clipped():
    found = [_x("user_annotation", RUN, 0, 10),
             _x("user_annotation", STEP, 5, 6)]
    s = spans.reduce_spans(found, [])["spans"]
    assert s[STEP]["idle_s"] == pytest.approx(5e-6)
    assert s[RUN]["idle_s"] == pytest.approx(5e-6)


def _records():
    # Two runs of 2 and 3 steps, 4 ms and 3 ms long, under their blocks.
    return [("samplers.vmc.step", 2, 1, 0, 1),
            ("samplers.vmc.step", 3, 1, 1, 2),
            ("samplers.vmc.run", 1, 0, 0, 4_000_000),
            ("qmc_exec.block", 0, None, 0, 5_000_000),
            ("samplers.vmc.step", 6, 5, 0, 1),
            ("samplers.vmc.step", 7, 5, 0, 1),
            ("samplers.vmc.step", 8, 5, 0, 1),
            ("samplers.vmc.run", 5, 4, 0, 3_000_000),
            ("qmc_exec.block", 4, None, 0, 4_000_000)]


def test_runs_pair_each_run_with_its_steps():
    assert spans.runs(_records(), "vmc") == [
        (pytest.approx(4e-3), 2), (pytest.approx(3e-3), 3)]
    assert spans.runs(_records(), "dmc") == []


def test_readings():
    found, rest = spans.split(SPANS + OTHER)
    trace = dict(yardstick.reduce_trace(rest, 2),
                 program_spans=spans.reduce_spans(found, rest),
                 host_spans=_records())
    read = {name: fn(trace) for name, fn in spans.READINGS.items()}
    assert read["host_ms_per_step.vmc"] == pytest.approx((2 + 1) / 2)
    assert read["host_ms_per_step.dmc"] is None
    assert read["obd_ms_per_eval.dmc"] == pytest.approx(20e-3)
    assert read["ssf_ms_per_eval.vmc"] is None
    # Over the yardstick's window: the host's first event that is no
    # span (11) to the copy's end (109).
    assert trace["window_s"] == pytest.approx(98e-6)
    assert read["idle_in_step_pct.dmc"] == pytest.approx(100 * 30 / 98)
    # A trace without the program's spans reads nothing.
    bare = yardstick.reduce_trace(OTHER, 2)
    assert all(fn(bare) is None for fn in spans.READINGS.values())
