"""The yardstick's arithmetic on synthetic inputs: the device's busy
time as the union of its intervals, the idle gaps named by the host's
work, launches per step, the kernels' rooflines and the rates."""
import math
import types

import pytest

import cells
import run
import yardstick
from conftest import ROOT


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = [
    # Two kernels that overlap, a copy, and a host op over the gap
    # between them; a runtime call inside the host op.
    _event("kernel", "void pair_energy_drift_kernel<float, false>(x)", 100, 40),
    _event("kernel", "void other_kernel<float>(y)", 120, 40),
    _event("gpu_memcpy", "Memcpy DtoH", 200, 10),
    _event("cpu_op", "aten::mul", 150, 60),
    _event("cuda_runtime", "cudaLaunchKernel", 170, 5),
    _event("cpu_op", "aten::add", 60, 20),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
]


def test_busy_is_the_union_and_idle_is_named_by_the_host():
    trace = yardstick.reduce_trace(TRACE, steps=2)
    # Window: the host's first event (60) to the copy's end (210).
    assert trace["window_s"] == pytest.approx(150e-6)
    # Union of [100, 160] and [200, 210].
    assert trace["busy_s"] == pytest.approx(70e-6)
    assert trace["launches"] == 3
    gaps = dict(trace["idle_gaps"])
    # [60, 100]: aten::add covers 20 of it; [160, 200]: aten::mul 40.
    assert gaps["aten::mul"] == pytest.approx(40e-6)
    assert gaps["aten::add"] == pytest.approx(40e-6)
    ops = dict(trace["device_ops"])
    assert ops["void pair_energy_drift_kernel<float, false>"] == \
        pytest.approx(40e-6)


def test_readers_on_a_synthetic_trace():
    cell = cells.load_cell(ROOT, "dmc-n128-bare")
    trace = yardstick.reduce_trace(TRACE, steps=2)
    idle = cells.load_reader("device_idle_pct.dmc")(trace, cell)
    assert idle == pytest.approx(100 * (1 - 70 / 150))
    assert cells.load_reader("launches_per_step.dmc")(trace, cell) == 1.5
    k1 = cells.load_reader("k1_roofline")(trace, cell)
    bound_s = 17408 * 128 * 127 // 2 * 28 / 67e12
    assert k1 == pytest.approx(100 * bound_s / 20e-6)
    # No log|psi| instantiation ran: that reader reads nothing.
    assert cells.load_reader("k1_log_roofline")(trace, cell) is None


def test_readers_read_nothing_without_device_work():
    cell = cells.load_cell(ROOT, "vmc-n64-sk")
    empty = yardstick.reduce_trace([_event("cpu_op", "aten::mul", 0, 5)], 4)
    for metric in ("device_idle_pct.vmc", "launches_per_step.vmc",
                   "k1_log_roofline"):
        assert cells.load_reader(metric)(empty, cell) is None


def test_k1_bound_is_the_flop_bound_at_the_bench_shapes():
    assert yardstick.k1_bound(17408, 128, False)["bound_ms"] == \
        pytest.approx(0.059131, rel=1e-4)
    assert yardstick.k1_bound(16384, 64, True)["bound_ms"] == \
        pytest.approx(0.019719, rel=1e-4)
    assert yardstick.bound(0, 3.35e12)["bound_by"] == "bytes"


@pytest.mark.parametrize("workload,metric", [
    ("dmc-n128-bare", "walker_steps_per_s"),
    ("vmc-n64-sk", "chain_steps_per_s")])
def test_rates_count_the_target_walkers_over_the_whole_window(workload,
                                                              metric):
    cell = cells.load_cell(ROOT, workload)
    window = types.SimpleNamespace(steps=3 * 512, seconds=2.0,
                                   memory_peak_bytes=3 << 30)
    values = run.end_to_end(cell, window, setup_s=12.5)
    assert values[metric]["value"] == pytest.approx(16384 * 3 * 512 / 2.0)
    assert values["setup_s"]["value"] == 12.5
    assert values[metric]["unit"] in ("walker-steps/s", "chain-steps/s")


def test_peak_memory_in_gib():
    cell = cells.load_cell(ROOT, "dmc-n128-production")
    window = types.SimpleNamespace(steps=512, seconds=1.0,
                                   memory_peak_bytes=3 << 30)
    assert run.end_to_end(cell, window, 1.0)["peak_mem_gib"]["value"] == 3.0
    assert not math.isnan(run.end_to_end(cell, window, 1.0)[
        "walker_steps_per_s"]["value"])


def test_the_control_rounds_every_result_to_tf32():
    import torch

    import control

    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + 1.5 * ulp, 1 + 0.49 * ulp, -3.0,
                      1e-30], dtype=torch.float32)
    # Ties go to the even mantissa; values off the 10-bit grid round
    # to the nearest; those on it stay.
    assert control.tf32_round(x).tolist() == pytest.approx(
        [1.0, 1 + 2 * ulp, 1.0, -3.0, 1e-30], rel=ulp)
    a = torch.full((3,), 1.0)
    with control.TF32():
        b = a + ulp / 4
        c = torch.zeros(3).add_(1 + 3 * ulp / 4)
        d = b.view(3, 1)
    assert b.tolist() == [1.0] * 3
    assert c.tolist() == [1 + ulp] * 3
    assert d.data_ptr() == b.data_ptr()
