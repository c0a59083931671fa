"""The port's spans (``phd_qmclib_torch.utils.tracing``): off, they cost
one flag test and record nothing; on, a run records one span per block,
per sampler run, per step and per estimator evaluation at its cadence,
in memory or, while a ``torch.profiler`` session records, in its trace;
either way the run's numbers are bit for bit those of a run without."""
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phd_qmclib_torch.qmc_exec import dmc as tdmc, vmc as tvmc
from phd_qmclib_torch.utils import tracing

from .test_torch_exec_utils import MODEL_CONFIG, assert_same

torch.set_num_threads(1)

#: A measured block of 16 steps with every DMC estimator at its own
#: cadence: density and S(k) every 2nd step, the OBDM every 8th, g2
#: every 4th, ITC every 8th.
DMC_CONFIG = dict(
    model_spec=dict(MODEL_CONFIG), time_step="1e-3", max_num_walkers=32,
    target_num_walkers=24, num_blocks=3, num_time_steps_block=16,
    burn_in_blocks=1, rng_seed=5, dtype="float64", est_every=2,
    density_spec={"num_bins": 8}, ssf_spec={"num_modes": 4},
    obd_spec={"num_pos": 3, "est_every_mult": 4},
    pair_corr_spec={"num_bins": 6, "est_every_mult": 2},
    itc_spec={"num_modes": 3, "num_lags": 2, "est_every_mult": 4})
VMC_CONFIG = dict(model_spec=dict(MODEL_CONFIG), move_spread="0.25",
                  num_blocks=2, num_steps_block=16, burn_in_blocks=1,
                  num_walkers=8, rng_seed=7, dtype="float64",
                  ssf_spec={"num_modes": 4})
#: The chunked mode (S(k) every 4th step, the OBDM every 8th) and the
#: every-step mode (both every step).
VMC_MODES = {
    "chunked": dict(est_every=4, obd_spec={"num_pos": 3,
                                           "est_every_mult": 2}),
    "every-step": dict(obd_spec={"num_pos": 3}),
}


@pytest.fixture(autouse=True)
def _tracing_left_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _exec(module, config, **kwargs):
    proc = module.Proc.from_config(config)
    start = module.ProcInput.from_model_sys_conf_spec(
        module.ModelSysConfSpec(), proc, device="cpu")
    return proc.exec(start, **kwargs)


def _traced(module, config):
    tracing.enable()
    try:
        result = _exec(module, config)
    finally:
        tracing.disable()
    spans, dropped = tracing.take()
    assert dropped == 0
    return result, spans


def _children(spans, parent, name):
    return [s for s in spans if s.parent == parent.index and s.name == name]


def _raise(*args, **kwargs):
    raise AssertionError("record_function called with tracing off")


def test_off_span_is_one_shared_object_and_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not tracing.enabled()
    assert tracing.span(tracing.BLOCK) is tracing.span(tracing.STEP_DMC)
    with tracing.span(tracing.BLOCK):
        pass
    _exec(tdmc, dict(DMC_CONFIG, num_blocks=1))
    _exec(tvmc, dict(VMC_CONFIG, **VMC_MODES["every-step"]))
    with profile(activities=[ProfilerActivity.CPU]):
        _exec(tvmc, dict(VMC_CONFIG, num_blocks=1))
    assert tracing.take() == ([], 0)


def test_dmc_records_the_span_tree_at_the_estimators_cadences():
    config = DMC_CONFIG
    nts = config["num_time_steps_block"]
    every = config["est_every"]
    _, spans = _traced(tdmc, config)
    blocks = [s for s in spans if s.name == tracing.BLOCK]
    assert len(blocks) == config["num_blocks"]
    assert all(b.parent is None for b in blocks)
    # The burn-in block runs outside any measured block.
    runs = [s for s in spans if s.name == tracing.RUN_DMC]
    assert len(runs) == config["burn_in_blocks"] + config["num_blocks"]
    expected = {
        tracing.STEP_DMC: nts,
        tracing.DENSITY: nts // every,
        tracing.SSF: nts // every,
        tracing.OBD: nts // (every * 4),
        tracing.G2: nts // (every * 2),
        tracing.ITC: nts // (every * 4),
    }
    for block in blocks:
        assert block.start_ns <= block.end_ns
        (run,) = _children(spans, block, tracing.RUN_DMC)
        assert block.start_ns <= run.start_ns <= run.end_ns \
            <= block.end_ns
        for name, count in expected.items():
            assert len(_children(spans, run, name)) == count, name
        for step in _children(spans, run, tracing.STEP_DMC):
            assert run.start_ns <= step.start_ns <= step.end_ns \
                <= run.end_ns
            assert not [s for s in spans if s.parent == step.index]
    (burn,) = [r for r in runs if r.parent is None]
    assert Counter(s.name for s in spans if s.parent == burn.index) \
        == {tracing.STEP_DMC: nts}
    # One index a span.
    assert len({s.index for s in spans}) == len(spans)


@pytest.mark.parametrize("mode", sorted(VMC_MODES))
def test_vmc_records_the_span_tree_in_both_modes(mode):
    config = dict(VMC_CONFIG, **VMC_MODES[mode])
    nts = config["num_steps_block"]
    _, spans = _traced(tvmc, config)
    blocks = [s for s in spans if s.name == tracing.BLOCK]
    assert len(blocks) == config["num_blocks"]
    for block in blocks:
        (run,) = _children(spans, block, tracing.RUN_VMC)
        steps = _children(spans, run, tracing.STEP_VMC)
        assert len(steps) == nts
        if mode == "chunked":
            # The chunk-final measurement, outside the step.
            assert len(_children(spans, run, tracing.SSF)) == nts // 4
            assert len(_children(spans, run, tracing.OBD)) == nts // 8
            assert all(not [s for s in spans if s.parent == step.index]
                       for step in steps)
        else:
            # The proposal's parts, inside every step.
            for step in steps:
                assert Counter(s.name for s in spans
                               if s.parent == step.index) \
                    == {tracing.SSF: 1, tracing.OBD: 1}
            assert not _children(spans, run, tracing.SSF)


def test_dmc_numbers_are_bit_equal_with_tracing_on():
    plain = _exec(tdmc, DMC_CONFIG)
    traced, _ = _traced(tdmc, DMC_CONFIG)
    assert_same(traced.data, plain.data)
    np.testing.assert_array_equal(traced.state.pos, plain.state.pos)


@pytest.mark.parametrize("mode", sorted(VMC_MODES))
def test_vmc_numbers_are_bit_equal_with_tracing_on(mode):
    config = dict(VMC_CONFIG, **VMC_MODES[mode])
    plain = _exec(tvmc, config)
    traced, _ = _traced(tvmc, config)
    assert_same(traced.data, plain.data)
    np.testing.assert_array_equal(traced.state.pos, plain.state.pos)


def test_spans_go_to_a_running_profiler_and_not_to_memory(tmp_path):
    config = dict(VMC_CONFIG, num_blocks=1, burn_in_blocks=0)
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _exec(tvmc, config)
        assert tracing.take() == ([], 0)
        with tracing.span(tracing.BLOCK):
            pass
    finally:
        tracing.disable()
    assert [s.name for s in tracing.take()[0]] == [tracing.BLOCK]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"] in tracing.SPANS]
    names = Counter(e["name"] for e in events)
    nts = config["num_steps_block"]
    assert names == {tracing.BLOCK: 1, tracing.RUN_VMC: 1,
                     tracing.STEP_VMC: nts, tracing.SSF: nts + 1}

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] \
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    (block,) = [e for e in events if e["name"] == tracing.BLOCK]
    (run,) = [e for e in events if e["name"] == tracing.RUN_VMC]
    assert inside(run, block)
    steps = [e for e in events if e["name"] == tracing.STEP_VMC]
    assert all(inside(step, run) for step in steps)
    # Each step holds the S(k) parts of its proposal; the one more
    # evaluation seeds the start's parts before the run.
    ssf = [e for e in events if e["name"] == tracing.SSF]
    assert sum(any(inside(s, step) for step in steps) for s in ssf) == nts


def test_a_full_list_drops_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable()
    with tracing.span(tracing.BLOCK):
        for _ in range(4):
            with tracing.span(tracing.STEP_DMC):
                pass
    tracing.disable()
    spans, dropped = tracing.take()
    assert [s.name for s in spans] == [tracing.STEP_DMC] * 3
    assert [s.parent for s in spans] == [0, 0, 0]
    assert dropped == 2
    assert tracing.take() == ([], 0)


def test_traced_keeps_the_function():
    @tracing.traced(tracing.OBD)
    def twice(x, *, by=2):
        """Doubles."""
        return by * x

    assert twice(3) == 6 and twice.__doc__ == "Doubles."
    tracing.enable()
    assert twice(2, by=3) == 6
    tracing.disable()
    (span,), _ = tracing.take()
    assert span.name == tracing.OBD and span.parent is None
