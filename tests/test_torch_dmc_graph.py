"""The DMC step replayed from CUDA graphs (``dmc.step_graph``).

On a CUDA device a run of one row without a walker mesh captures its
step's body in two CUDA graphs and replays them in turn.  On the CPU,
where no graph exists, the tests below emulate one: the capture runs the
body once and keeps its outputs, and a replay runs it again into those
same outputs, as a graph writes into the addresses it captured.  So the
buffer logic (the two sides, the inputs copied in, what a block yields)
is held here to the eager step bit for bit, and the card tests (marker
``cuda``) hold the real graphs to it.  Run them on the card with::

    python -m pytest tests/test_torch_dmc_graph.py -m cuda --noconftest

(this file imports only the port and the benchmark's step capture).
"""
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.parallel import ParamSweep
from phd_qmclib_torch.samplers import dmc
from portbench import capture

torch.set_num_threads(1)

SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.4)
#: A time step large enough that the comb clones and kills walkers.
SAMPLING = dict(time_step=1e-2, max_num_walkers=64, target_num_walkers=48,
                rng_seed=3)
NTS = 8
#: The runs the tests compare: production's estimator mix, the reference
#: library's stale-slot energies, and a CM window reset every block.
CASES = {
    "bare": {},
    "production": dict(
        density_est_spec=dmc.DensityEstSpec(num_bins=16),
        ssf_est_spec=dmc.SSFEstSpec(num_modes=8),
        obd_est_spec=dmc.OBDEstSpec(num_pos=4, est_every_mult=2),
        pair_corr_est_spec=dmc.PairCorrEstSpec(num_bins=8,
                                               est_every_mult=2),
        itc_est_spec=dmc.ITCEstSpec(num_modes=4, num_lags=3,
                                    as_pure_est=True),
        cm_diffusion_est=True, cm_window_blocks=None, est_every=2),
    "ref_compat": dict(ref_compat=True, cm_diffusion_est=True),
    "cm_window_reset": dict(cm_diffusion_est=True, cm_window_blocks=1,
                            ssf_est_spec=dmc.SSFEstSpec(num_modes=4)),
}


def _sampling(case: str) -> dmc.Sampling:
    return dmc.Sampling(mrbp.Spec(**SPEC), **SAMPLING, **CASES[case])


def _confs(num: int = 48, seed: int = 0) -> np.ndarray:
    spec = mrbp.Spec(**SPEC)
    rng = np.random.default_rng(seed)
    return np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(num)])


def _replayed_eagerly(fn):
    """A CUDA graph's capture and replay on the CPU: the outputs stay
    where the capture made them, and a replay runs the work again into
    them."""
    outputs = fn()

    def replay():
        for name, value in fn().items():
            outputs[name].copy_(value)

    return replay, outputs


@pytest.fixture
def counters():
    dmc.step_graph.capture_count = dmc.step_graph.replay_count = 0
    yield dmc.step_graph
    dmc.step_graph.capture_count = dmc.step_graph.replay_count = 0


@pytest.fixture
def emulated(monkeypatch, counters):
    """Runs on the CPU replay their steps from emulated graphs; returns
    the run graphs as they capture."""
    made = []
    capture_graphs = dmc._StepGraph._capture

    def record(graph, *args):
        # A CUDA graph's capture records the work without running it:
        # the block's step count stays where the first step left it.
        made.append(graph)
        count = graph.count.clone()
        capture_graphs(graph, *args)
        graph.count.copy_(count)

    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(dmc, "_record_graph", _replayed_eagerly)
    monkeypatch.setattr(dmc._StepGraph, "_capture", record)
    return made


def _run(sampling, device, num_blocks: int = 3, burn_in: int = 1,
         dtype=np.float64):
    """``num_blocks`` blocks of ``sampling`` from the same state, each
    block's yield copied to the host."""
    state = sampling.build_state(_confs(), dtype=dtype, device=device)
    blocks = sampling.blocks(state, NTS, burn_in_blocks=burn_in)
    return [_host(next(blocks)) for _ in range(num_blocks)]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {name: _host(value) for name, value in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_host(value) for value in x)) \
            if hasattr(x, "_fields") else tuple(_host(v) for v in x)
    if isinstance(x, list):
        return [_host(value) for value in x]
    return x


def _assert_equal(got, want, where: str = ""):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for name in want:
            _assert_equal(got[name], want[name], f"{where}.{name}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        names = getattr(want, "_fields", range(len(want)))
        for name, a, b in zip(names, got, want):
            _assert_equal(a, b, f"{where}.{name}")
    else:
        assert got == want, where


class _HostCapture(capture.StepCapture):
    """The benchmark's step capture with its host copies made on the CPU
    too, where ``.to("cpu")`` returns the tensor itself."""

    def _record_step(self, k, state, out):
        super()._record_step(k, state, out)
        self.records[k] = _host(self.records[k])

    def _wrap_estimate(self, estimate):
        wrapped = super()._wrap_estimate(estimate)

        def copying(sampling, *args, **kwargs):
            out = wrapped(sampling, *args, **kwargs)
            record = self.records.get(self.current, {})
            if "est" in record:
                record["est"] = _host(record["est"])
            return out

        return copying


def _buffers(graph) -> set:
    """The storages a run's graphs read and write."""
    ptrs = set()
    for inputs, _, out in graph.sides:
        tensors = list(inputs.values()) + list(out["state"]) \
            + list(out["branch"]) + [out["e_prev_slots"], graph.props]
        ptrs.update(x.untyped_storage().data_ptr() for x in tensors
                    if x is not None)
    return ptrs


# -- where the graph engages -------------------------------------------------

@pytest.mark.parametrize("device,rows,mesh,engages", [
    ("cuda", 1, None, True),
    ("cuda:0", 1, None, True),
    ("cpu", 1, None, False),
    ("cuda", 2, None, False),
    ("cuda", 4, None, False),
    ("cuda", 1, "a walker mesh", False),
    ("cpu", 2, "a walker mesh", False),
])
def test_the_graph_engages_for_one_cuda_row_without_a_mesh(device, rows,
                                                           mesh, engages):
    graph = dmc.step_graph(torch.device(device), rows, mesh, NTS)
    assert (graph is not None) is engages
    # Nothing is captured before the run's steps.
    if engages:
        assert graph.sides is None


def test_cpu_runs_replay_nothing(counters):
    """The CPU's runs, the replay APIs and the recording API step
    eagerly."""
    sampling = _sampling("production")
    _run(sampling, "cpu", num_blocks=2)
    state = sampling.build_state(_confs(), device="cpu")
    rng = np.random.default_rng(4)
    comb_u, xi = rng.random((NTS, 64)), 0.1 * rng.standard_normal(
        (NTS, 64, 16))
    sampling.replay_states(state, comb_u, xi)
    sampling.replay_estimators(state, comb_u, xi)
    next(sampling.state_data_blocks(state, NTS))
    assert (counters.capture_count, counters.replay_count) == (0, 0)


def test_replay_apis_and_fused_rows_stay_eager_where_graphs_engage(
        emulated):
    """Where the device replays steps from graphs, the replay APIs,
    the recording API and a fused sweep's rows still run the eager
    body."""
    sampling = _sampling("production")
    state = sampling.build_state(_confs(), device="cpu")
    rng = np.random.default_rng(4)
    comb_u, xi = rng.random((NTS, 64)), 0.1 * rng.standard_normal(
        (NTS, 64, 16))
    sampling.replay_states(state, comb_u, xi)
    sampling.replay_estimators(state, comb_u, xi)
    next(sampling.state_data_blocks(state, NTS))
    sweep = ParamSweep(tuple(
        dmc.Sampling(mrbp.Spec(**dict(SPEC, interaction_strength=g)),
                     **dict(SAMPLING, rng_seed=3 + i))
        for i, g in enumerate((1.0, 2.0))))
    states = sweep.build_states([_confs(), _confs(seed=1)], device="cpu")
    next(sweep.blocks(states, NTS))
    assert emulated == []
    assert (dmc.step_graph.capture_count, dmc.step_graph.replay_count) \
        == (0, 0)


# -- a graphed run against the eager body ------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_an_emulated_graph_run_equals_the_eager_body(monkeypatch, emulated,
                                                    case):
    """Over a burn-in block and two measured blocks: every per-step
    scalar, estimator row, carried accumulator and the last state."""
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    eager = _run(_sampling(case), "cpu")
    assert emulated == []
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cpu",))
    graphed = _run(_sampling(case), "cpu")
    assert len(emulated) == 1
    _assert_equal(graphed, eager, case)
    # The first step runs eagerly, the others replay.
    assert dmc.step_graph.capture_count == 1
    assert dmc.step_graph.replay_count == 3 * NTS - 1


def test_a_resumed_state_is_copied_in(emulated):
    """A run continued from a yielded state (a resume) takes it in as
    its first state: the same blocks as the run that went on."""
    sampling = _sampling("production")
    whole = _run(sampling, "cpu")
    assert len(emulated) == 1
    state = sampling.build_state(_confs(), dtype=np.float64, device="cpu")
    first = next(sampling.blocks(state, NTS, burn_in_blocks=1))
    rest = sampling.blocks(first.last_state, NTS, burn_in_blocks=1,
                           start_block_idx=1)
    _assert_equal([_host(next(rest)) for _ in range(2)], whole[1:])
    assert len(emulated) == 3


@pytest.mark.parametrize("graphed", [False, True])
def test_step_is_entered_once_a_step(monkeypatch, emulated, graphed):
    if not graphed:
        monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    calls, bodies = [], []
    step, body = dmc.Sampling._step, dmc.Sampling._step_body
    monkeypatch.setattr(dmc.Sampling, "_step", lambda self, *a: (
        calls.append(1), step(self, *a))[1])
    monkeypatch.setattr(dmc.Sampling, "_step_body", lambda self, *a: (
        bodies.append(len(calls)), body(self, *a))[1])
    _run(_sampling("production"), "cpu")
    assert len(calls) == 3 * NTS
    # The graphs' body runs at the first step, at the capture of both
    # sides (the second step) and, emulated, at every replay; each time
    # inside a _step call, never through it.
    want = list(range(1, 3 * NTS + 1))
    if graphed:
        want = [1, 2, 2] + list(range(2, 3 * NTS + 1))
    assert bodies == want


def test_the_yielded_blocks_own_their_memory(emulated):
    """The state, the per-step scalars and the rows a block yields share
    no storage with the graphs' buffers, and keep their values while the
    next blocks step."""
    sampling = _sampling("production")
    state = sampling.build_state(_confs(), dtype=np.float64, device="cpu")
    blocks = sampling.blocks(state, NTS, burn_in_blocks=1)
    yielded = [next(blocks) for _ in range(2)]
    kept = _host(yielded)
    buffers = _buffers(emulated[0])
    for block in yielded:
        tensors = [x for x in block.last_state if x is not None] \
            + list(block.iter_props) + [
                getattr(block, name) for name in block._fields
                if name.startswith("iter_") and name != "iter_props"
                and getattr(block, name) is not None]
        assert not any(x.untyped_storage().data_ptr() in buffers
                       for x in tensors)
    next(blocks)
    next(blocks)
    _assert_equal(_host(yielded), kept)


def test_the_step_capture_records_a_graphed_run(monkeypatch, emulated):
    """The benchmark's capture wraps ``Sampling._step`` and reads the
    step's input after it returns: a graphed run leaves it the eager
    run's records."""
    total = 3 * NTS
    checked = [0, 1, 2, 9, total - 1]

    def records():
        cap = _HostCapture(dmc.Sampling, "dmc", checked, total)
        with cap:
            _run(_sampling("production"), "cpu", dtype=np.float32)
        return cap.count, cap.records

    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    eager = records()
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cpu",))
    graphed = records()
    assert len(emulated) == 1
    assert eager[0] == graphed[0] == total
    assert sorted(eager[1]) == checked
    _assert_equal(graphed[1], eager[1])


# -- on the card -------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_a_graph_run_equals_the_eager_body(cuda, monkeypatch, counters, case,
                                           dtype):
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    eager = _run(_sampling(case), cuda, dtype=dtype)
    assert (counters.capture_count, counters.replay_count) == (0, 0)
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cuda",))
    graphed = _run(_sampling(case), cuda, dtype=dtype)
    _assert_equal(graphed, eager, case)
    assert counters.capture_count == 1
    assert counters.replay_count == 3 * NTS - 1


@pytest.mark.cuda
def test_the_k1_counter_counts_the_replayed_launches(cuda, counters):
    from phd_qmclib_torch.ops import pairwise
    sampling = _sampling("bare")
    state = sampling.build_state(_confs(), dtype=np.float32, device=cuda)
    before = pairwise.energy_and_drift.launch_count
    blocks = sampling.blocks(state, NTS)
    for _ in range(3):
        next(blocks)
    assert pairwise.energy_and_drift.launch_count - before == 3 * NTS
    assert counters.replay_count == 3 * NTS - 1


@pytest.mark.cuda
def test_the_step_capture_records_a_graph_run(cuda, monkeypatch, counters):
    total = 3 * NTS
    checked = [0, 1, 2, 13, total - 1]

    def records():
        cap = capture.StepCapture(dmc.Sampling, "dmc", checked, total)
        with cap:
            _run(_sampling("production"), cuda, dtype=np.float32)
        return cap.count, cap.records

    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    eager = records()
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cuda",))
    graphed = records()
    assert counters.replay_count == total - 1
    assert eager[0] == graphed[0] == total
    assert sorted(graphed[1]) == checked
    _assert_equal(graphed[1], eager[1])


@pytest.mark.cuda
def test_the_yielded_blocks_own_their_memory_on_the_card(cuda):
    sampling = _sampling("production")
    state = sampling.build_state(_confs(), dtype=np.float32, device=cuda)
    blocks = sampling.blocks(state, NTS, burn_in_blocks=1)
    yielded = [next(blocks) for _ in range(2)]
    kept = _host(yielded)
    next(blocks)
    next(blocks)
    _assert_equal(_host(yielded), kept)
