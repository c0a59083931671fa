"""The VMC step replayed from CUDA graphs (``vmc.step_graph``).

On a CUDA device a run of one row without a walker mesh captures its
step's body in two CUDA graphs and replays them in turn, as the DMC step
does (``tests/test_torch_dmc_graph.py``).  On the CPU, where no graph
exists, the tests below emulate one: the capture runs the body once, and
a replay runs it again into the same buffers, as a graph writes into the
addresses it captured.  So the buffer logic (the two sides, the inputs
copied in, what a block yields) is held here to the eager step bit for
bit, and the card tests (marker ``cuda``) hold the real graphs to it.
Run them on the card with::

    python -m pytest tests/test_torch_vmc_graph.py -m cuda --noconftest

(this file imports only the port and the benchmark's step capture).
"""
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.parallel import VmcSweep
from phd_qmclib_torch.samplers import dmc, vmc
from portbench import capture

torch.set_num_threads(1)

SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.4)
NTS = 8
CHAINS = 32
#: The runs the tests compare: sk's every-step S(k), variational's
#: chunked mix (S(k) every est_every-th step, the OBDM and g2 every
#: est_every_mult-th chunk), the every-step mode carrying the OBDM grid
#: too, and Gaussian moves.
CASES = {
    "sk": dict(move_spread=0.4, ssf_est_spec=vmc.SSFEstSpec(num_modes=8)),
    "variational": dict(
        move_spread=0.25, est_every=2,
        ssf_est_spec=vmc.SSFEstSpec(num_modes=8),
        obd_est_spec=vmc.OBDEstSpec(num_pos=4, est_every_mult=2),
        pair_corr_est_spec=vmc.PairCorrEstSpec(num_bins=8,
                                               est_every_mult=2)),
    "every_step_obd": dict(move_spread=0.3,
                           ssf_est_spec=vmc.SSFEstSpec(num_modes=4),
                           obd_est_spec=vmc.OBDEstSpec(num_pos=4)),
    "gaussian": dict(move_spread=0.2, gaussian=True,
                     ssf_est_spec=vmc.SSFEstSpec(num_modes=4)),
}
#: ``state_data_blocks``' thinning in the runs that keep configurations
#: (a multiple of every estimator's cadence).
THIN = 4


def _sampling(case: str, **kwargs) -> vmc.Sampling:
    return vmc.Sampling(**dict(dict(model_spec=mrbp.Spec(**SPEC), rng_seed=3,
                                    num_walkers=CHAINS), **CASES[case],
                               **kwargs))


def _confs(num: int = CHAINS, seed: int = 0) -> np.ndarray:
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
    vmc.step_graph.capture_count = vmc.step_graph.replay_count = 0
    yield vmc.step_graph
    vmc.step_graph.capture_count = vmc.step_graph.replay_count = 0


@pytest.fixture
def emulated(monkeypatch, counters):
    """Runs on the CPU replay their steps from emulated graphs; returns
    the run graphs as they capture."""
    made = []
    capture_sides = vmc._StepGraph._capture

    def record(graph, *args):
        made.append(graph)
        capture_sides(graph, *args)

    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(dmc, "_record_graph", _replayed_eagerly)
    monkeypatch.setattr(vmc._StepGraph, "_capture", record)
    return made


def _run(sampling, device, num_blocks: int = 3, dtype=np.float64,
         thin: int = 0):
    """``num_blocks`` blocks of ``sampling`` from the same state, each
    block's yield copied to the host: ``(confs, block)`` with ``thin``
    (``state_data_blocks``), else the block."""
    state = sampling.build_state(_confs(), dtype=dtype, device=device)
    blocks = (sampling.state_data_blocks(NTS, state, thin=thin) if thin
              else sampling.blocks(NTS, state))
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


def _buffers(graph) -> set:
    """The storages a run's graphs read and write."""
    tensors = []
    for inputs, _, out in graph.sides:
        tensors += list(inputs.values()) + list(out)
    return {x.untyped_storage().data_ptr() for x in tensors if x is not None}


def _tensors(yielded) -> list:
    """Every tensor of a yielded block (and its configurations)."""
    confs, block = yielded if isinstance(yielded, tuple) \
        and not hasattr(yielded, "_fields") else (None, yielded)
    tensors = [x for x in block.last_state if x is not None] \
        + list(block.iter_props) + [
            getattr(block, name) for name in block._fields
            if name.startswith("iter_") and name != "iter_props"
            and getattr(block, name) is not None]
    return tensors + ([] if confs is None else [confs])


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
    graph = vmc.step_graph(torch.device(device), rows, mesh)
    assert (graph is not None) is engages
    # Nothing is captured before the run's steps.
    if engages:
        assert graph.sides is None


def test_cpu_runs_replay_nothing(counters):
    """The CPU's runs, the replay API and the recording API step
    eagerly."""
    sampling = _sampling("variational")
    _run(sampling, "cpu", num_blocks=2)
    _run(_sampling("sk"), "cpu", num_blocks=1, thin=THIN)
    state = sampling.build_state(_confs(), device="cpu")
    rng = np.random.default_rng(4)
    sampling.replay_chain(state, rng.random((NTS, CHAINS, 16)),
                          rng.random((NTS, CHAINS)))
    assert (counters.capture_count, counters.replay_count) == (0, 0)


def test_replay_apis_and_fused_rows_stay_eager_where_graphs_engage(
        emulated):
    """Where the device replays steps from graphs, the replay APIs and a
    fused sweep's rows still run the eager body."""
    sampling = _sampling("variational")
    state = sampling.build_state(_confs(), device="cpu")
    rng = np.random.default_rng(4)
    sampling.replay_chain(state, rng.random((NTS, CHAINS, 16)),
                          rng.random((NTS, CHAINS)))
    sweep = VmcSweep(tuple(
        _sampling("variational", rng_seed=3 + i, model_spec=mrbp.Spec(
            **dict(SPEC, tbf_contact_cutoff=rm)))
        for i, rm in enumerate((0.4, 0.5))))
    states = sweep.build_states([_confs(), _confs(seed=1)], device="cpu")
    sweep.replay_chain(states, rng.random((NTS, 2, CHAINS, 16)),
                       rng.random((NTS, 2, CHAINS)))
    next(sweep.blocks(NTS, states))
    assert emulated == []
    assert (vmc.step_graph.capture_count, vmc.step_graph.replay_count) \
        == (0, 0)


# -- a graphed run against the eager body ------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case,thin", [(case, 0) for case in sorted(CASES)]
                         + [("sk", THIN), ("variational", THIN)])
def test_an_emulated_graph_run_equals_the_eager_body(monkeypatch, emulated,
                                                    case, thin, dtype):
    """Over three blocks: every per-step property, estimator row, the
    acceptance rates, the kept configurations and the last state."""
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    eager = _run(_sampling(case), "cpu", dtype=dtype, thin=thin)
    assert emulated == []
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cpu",))
    graphed = _run(_sampling(case), "cpu", dtype=dtype, thin=thin)
    assert len(emulated) == 1
    _assert_equal(graphed, eager, case)
    # The first step runs eagerly, the others replay.
    assert vmc.step_graph.capture_count == 1
    assert vmc.step_graph.replay_count == 3 * NTS - 1


@pytest.mark.parametrize("case", ["sk", "variational"])
def test_a_resumed_state_is_copied_in(emulated, case):
    """A run continued from a yielded state (a resume) takes it in as
    its first state: the same blocks as the run that went on."""
    sampling = _sampling(case)
    whole = _run(sampling, "cpu")
    assert len(emulated) == 1
    state = sampling.build_state(_confs(), dtype=np.float64, device="cpu")
    first = next(sampling.blocks(NTS, state))
    rest = sampling.blocks(NTS, first.last_state, block_offset=1)
    _assert_equal([_host(next(rest)) for _ in range(2)], whole[1:])
    assert len(emulated) == 3


@pytest.mark.parametrize("graphed", [False, True])
def test_step_is_entered_once_a_step(monkeypatch, emulated, graphed):
    if not graphed:
        monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    calls, bodies = [], []
    step, body = vmc.Sampling._step, vmc.Sampling._step_body
    monkeypatch.setattr(vmc.Sampling, "_step", lambda self, *a: (
        calls.append(1), step(self, *a))[1])
    monkeypatch.setattr(vmc.Sampling, "_step_body", lambda self, *a, **k: (
        bodies.append(len(calls)), body(self, *a, **k))[1])
    _run(_sampling("sk"), "cpu")
    assert len(calls) == 3 * NTS
    # The graphs' body runs at the first step, at the capture of both
    # sides (the second step) and, emulated, at every replay; each time
    # inside a _step call, never through it.
    want = list(range(1, 3 * NTS + 1))
    if graphed:
        want = [1, 2, 2] + list(range(2, 3 * NTS + 1))
    assert bodies == want


@pytest.mark.parametrize("case,thin", [("sk", 0), ("variational", 0),
                                       ("every_step_obd", THIN)])
def test_the_yielded_blocks_own_their_memory(emulated, case, thin):
    """The state, the per-step properties, the rows and the kept
    configurations a block yields share no storage with the graphs'
    buffers, and keep their values while the next blocks step."""
    sampling = _sampling(case)
    state = sampling.build_state(_confs(), dtype=np.float64, device="cpu")
    blocks = (sampling.state_data_blocks(NTS, state, thin=thin) if thin
              else sampling.blocks(NTS, state))
    yielded = [next(blocks) for _ in range(2)]
    kept = _host(yielded)
    buffers = _buffers(emulated[0])
    for block in yielded:
        assert not any(x.untyped_storage().data_ptr() in buffers
                       for x in _tensors(block))
    next(blocks)
    next(blocks)
    _assert_equal(_host(yielded), kept)


@pytest.mark.parametrize("case", ["sk", "variational"])
def test_the_step_capture_records_a_graphed_run(monkeypatch, emulated,
                                                case):
    """The benchmark's capture wraps ``Sampling._step`` and
    ``_measure`` and reads the step's input after it returns: a graphed
    run leaves it the eager run's records."""
    total = 3 * NTS
    checked = [0, 1, 2, 9, total - 1]

    def records():
        cap = _HostCapture(vmc.Sampling, "vmc", checked, total)
        with cap:
            _run(_sampling(case), "cpu", dtype=np.float32)
        return cap.count, cap.records

    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    eager = records()
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cpu",))
    graphed = records()
    assert len(emulated) == 1
    assert eager[0] == graphed[0] == total
    assert sorted(eager[1]) == checked
    _assert_equal(graphed[1], eager[1])


@pytest.mark.parametrize("entries", [None, 3 * CHAINS])
def test_the_acceptance_rate_is_the_count_over_the_entries(monkeypatch,
                                                           entries):
    """Each block's rate is its accepted moves over its entries, the
    mean of the flags in float64 without a float64 table, however many
    steps are summed at a time."""
    if entries:
        monkeypatch.setattr(vmc, "_COUNT_ENTRIES", entries)
    sampling = _sampling("sk")
    state = sampling.build_state(_confs(), dtype=np.float64, device="cpu")
    for block in (b for _, b in zip(range(2), sampling.blocks(NTS, state))):
        flags = block.iter_props.move_stat
        assert flags.dtype == torch.bool and flags.shape == (NTS, CHAINS)
        assert block.accept_rate == float(flags.double().mean())


# -- on the card -------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case,thin", [(case, 0) for case in sorted(CASES)]
                         + [("sk", THIN), ("variational", THIN)])
def test_a_graph_run_equals_the_eager_body(cuda, monkeypatch, counters, case,
                                           thin, dtype):
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ())
    eager = _run(_sampling(case), cuda, dtype=dtype, thin=thin)
    assert (counters.capture_count, counters.replay_count) == (0, 0)
    monkeypatch.setattr(dmc, "_GRAPH_DEVICES", ("cuda",))
    graphed = _run(_sampling(case), cuda, dtype=dtype, thin=thin)
    _assert_equal(graphed, eager, case)
    assert counters.capture_count == 1
    assert counters.replay_count == 3 * NTS - 1


@pytest.mark.cuda
@pytest.mark.parametrize("case,per_step", [
    ("sk", {"K1 log": 1, "S(k)": 1, "OBDM": 0}),
    ("every_step_obd", {"K1 log": 1, "S(k)": 1, "OBDM": 1}),
    ("variational", {"K1 log": 1, "S(k)": 1 / 2, "OBDM": 1 / 4})])
def test_the_counters_count_the_replayed_launches(cuda, counters, case,
                                                  per_step):
    from phd_qmclib_torch.ops import pairwise, ssf
    kernels = {"K1 log": (pairwise.energy_and_drift, "log_psi_launch_count"),
               "S(k)": (ssf.ssf_harmonics, "launch_count"),
               "OBDM": (pairwise.obd_grid, "launch_count")}
    sampling = _sampling(case)
    state = sampling.build_state(_confs(), dtype=np.float32, device=cuda)
    before = {name: getattr(*kernel) for name, kernel in kernels.items()}
    blocks = sampling.blocks(NTS, state)
    for _ in range(3):
        next(blocks)
    assert {name: getattr(*kernel) - before[name]
            for name, kernel in kernels.items()} \
        == {name: count * 3 * NTS for name, count in per_step.items()}
    assert counters.replay_count == 3 * NTS - 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sk", "variational"])
def test_the_step_capture_records_a_graph_run(cuda, monkeypatch, counters,
                                              case):
    total = 3 * NTS
    checked = [0, 1, 2, 13, total - 1]

    def records():
        cap = capture.StepCapture(vmc.Sampling, "vmc", checked, total)
        with cap:
            _run(_sampling(case), cuda, dtype=np.float32)
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
@pytest.mark.parametrize("thin", [0, THIN])
def test_the_yielded_blocks_own_their_memory_on_the_card(cuda, thin):
    sampling = _sampling("every_step_obd")
    state = sampling.build_state(_confs(), dtype=np.float32, device=cuda)
    blocks = (sampling.state_data_blocks(NTS, state, thin=thin) if thin
              else sampling.blocks(NTS, state))
    yielded = [next(blocks) for _ in range(2)]
    kept = _host(yielded)
    next(blocks)
    next(blocks)
    _assert_equal(_host(yielded), kept)
