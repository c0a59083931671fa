"""The S(k) harmonics' dispatch in ``models/mrbp.py``: a CPU tensor runs
``models/jastrow.py``'s plain recurrence (bit for bit, a fused sweep's
rows included) and launches nothing; any other device goes through
``ops.ssf.ssf_harmonics`` (run on the card in
``test_torch_cuda_kernels.py``; stubbed here, on the ``meta`` device),
with the ``(R,)`` table of supercell sizes that ``_ssf_lengths`` builds,
inside one ``estimators.ssf`` span an evaluation; the ITC amplitudes are
slots 1-2 of the same output.  The wrapper's checks run here too.
"""
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import jastrow, mrbp
from phd_qmclib_torch.ops import ssf
from phd_qmclib_torch.samplers import dmc, vmc
from phd_qmclib_torch.utils import tracing

torch.set_num_threads(1)

BENCH = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
             boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.4)
DTYPES = [torch.float32, torch.float64]
MODES = [1, 2, 3, 32, 33, 65]
#: Three sweep rows at fixed N: the supercell (so k_1) differs.
ROW_LENGTHS = (16.0, 15.0, 17.5)


def _plain(spec):
    """jastrow's namespace on mrbp's functions, built apart from
    ``mrbp.core_funcs``."""
    static = spec.static_spec
    return jastrow.build_core_funcs(
        one_body=mrbp._one_body, one_body_log_dz=mrbp._one_body_log_dz,
        one_body_log_dz2=mrbp._one_body_log_dz2,
        two_body_pair_terms=mrbp._two_body_pair_terms,
        potential=mrbp._make_potential(static.defects_sep),
        is_free=static.is_free, is_ideal=static.is_ideal,
        boson_number=static.boson_number)


def _counts():
    return (ssf.ssf_harmonics.launch_count,
            ssf.ssf_harmonics.table_launch_count)


def _rows_inputs(dtype, walkers=6):
    specs = [mrbp.Spec(**dict(BENCH, supercell_size=length))
             for length in ROW_LENGTHS]
    rng = np.random.default_rng(2)
    pos = torch.as_tensor(np.stack([
        rng.uniform(0, s.supercell_size, (walkers, 16)) for s in specs]),
        dtype=dtype)
    return specs, pos, dmc._rows_cfc(specs, dtype, "cpu")


@pytest.mark.parametrize("num_modes", MODES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_parts_and_pair_are_the_plain_version(dtype, num_modes):
    """Positions across (-L, 2L): the parts, and the ITC pair (their
    slots 1-2), bit for bit the plain recurrence's; no launch."""
    spec = mrbp.Spec(**BENCH)
    pos = torch.as_tensor(np.random.default_rng(num_modes).uniform(
        -16.0, 32.0, (2, 3, 16)), dtype=dtype)
    cfc = mrbp.cast_params(spec.cfc_params, dtype, "cpu")
    counts = _counts()
    funcs, plain = mrbp.core_funcs(spec), _plain(spec)
    got = funcs.fourier_density_parts_harmonics(num_modes, pos,
                                                spec.cfc_params)
    want = plain.fourier_density_parts_harmonics(num_modes, pos, cfc)
    assert got.shape == (2, 3, num_modes, 3) and got.dtype == dtype
    assert torch.equal(got, want)
    pair = funcs.fourier_density_reim_harmonics(num_modes, pos, cfc)
    assert torch.equal(pair, plain.fourier_density_reim_harmonics(
        num_modes, pos, cfc))
    assert torch.equal(pair, got[..., 1:3])
    assert _counts() == counts


@pytest.mark.parametrize("num_modes", [1, 7, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_parts_of_sweep_rows_are_the_plain_version(dtype, num_modes):
    """A fused sweep's ``(R, 1, 1)`` leaves, each row with its own L."""
    specs, pos, cfc = _rows_inputs(dtype)
    counts = _counts()
    funcs = mrbp.core_funcs(specs[0])
    got = funcs.fourier_density_parts_harmonics(num_modes, pos, cfc)
    assert got.shape == (3, 6, num_modes, 3)
    assert torch.equal(got, _plain(specs[0]).fourier_density_parts_harmonics(
        num_modes, pos, cfc))
    assert torch.equal(funcs.fourier_density_reim_harmonics(num_modes, pos,
                                                            cfc),
                       got[..., 1:3])
    assert _counts() == counts


@pytest.mark.parametrize("dtype", DTYPES)
def test_lengths_of_one_row(dtype):
    """A 0-d supercell size gives a one-row table."""
    sc = torch.tensor(16.0, dtype=dtype)
    lengths = mrbp._ssf_lengths(sc, torch.zeros((2, 5, 16), dtype=dtype))
    assert lengths.shape == (1,) and lengths.dtype == dtype
    assert lengths.is_contiguous() and torch.equal(lengths[0], sc)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lengths_of_sweep_rows(dtype):
    """A sweep's ``(R, 1, 1)`` supercell sizes become the ``(R,)`` table,
    row r bit for bit row r's own single-row table."""
    specs, pos, cfc = _rows_inputs(dtype)
    sc = cfc.model_params.supercell_size
    assert sc.shape == (3, 1, 1)
    lengths = mrbp._ssf_lengths(sc, pos)
    assert lengths.shape == (3,) and lengths.is_contiguous()
    for r, spec in enumerate(specs):
        own = mrbp.cast_params(spec.cfc_params, dtype,
                               "cpu").model_params.supercell_size
        assert torch.equal(lengths[r:r + 1], mrbp._ssf_lengths(own, pos[r]))
        assert float(lengths[r]) == ROW_LENGTHS[r]


@pytest.mark.parametrize("pos_shape", [(2, 6, 16), (3, 6), (1, 3, 6, 16)])
def test_lengths_refuse_rows_that_do_not_match_the_walkers(pos_shape):
    sc = torch.tensor(ROW_LENGTHS, dtype=torch.float64)[:, None, None]
    with pytest.raises(ValueError, match="does not give rows"):
        mrbp._ssf_lengths(sc, torch.zeros(pos_shape, dtype=torch.float64))


def _bad(pos=None, lengths=None, num_modes=4):
    return (torch.zeros((4, 16)) if pos is None else pos,
            torch.ones(1) if lengths is None else lengths, num_modes)


@pytest.mark.parametrize("args,error,match", [
    (_bad(pos=torch.zeros((4, 16), dtype=torch.float16)), TypeError,
     "float32 or float64"),
    (_bad(pos=torch.zeros((4, 16), dtype=torch.int32)), TypeError,
     "float32 or float64"),
    (_bad(pos=torch.zeros(16)), ValueError, "shape"),
    (_bad(pos=torch.zeros((2, 4, 16))), ValueError, "shape"),
    (_bad(pos=torch.zeros((4, 0))), ValueError, "shape"),
    (_bad(pos=torch.zeros((4, 1025))), ValueError, "shape"),
    (_bad(lengths=torch.ones((1, 1))), ValueError, "table"),
    (_bad(lengths=torch.ones(0)), ValueError, "table"),
    (_bad(lengths=torch.ones(3)), ValueError, "table"),
    (_bad(lengths=torch.ones(1, dtype=torch.float64)), ValueError, "table"),
    (_bad(lengths=torch.ones(1, device="meta")), ValueError, "table"),
    (_bad(pos=torch.zeros((16, 4)).t()), ValueError, "contiguous"),
    (_bad(lengths=torch.ones((2, 2))[:, 0]), ValueError, "contiguous"),
    (_bad(num_modes=0), ValueError, "num_modes"),
    (_bad(), ValueError, "CUDA device only"),
    (_bad(pos=torch.zeros((0, 16))), ValueError, "CUDA device only"),
], ids=["f16", "int", "1d", "3d", "no particles", "wide", "2d table",
        "empty table", "table not dividing", "table dtype", "table device",
        "pos strided", "table strided", "no modes", "cpu", "cpu no walkers"])
def test_wrapper_refuses_what_the_kernel_does_not_take(args, error, match):
    counts = _counts()
    pos, lengths, num_modes = args
    with pytest.raises(error, match=match):
        ssf.ssf_harmonics(pos, lengths, num_modes=num_modes)
    assert _counts() == counts


def _stub(monkeypatch):
    """Replace the kernel: record each call's arguments and the spans
    open at the launch, and return ``arange`` values on the CPU."""
    calls = []

    def launch(pos, lengths, *, num_modes):
        calls.append(dict(pos=pos, lengths=lengths, num_modes=num_modes,
                          open=list(tracing._open)))
        return torch.arange(pos.shape[0] * num_modes * 3,
                            dtype=pos.dtype).reshape(pos.shape[0],
                                                     num_modes, 3)

    monkeypatch.setattr(ssf, "ssf_harmonics", launch)
    return calls


@pytest.mark.parametrize("rows", [False, True])
def test_off_the_cpu_the_span_encloses_the_launch(rows, monkeypatch):
    """Tracing on, each evaluation off the CPU is one ``estimators.ssf``
    span at the top, the launch inside it, with the flattened walkers and
    a table of one or R supercell sizes; the ITC pair slices the same
    output and opens no span of its own."""
    calls = _stub(monkeypatch)
    if rows:
        specs, pos, cfc = _rows_inputs(torch.float32)
        spec = specs[0]
    else:
        spec, cfc = mrbp.Spec(**BENCH), mrbp.Spec(**BENCH).cfc_params
        pos = torch.rand((2, 4, 16))
    pos = pos.to("meta")
    funcs = mrbp.core_funcs(spec)
    tracing.take()
    tracing.enable()
    try:
        parts = [funcs.fourier_density_parts_harmonics(5, pos, cfc)
                 for _ in range(3)]
        pair = funcs.fourier_density_reim_harmonics(5, pos, cfc)
        spans = tracing.take()[0]
    finally:
        tracing.disable()
    assert [s.name for s in spans] == [tracing.SSF] * 3
    assert all(s.parent is None for s in spans)
    assert [c["open"] for c in calls] == [[s.index] for s in spans] + [[]]
    for call in calls:
        assert call["pos"].shape == (pos.shape[0] * pos.shape[1], 16)
        assert call["pos"].device.type == "meta"
        assert call["lengths"].shape == ((3,) if rows else (1,))
        assert call["lengths"].dtype == torch.float32
        assert call["num_modes"] == 5
    want = torch.arange(pos.shape[0] * pos.shape[1] * 15,
                        dtype=torch.float32).reshape(pos.shape[:2] + (5, 3))
    assert all(torch.equal(p, want) for p in parts)
    assert torch.equal(pair, want[..., 1:3])


def test_off_the_cpu_no_plain_recurrence_runs(monkeypatch):
    """Off the CPU, neither function reaches the plain recurrence."""
    _stub(monkeypatch)

    def refuse(*args):
        raise AssertionError("the plain recurrence ran off the CPU")

    monkeypatch.setattr(jastrow.torch, "cos", refuse)
    funcs = mrbp.core_funcs(mrbp.Spec(**BENCH))
    pos = torch.zeros((3, 16), device="meta")
    cfc = mrbp.Spec(**BENCH).cfc_params
    assert funcs.fourier_density_parts_harmonics(4, pos, cfc).shape \
        == (3, 4, 3)
    assert funcs.fourier_density_reim_harmonics(4, pos, cfc).shape \
        == (3, 4, 2)


@pytest.mark.parametrize("sampler", ["dmc", "dmc itc", "vmc", "vmc chunked"])
def test_samplers_on_the_cpu_launch_no_kernel(sampler):
    """A block with S(k) on (and ITC with more modes than S(k), so that
    the amplitudes come from their own evaluation), run on the CPU,
    leaves the kernel's counters where they were."""
    spec = mrbp.Spec(**BENCH)
    confs = np.random.default_rng(1).uniform(0, 16.0, (8, 16))
    counts = _counts()
    if sampler.startswith("dmc"):
        extra = dict(itc_est_spec=dmc.ITCEstSpec(num_modes=6, num_lags=2)) \
            if sampler == "dmc itc" else {}
        sampling = dmc.Sampling(
            spec, time_step=1e-2, max_num_walkers=12, target_num_walkers=8,
            rng_seed=3, ssf_est_spec=dmc.SSFEstSpec(num_modes=4), **extra)
        block = next(sampling.blocks(sampling.build_state(confs,
                                                          device="cpu"), 4))
    else:
        sampling = vmc.Sampling(
            spec, move_spread=0.3, num_walkers=8, rng_seed=3,
            ssf_est_spec=vmc.SSFEstSpec(num_modes=4),
            **({"est_every": 2} if sampler == "vmc chunked" else {}))
        block = next(sampling.blocks(4, sampling.build_state(confs,
                                                             device="cpu")))
    assert block.iter_ssf.shape[-2:] == (4, 3)
    assert _counts() == counts
