"""The OBDM grid's dispatch in ``models/mrbp.py``: a CPU tensor runs
``models/jastrow.py``'s plain ``one_body_density_grid`` (bit for bit, a
fused sweep's rows included) and launches nothing; a CUDA tensor launches
``ops.pairwise.obd_grid`` (tested on the card in
``test_torch_cuda_kernels.py``) from the tables that ``_obd_tables``
builds, checked here; either way one ``estimators.obd`` span an
evaluation.
"""
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import jastrow, mrbp
from phd_qmclib_torch.ops import pairwise
from phd_qmclib_torch.samplers import dmc, vmc
from phd_qmclib_torch.utils import tracing

torch.set_num_threads(1)

BENCH = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
             boson_number=16, supercell_size=16.0, tbf_contact_cutoff=0.4)
KINDS = {
    "bench": BENCH,
    "free": dict(BENCH, lattice_depth=0.0),
    "ideal": dict(BENCH, interaction_strength=0.0),
    "free ideal": dict(BENCH, lattice_depth=0.0, interaction_strength=0.0),
}
DTYPES = [torch.float32, torch.float64]
#: Three sweep rows: coupling, cutoff and supercell (so the grid) differ.
ROWS = ((1.0, 0.4, 16.0), (0.5, 0.35, 15.0), (2.0, 0.45, 17.0))


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
    return (pairwise.obd_grid.launch_count,
            pairwise.obd_grid.table_launch_count)


def _row_specs():
    return [mrbp.Spec(**dict(BENCH, interaction_strength=gn,
                             tbf_contact_cutoff=rm, supercell_size=sc))
            for gn, rm, sc in ROWS]


def _rows_inputs(dtype, shared_grid, walkers=6, num_pos=5):
    specs = _row_specs()
    rng = np.random.default_rng(2)
    pos = torch.as_tensor(np.stack([
        rng.uniform(0, s.supercell_size, (walkers, 16)) for s in specs]),
        dtype=dtype)
    grids = [np.linspace(0.0, 7.0 if shared_grid else s.supercell_size / 2,
                         num_pos) for s in specs]
    szs = torch.as_tensor(grids[0] if shared_grid else np.stack(
        grids, axis=1)[..., None, None], dtype=dtype)
    return specs, pos, szs, grids, dmc._rows_cfc(specs, dtype, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cpu_grid_is_the_plain_version_bit_for_bit(kind, dtype):
    spec = mrbp.Spec(**KINDS[kind])
    pos = torch.as_tensor(np.random.default_rng(0).uniform(
        -4.0, 20.0, (2, 3, 16)), dtype=dtype)
    szs = torch.linspace(0.0, 8.0, 6, dtype=dtype)
    counts = _counts()
    got = mrbp.core_funcs(spec).one_body_density_grid(szs, pos,
                                                      spec.cfc_params)
    want = _plain(spec).one_body_density_grid(
        szs, pos, mrbp.cast_params(spec.cfc_params, dtype, "cpu"))
    assert got.shape == (2, 3, 6) and got.dtype == dtype
    assert torch.equal(got, want)
    assert _counts() == counts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared_grid", [False, True])
def test_cpu_grid_of_sweep_rows_is_the_plain_version(shared_grid, dtype):
    """A fused sweep's ``(num_pos, R, 1, 1)`` offsets (or one shared
    grid) and ``(R, 1, 1)`` leaves."""
    specs, pos, szs, _, cfc = _rows_inputs(dtype, shared_grid)
    counts = _counts()
    got = mrbp.core_funcs(specs[0]).one_body_density_grid(szs, pos, cfc)
    want = _plain(specs[0]).one_body_density_grid(szs, pos, cfc)
    assert got.shape == (3, 6, 5)
    assert torch.equal(got, want)
    assert _counts() == counts


@pytest.mark.parametrize("dtype", DTYPES)
def test_tables_of_one_row(dtype):
    spec = mrbp.Spec(**BENCH)
    szs = torch.linspace(0.0, 8.0, 7, dtype=torch.float64)
    params, offsets = mrbp._obd_tables(
        szs, pairwise.pack_params(mrbp.cast_params(spec.cfc_params, dtype,
                                                   "cpu"), dtype, "cpu"),
        dtype, "cpu")
    assert torch.equal(params, pairwise.pack_params(spec.cfc_params, dtype,
                                                    "cpu"))
    assert torch.equal(offsets, szs.to(dtype))
    assert params.is_contiguous() and offsets.is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared_grid", [False, True])
def test_tables_of_sweep_rows(shared_grid, dtype):
    """Row r of both tables: row r's packed parameters and grid; a shared
    grid repeated.  The parameters packed from the ``(R, 1, 1)`` leaves,
    as the dispatch packs them when no table is given."""
    specs, _, szs, grids, cfc = _rows_inputs(dtype, shared_grid)
    params, offsets = mrbp._obd_tables(
        szs, pairwise.pack_params(cfc, dtype, "cpu"), dtype, "cpu")
    assert params.shape == (3, pairwise.PARAMS_SIZE)
    assert offsets.shape == (3, 5)
    assert params.is_contiguous() and offsets.is_contiguous()
    for r, spec in enumerate(specs):
        torch.testing.assert_close(
            params[r], pairwise.pack_params(spec.cfc_params, dtype, "cpu"),
            rtol=1e-6 if dtype == torch.float32 else 1e-14, atol=0.0)
        assert torch.equal(offsets[r], torch.as_tensor(grids[r],
                                                       dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared_grid", [False, True])
def test_tables_from_a_samplers_table(shared_grid, dtype):
    """A sampler's ``(R, PARAMS_SIZE)`` table, packed row by row, is the
    kernel's table as it is."""
    specs, _, szs, grids, _ = _rows_inputs(dtype, shared_grid)
    table = torch.stack([pairwise.pack_params(
        mrbp.cast_params(s.cfc_params, dtype, "cpu"), dtype, "cpu")
        for s in specs])
    params, offsets = mrbp._obd_tables(szs, table, dtype, "cpu")
    assert torch.equal(params, table)
    assert offsets.shape == (3, 5) and offsets.is_contiguous()
    for r in range(3):
        assert torch.equal(offsets[r], torch.as_tensor(grids[r],
                                                       dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_grid_takes_no_notice_of_a_packed_table(dtype):
    """On a CPU tensor the packed parameters change nothing: the plain
    version reads ``cfc``."""
    spec = mrbp.Spec(**BENCH)
    pos = torch.as_tensor(np.random.default_rng(4).uniform(
        0.0, 16.0, (5, 16)), dtype=dtype)
    szs = torch.linspace(0.0, 8.0, 4, dtype=dtype)
    funcs = mrbp.core_funcs(spec)
    params = pairwise.pack_params(spec.cfc_params, dtype, "cpu")
    assert torch.equal(
        funcs.one_body_density_grid(szs, pos, spec.cfc_params, params),
        funcs.one_body_density_grid(szs, pos, spec.cfc_params))


@pytest.mark.parametrize("sampler", ["dmc", "vmc"])
def test_samplers_hand_the_grid_their_packed_parameters(sampler,
                                                        monkeypatch):
    """Every OBDM evaluation of a block gets the run's packed parameter
    vector, so that the card's dispatch packs nothing per call."""
    spec = mrbp.Spec(**BENCH)
    funcs = mrbp.core_funcs(spec)
    plain = funcs.one_body_density_grid
    seen = []

    def record(szs, pos, cfc, params=None):
        seen.append(params)
        return plain(szs, pos, cfc, params)

    monkeypatch.setattr(funcs, "one_body_density_grid", record)
    confs = np.random.default_rng(1).uniform(0, 16.0, (8, 16))
    if sampler == "dmc":
        sampling = dmc.Sampling(
            spec, time_step=1e-2, max_num_walkers=12, target_num_walkers=8,
            rng_seed=3, obd_est_spec=dmc.OBDEstSpec(num_pos=3))
        next(sampling.blocks(sampling.build_state(confs, device="cpu"), 4))
    else:
        sampling = vmc.Sampling(spec, move_spread=0.3, num_walkers=8,
                                rng_seed=3,
                                obd_est_spec=vmc.OBDEstSpec(num_pos=3))
        next(sampling.blocks(4, sampling.build_state(confs, device="cpu")))
    want = pairwise.pack_params(
        mrbp.cast_params(spec.cfc_params, torch.float64, "cpu"),
        torch.float64, "cpu")
    assert seen and all(p is not None and torch.equal(p, want)
                        for p in seen)


def test_the_kernel_wrapper_takes_no_cpu_tensor():
    spec = mrbp.Spec(**BENCH)
    params = pairwise.pack_params(spec.cfc_params, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        pairwise.obd_grid(torch.zeros(4), torch.zeros((2, 16)), params,
                          nop=16, is_free=False, is_ideal=False)


@pytest.mark.parametrize("rows", [False, True])
def test_one_obd_span_an_evaluation(rows):
    """Tracing on, each evaluation through the dispatch is one
    ``estimators.obd`` span at the top, with nothing inside it."""
    if rows:
        specs, pos, szs, _, cfc = _rows_inputs(torch.float64, False)
        spec = specs[0]
    else:
        spec = mrbp.Spec(**BENCH)
        pos = torch.rand((4, 16), dtype=torch.float64) * 16.0
        szs, cfc = torch.linspace(0.0, 8.0, 3), spec.cfc_params
    funcs = mrbp.core_funcs(spec)
    tracing.take()
    tracing.enable()
    try:
        for _ in range(3):
            funcs.one_body_density_grid(szs, pos, cfc)
        spans = tracing.take()[0]
    finally:
        tracing.disable()
    assert [s.name for s in spans] == [tracing.OBD] * 3
    assert all(s.parent is None for s in spans)


@pytest.mark.parametrize("sampler", ["dmc", "vmc"])
def test_samplers_on_the_cpu_launch_no_kernel(sampler):
    """A block with the OBDM on, run on the CPU, leaves the kernel's
    counters where they were."""
    spec = mrbp.Spec(**BENCH)
    confs = np.random.default_rng(1).uniform(0, 16.0, (8, 16))
    counts = _counts()
    if sampler == "dmc":
        sampling = dmc.Sampling(
            spec, time_step=1e-2, max_num_walkers=12, target_num_walkers=8,
            rng_seed=3, obd_est_spec=dmc.OBDEstSpec(num_pos=3))
        block = next(sampling.blocks(sampling.build_state(confs,
                                                          device="cpu"), 4))
    else:
        sampling = vmc.Sampling(spec, move_spread=0.3, num_walkers=8,
                                rng_seed=3,
                                obd_est_spec=vmc.OBDEstSpec(num_pos=3))
        block = next(sampling.blocks(4, sampling.build_state(confs,
                                                             device="cpu")))
    assert block.iter_obd.shape[-1] == 3
    assert _counts() == counts
