"""The hand-written CUDA kernels against their plain torch versions.

Needs an NVIDIA Hopper GPU and ``nvcc`` (the kernels build for
``sm_90a`` at first use); without a GPU every test skips.  Run on the
card with::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(``tests/conftest.py`` imports the JAX package, which the GPU host need
not have; this file imports only the port.)
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import histogram, pairwise, prng, ssf
from phd_qmclib_torch.samplers import dmc, vmc

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

BENCH = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
             boson_number=128, supercell_size=128.0, tbf_contact_cutoff=0.4)
VARIANTS = {
    "bench": (BENCH, 1024),
    "defected": (dict(BENCH, num_defects=8, defect_magnitude=10.0), 256),
    "free": (dict(BENCH, lattice_depth=0.0), 256),
    "ideal": (dict(BENCH, interaction_strength=0.0), 256),
    "n33": (dict(BENCH, boson_number=33, supercell_size=33.0), 64),
    "n1000": (dict(BENCH, boson_number=1000, supercell_size=1000.0), 8),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _pair_inputs(variant, dtype, device):
    kwargs, num_walkers = VARIANTS[variant]
    spec = mrbp.Spec(**kwargs)
    static = spec.static_spec
    pos = np.random.default_rng(0).uniform(
        0, spec.supercell_size, (num_walkers, spec.boson_number))
    params = pairwise.pack_params(spec.cfc_params, dtype, device)
    kw = dict(nop=static.boson_number, is_free=static.is_free,
              is_ideal=static.is_ideal, defects_sep=static.defects_sep)
    return torch.as_tensor(pos, dtype=dtype, device=device), params, kw


@pytest.mark.parametrize("dtype,rtol_e,rtol_d,atol_d", [
    # f32: per-particle sums in another order, and fma contraction in
    # the kernel.
    (torch.float32, 2e-5, 1e-3, 1e-4),
    # f64: the same, at f64 round-off.
    (torch.float64, 1e-10, 1e-10, 1e-10),
])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pair_kernel_matches_plain(cuda, variant, dtype, rtol_e, rtol_d,
                                   atol_d):
    pos, params, kw = _pair_inputs(variant, dtype, cuda)
    count = pairwise.energy_and_drift.launch_count
    energy, drift = pairwise.energy_and_drift(pos, params, **kw)
    torch.cuda.synchronize()
    assert pairwise.energy_and_drift.launch_count == count + 1
    energy_p, drift_p = pairwise.energy_and_drift_plain(pos, params, **kw)
    torch.testing.assert_close(energy, energy_p, rtol=rtol_e, atol=rtol_e)
    torch.testing.assert_close(drift, drift_p, rtol=rtol_d, atol=atol_d)


def test_pair_kernel_rejects_bad_inputs(cuda):
    pos, params, kw = _pair_inputs("bench", torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pairwise.energy_and_drift(pos.t().contiguous().t(), params, **kw)
    with pytest.raises(ValueError, match="params"):
        pairwise.energy_and_drift(pos, params.double(), **kw)
    wide = torch.zeros((2, 1025), device=cuda)
    with pytest.raises(ValueError, match="nop"):
        pairwise.energy_and_drift(wide, params, **dict(kw, nop=1025))


@pytest.mark.parametrize("shape", [(1024, 128), (7, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normals_kernel_matches_plain(cuda, shape, dtype):
    key, step = 0x1234_5678_9ABC, (1 << 33) + 5
    numel = int(np.prod(shape))
    words = prng.philox_words(key, step, -(-numel // 4), cuda)
    words_p = prng.philox_words_plain(key, step, -(-numel // 4), cuda)
    assert torch.equal(words, words_p)
    count = prng.normal.launch_count
    z = prng.normal(key, step, shape, dtype, cuda)
    torch.cuda.synchronize()
    assert prng.normal.launch_count == count + 1
    assert z.dtype == dtype and z.shape == shape
    z_p = prng.normal_plain(key, step, shape, dtype, cuda)
    # Equal to f32 rounding: logf/sqrtf and fma contraction may differ
    # by an ulp or two of |z| <= 6.
    torch.testing.assert_close(z, z_p, rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("numel", [1, 3, 5, 4097, 17408 * 128 + 3])
def test_normals_scale_and_out_equal_scale_times_unscaled(cuda, numel,
                                                          dtype):
    """``scale`` and ``out=`` (the samplers' form) give bit for bit
    ``scale *`` the unscaled kernel's output (torch's multiply by the
    scalar); an out with a storage offset (not 16-byte aligned) takes
    the kernel's scalar stores."""
    key, step = 0x1234_5678_9ABC, (1 << 33) + 5
    z = prng.normal(key, step, (numel,), dtype, cuda)
    for scale in (float(np.sqrt(2e-3)), 0.4, 1.0):
        buf = torch.full((numel,), float("nan"), dtype=dtype, device=cuda)
        count = prng.normal.launch_count
        got = prng.normal(key, step, (numel,), dtype, cuda, scale=scale,
                          out=buf)
        torch.cuda.synchronize()
        assert got is buf and prng.normal.launch_count == count + 1
        assert torch.equal(got, scale * z)
    flat = torch.full((numel + 1,), float("nan"), dtype=dtype, device=cuda)
    got = prng.normal(key, step, (numel,), dtype, cuda, scale=0.4,
                      out=flat[1:])
    assert torch.equal(got, 0.4 * z)
    assert torch.isnan(flat[0])


def test_box_muller_is_the_accurate_logf_form_for_every_uniform(cuda):
    """The kernels' branch-free log and folding (csrc/philox.cuh) give the
    radius, cosine and sine of the plain CUDA form (``sqrtf(-2
    logf(u1))``, +-1 multiplies) bit for bit, over all 2^24 values of
    each 24-bit uniform."""
    assert prng.box_muller_mismatches(cuda) == 0


def test_normals_rejects_bad_out(cuda):
    shape = (6, 10)
    for bad in (torch.empty((6, 11), device=cuda),
                torch.empty(shape, dtype=torch.float64, device=cuda),
                torch.empty(shape),
                torch.empty((10, 6), device=cuda).t()):
        with pytest.raises(ValueError, match="out must be"):
            prng.normal(5, 17, shape, torch.float32, cuda, out=bad)


def test_dmc_on_the_card_matches_the_cpu_replay(cuda):
    """The sampler's step with both kernels on the card against the same
    step with the plain versions on the CPU, in f64, under the same
    injected noise."""
    spec = mrbp.Spec(**dict(BENCH, boson_number=16, supercell_size=16.0))
    sampling = dmc.Sampling(spec, time_step=1e-2, max_num_walkers=64,
                            target_num_walkers=48, rng_seed=3)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(48)])
    comb_u = rng.random((10, 64))
    xi = sampling.sigma_spread * rng.standard_normal((10, 64, 16))
    on_cpu = sampling.replay_states(
        sampling.build_state(confs, device="cpu"), comb_u, xi)
    on_card = sampling.replay_states(
        sampling.build_state(confs, device=cuda), comb_u, xi)
    assert torch.equal(on_card["parent"].cpu(), on_cpu["parent"])
    for name in ("pos", "energies", "weights", "ref_energy"):
        torch.testing.assert_close(on_card[name].cpu(), on_cpu[name],
                                   rtol=1e-9, atol=1e-9)

    pairwise.energy_and_drift.launch_count = 0
    prng.normal.launch_count = 0
    blocks = sampling.blocks(sampling.build_state(confs, dtype=np.float32,
                                                  device=cuda), 16)
    props = next(blocks).iter_props
    assert np.isfinite(float(props.energy.sum() / props.weight.sum()))
    # One K1 launch per step (the build adds one) and one K2 launch.
    assert pairwise.energy_and_drift.launch_count == 16 + 1
    assert prng.normal.launch_count == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows,row_len,num_bins", [
    (17408, 128, 128),   # the density estimator at the bench shape
    (4096, 1024, 100),   # N = 1024, bins not a multiple of 32
    (333, 33, 37),
    (5, 7, 3000),        # few warps per CTA
])
def test_histogram_kernel_equals_plain(cuda, rows, row_len, num_bins,
                                       dtype):
    sc = float(num_bins) / 3
    pos = torch.as_tensor(np.random.default_rng(rows).uniform(
        -0.1 * sc, 1.1 * sc, (rows, row_len)), dtype=dtype, device=cuda)
    bin_size = torch.tensor(sc / num_bins, dtype=dtype, device=cuda)
    count = histogram.walker_histogram.launch_count
    hist = histogram.walker_histogram(pos, bin_size, num_bins)
    torch.cuda.synchronize()
    assert histogram.walker_histogram.launch_count == count + 1
    assert hist.dtype == dtype and hist.shape == (rows, num_bins)
    assert torch.equal(hist,
                       histogram.walker_histogram_plain(pos, bin_size,
                                                        num_bins))
    assert bool((hist.sum(-1) == row_len).all())


def test_histogram_kernel_at_the_g2_shape(cuda):
    """The (W, N, N) pair-distance rows of the g2 estimator at N = 128,
    128 bins of L / 256."""
    pos = torch.as_tensor(np.random.default_rng(2).uniform(
        0, 128.0, (2048, 128)), dtype=torch.float32, device=cuda)
    d = pos[:, :, None] - pos[:, None, :]
    r = (d - 128.0 * torch.round(d / 128.0)).abs()
    bin_size = torch.tensor(0.5, device=cuda)
    hist = histogram.walker_histogram(r, bin_size, 128)
    assert hist.shape == (2048, 128, 128)
    assert torch.equal(hist, histogram.walker_histogram_plain(r, bin_size,
                                                              128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_histogram_kernel_edges(cuda, dtype):
    vals = np.concatenate([np.arange(16.0), [16 - 1e-6, 0.0, 15.9999990,
                                             -0.5, -0.0, 16.0, 1e30,
                                             np.inf, -np.inf, np.nan]])
    pos = torch.as_tensor(np.tile(vals, (4, 1)), dtype=dtype, device=cuda)
    # The last five bin sizes have no finite positive reciprocal: the
    # kernel's fmod form bins them.
    subnormal = torch.finfo(dtype).smallest_normal / 2 ** 20
    for bin_size, num_bins in ((1.0, 16), (16.0 / 7, 7), (0.1, 160),
                               (0.0, 16), (-1.5, 16), (np.inf, 16),
                               (np.nan, 16), (subnormal, 16)):
        bs = torch.tensor(bin_size, dtype=dtype, device=cuda)
        assert torch.equal(
            histogram.walker_histogram(pos, bs, num_bins),
            histogram.walker_histogram_plain(pos, bs, num_bins))


#: A bin size that is not a power of two: L/256 of a supercell of 127.3.
EDGE_BIN_SIZE = 127.3 / 256


def _edge_values(bin_size: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Every edge ``k bs`` (k = 0 .. B + 1, in the bin size's dtype) and
    the floats just below and above it, +-0, negatives, NaN, +-inf and
    values past ``B bs``, in rows of 16."""
    k = torch.arange(num_bins + 2, dtype=bin_size.dtype,
                     device=bin_size.device)
    edges = k * bin_size
    inf = torch.full_like(edges, float("inf"))
    special = torch.tensor(
        [0.0, -0.0, -1e-30, -0.5, -1e30, float("nan"), float("inf"),
         -float("inf"), 1e30, 3e38], dtype=bin_size.dtype,
        device=bin_size.device)
    past = (num_bins + torch.arange(1, 7, dtype=bin_size.dtype,
                                    device=bin_size.device)) * bin_size
    vals = torch.cat([edges, torch.nextafter(edges, -inf),
                      torch.nextafter(edges, inf), special, past])
    pad = torch.arange((-vals.numel()) % 16, dtype=bin_size.dtype,
                       device=bin_size.device)
    vals = torch.cat([vals, (pad % num_bins + 0.5) * bin_size])
    return vals.reshape(-1, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num_bins", [1, 7, 128, 129])
def test_histogram_kernel_non_power_of_two_edges(cuda, num_bins, dtype):
    """The exact floor at and around every edge of a bin size that is not
    a power of two, bit-equal to the plain version's ``//``, through the
    16-byte loads and, from a view one element off, the scalar ones."""
    bin_size = torch.tensor(EDGE_BIN_SIZE, dtype=dtype, device=cuda)
    pos = _edge_values(bin_size, num_bins)
    flat = torch.cat([pos.new_zeros(1), pos.reshape(-1)])
    for rows in (pos, flat[1:].view(pos.shape)):
        hist = histogram.walker_histogram(rows, bin_size, num_bins)
        assert torch.equal(hist, histogram.walker_histogram_plain(
            rows, bin_size, num_bins))
        assert bool((hist.sum(-1) == rows.shape[-1]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num_bins", [1, 7, 128, 129, 12288])
@pytest.mark.parametrize("row_len", [1, 3, 31, 32, 33, 127, 128, 129, 1000])
def test_histogram_kernel_shapes(cuda, row_len, num_bins, dtype):
    """Row lengths across the 16-byte path's limits, bin counts from one
    to one warp's 48 KB, and row counts below the persistent grid and
    not a multiple of its tile of rows."""
    sc = num_bins * EDGE_BIN_SIZE
    bin_size = torch.tensor(EDGE_BIN_SIZE, dtype=dtype, device=cuda)
    for num_rows in (37, 2053):
        pos = torch.as_tensor(np.random.default_rng(row_len).uniform(
            -0.05 * sc, 1.05 * sc, (num_rows, row_len)), dtype=dtype,
            device=cuda)
        hist = histogram.walker_histogram(pos, bin_size, num_bins)
        assert hist.shape == (num_rows, num_bins)
        assert torch.equal(hist, histogram.walker_histogram_plain(
            pos, bin_size, num_bins))
        assert bool((hist.sum(-1) == row_len).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
def test_histogram_kernel_views_with_a_storage_offset(cuda, offset, dtype):
    """Rows that start off a 16-byte boundary take the scalar path; an
    offset of 16 bytes keeps the vector one.  Both count as the plain
    version does."""
    rows, row_len = 1000, 128
    flat = torch.as_tensor(np.random.default_rng(offset).uniform(
        0, 128.0, rows * row_len + offset), dtype=dtype, device=cuda)
    pos = flat[offset:].view(rows, row_len)
    bin_size = torch.tensor(1.0, dtype=dtype, device=cuda)
    assert torch.equal(histogram.walker_histogram(pos, bin_size, 128),
                       histogram.walker_histogram_plain(pos, bin_size, 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num_bins", [12288, 12289, 65536])
def test_histogram_kernel_beyond_one_warps_bins(cuda, num_bins, dtype):
    """The last size of the one-row-per-warp kernel and the tiled kernel
    beyond it (two tiles with scalar stores at 12,289 bins, six with
    16-byte stores at 65,536): bit-equal to the plain version at and
    around every edge of a bin size that is not a power of two, on
    random rows, and from a view one element off a 16-byte boundary."""
    bin_size = torch.tensor(EDGE_BIN_SIZE, dtype=dtype, device=cuda)
    edges = _edge_values(bin_size, num_bins)
    sc = num_bins * EDGE_BIN_SIZE
    random = torch.as_tensor(np.random.default_rng(num_bins).uniform(
        -0.05 * sc, 1.05 * sc, (37, 1000)), dtype=dtype, device=cuda)
    count = histogram.walker_histogram.launch_count
    for pos in (edges[:256], edges[-256:], random):
        flat = torch.cat([pos.new_zeros(1), pos.reshape(-1)])
        for rows in (pos, flat[1:].view(pos.shape)):
            hist = histogram.walker_histogram(rows, bin_size, num_bins)
            assert hist.shape == (rows.shape[0], num_bins)
            assert torch.equal(hist, histogram.walker_histogram_plain(
                rows, bin_size, num_bins))
            assert bool((hist.sum(-1) == rows.shape[-1]).all())
    assert histogram.walker_histogram.launch_count == count + 6
    # Every edge, in one call of many short rows.
    hist = histogram.walker_histogram(edges, bin_size, num_bins)
    assert torch.equal(hist, histogram.walker_histogram_plain(
        edges, bin_size, num_bins))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_histogram_tiled_kernel_takes_any_bin_size(cuda, dtype):
    """Bin sizes without a finite positive reciprocal take the fmod form
    in the tiled kernel too."""
    vals = np.concatenate([np.arange(16.0), [16 - 1e-6, 0.0, 15.9999990,
                                             -0.5, -0.0, 16.0, 1e30,
                                             np.inf, -np.inf, np.nan,
                                             12288.5, 20000.0]])
    pos = torch.as_tensor(np.tile(vals, (4, 1)), dtype=dtype, device=cuda)
    subnormal = torch.finfo(dtype).smallest_normal / 2 ** 20
    for bin_size in (1.0, 0.1, 0.0, -1.5, np.inf, np.nan, subnormal):
        bs = torch.tensor(bin_size, dtype=dtype, device=cuda)
        assert torch.equal(
            histogram.walker_histogram(pos, bs, 12300),
            histogram.walker_histogram_plain(pos, bs, 12300))


def test_histogram_kernel_rejects_bad_inputs(cuda):
    pos = torch.zeros((4, 8), device=cuda)
    bs = torch.tensor(1.0, device=cuda)
    with pytest.raises(ValueError, match="num_bins"):
        histogram.walker_histogram(pos, bs, 0)
    with pytest.raises(ValueError, match="bin_size"):
        histogram.walker_histogram(pos, bs.double(), 4)
    with pytest.raises(ValueError, match="bin_size"):
        histogram.walker_histogram(pos, bs.cpu(), 4)


def test_dmc_estimators_on_the_card_match_the_cpu_replay(cuda):
    """Every estimator of the sampler on the card (K1, K2, K4) against
    the same replay with the plain versions on the CPU, f64."""
    spec = mrbp.Spec(**dict(BENCH, boson_number=16, supercell_size=16.0))
    sampling = dmc.Sampling(
        spec, time_step=1e-2, max_num_walkers=64, target_num_walkers=48,
        rng_seed=3, est_every=2, cm_diffusion_est=True,
        density_est_spec=dmc.DensityEstSpec(num_bins=16,
                                            pfw_num_time_steps=8),
        ssf_est_spec=dmc.SSFEstSpec(num_modes=8),
        obd_est_spec=dmc.OBDEstSpec(num_pos=5, est_every_mult=2),
        pair_corr_est_spec=dmc.PairCorrEstSpec(num_bins=12,
                                               est_every_mult=2))
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(48)])
    comb_u = rng.random((12, 64))
    xi = sampling.sigma_spread * rng.standard_normal((12, 64, 16))
    on_cpu, aux_cpu, _ = sampling.replay_estimators(
        sampling.build_state(confs, device="cpu"), comb_u, xi)
    count = histogram.walker_histogram.launch_count
    on_card, aux_card, _ = sampling.replay_estimators(
        sampling.build_state(confs, device=cuda), comb_u, xi)
    # 6 density and 3 g2 measurements.
    assert histogram.walker_histogram.launch_count == count + 9
    assert set(on_card) == set(on_cpu) == {"density", "ssf", "obd", "g2",
                                           "cmd"}
    for name, rows in on_cpu.items():
        if name in ("density", "g2"):
            assert torch.equal(on_card[name].cpu(), rows), name
        else:
            torch.testing.assert_close(on_card[name].cpu(), rows,
                                       rtol=1e-9, atol=1e-9)
    for name, acc in aux_cpu.items():
        torch.testing.assert_close(aux_card[name].cpu(), acc, rtol=1e-9,
                                   atol=1e-9)


def _logpsi_spec(nop, kind):
    kwargs = dict(BENCH, boson_number=nop, supercell_size=float(nop))
    if kind == "free":
        kwargs.update(lattice_depth=0.0)
    elif kind == "ideal":
        kwargs.update(interaction_strength=0.0)
    elif kind == "defected":
        kwargs.update(num_defects={1: 1, 33: 3}.get(nop, 8),
                      defect_magnitude=10.0)
    return mrbp.Spec(**kwargs)


@pytest.mark.parametrize("dtype,rtol_lp,rtol_e,rtol_d,atol_d", [
    # f32: per-particle sums of up to 1023 pair terms in another order,
    # and fma contraction in the kernel.
    (torch.float32, 1e-5, 2e-5, 1e-3, 1e-4),
    (torch.float64, 1e-10, 1e-10, 1e-10, 1e-10),
])
@pytest.mark.parametrize("kind", ["bench", "free", "ideal", "defected"])
@pytest.mark.parametrize("nop", [1, 33, 64, 128, 1024])
def test_log_psi_kernel_matches_plain(cuda, nop, kind, dtype, rtol_lp,
                                      rtol_e, rtol_d, atol_d):
    spec = _logpsi_spec(nop, kind)
    static = spec.static_spec
    num_walkers = 8 if nop == 1024 else 256
    pos = torch.as_tensor(np.random.default_rng(nop).uniform(
        0, spec.supercell_size, (num_walkers, nop)), dtype=dtype,
        device=cuda)
    params = pairwise.pack_params(spec.cfc_params, dtype, cuda)
    kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep)
    count = pairwise.energy_and_drift.log_psi_launch_count
    lp, energy, drift = pairwise.energy_and_drift(pos, params,
                                                  with_log_psi=True, **kw)
    torch.cuda.synchronize()
    assert pairwise.energy_and_drift.log_psi_launch_count == count + 1
    lp_p, energy_p, drift_p = pairwise.energy_and_drift_plain(
        pos, params, with_log_psi=True, **kw)
    torch.testing.assert_close(lp, lp_p, rtol=rtol_lp, atol=rtol_lp)
    torch.testing.assert_close(energy, energy_p, rtol=rtol_e, atol=rtol_e)
    torch.testing.assert_close(drift, drift_p, rtol=rtol_d, atol=atol_d)
    if dtype == torch.float64:
        # The forward variant's energy and drift, bit for bit.
        energy_f, drift_f = pairwise.energy_and_drift(pos, params, **kw)
        assert torch.equal(energy_f, energy) and torch.equal(drift_f, drift)


#: Particle counts of the half-ring schedule: odd N (every step full),
#: even N (a last step k = N/2 taken by the first half), warp edges, and
#: the largest CTAs.
HALF_RING_NOPS = [1, 2, 3, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1000, 1024]


@pytest.mark.parametrize("dtype,rtol_lp,rtol_e,rtol_d,atol_d", [
    # f32: per-particle sums of up to 1023 pair terms in another order,
    # the approximate reciprocal and log2, and fma contraction.
    (torch.float32, 1e-5, 2e-5, 1e-3, 1e-4),
    (torch.float64, 1e-10, 1e-10, 1e-10, 1e-10),
])
@pytest.mark.parametrize("nop", HALF_RING_NOPS)
def test_half_ring_matches_plain(cuda, nop, dtype, rtol_lp, rtol_e, rtol_d,
                                 atol_d):
    """Each unordered pair once, both variants, against their plain
    versions; in f64 the two variants' energy and drift bit for bit."""
    spec = _logpsi_spec(nop, "bench")
    static = spec.static_spec
    num_walkers = 8 if nop >= 1000 else 256
    pos = torch.as_tensor(np.random.default_rng(nop + 1).uniform(
        0, spec.supercell_size, (num_walkers, nop)), dtype=dtype,
        device=cuda)
    params = pairwise.pack_params(spec.cfc_params, dtype, cuda)
    kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep)
    energy, drift = pairwise.energy_and_drift(pos, params, **kw)
    lp, energy_l, drift_l = pairwise.energy_and_drift(
        pos, params, with_log_psi=True, **kw)
    torch.cuda.synchronize()
    energy_p, drift_p = pairwise.energy_and_drift_plain(pos, params, **kw)
    lp_p, energy_lp, drift_lp = pairwise.energy_and_drift_plain(
        pos, params, with_log_psi=True, **kw)
    for got, want in ((energy, energy_p), (energy_l, energy_lp)):
        torch.testing.assert_close(got, want, rtol=rtol_e, atol=rtol_e)
    for got, want in ((drift, drift_p), (drift_l, drift_lp)):
        torch.testing.assert_close(got, want, rtol=rtol_d, atol=atol_d)
    torch.testing.assert_close(lp, lp_p, rtol=rtol_lp, atol=rtol_lp)
    if dtype == torch.float64:
        assert torch.equal(energy, energy_l) and torch.equal(drift, drift_l)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_log_psi", [False, True])
def test_pair_kernel_coincident_particles(cuda, with_log_psi, dtype):
    """Particles at one position (f32 positions coincide about once per
    2,000 walkers at the bench shape) both take the +ldz drift term, as
    sign(0) = +1 in the plain version, though the term is odd."""
    spec = _logpsi_spec(33, "bench")
    static = spec.static_spec
    pos = np.random.default_rng(4).uniform(0, 33.0, (64, 33))
    pos[:, 1::3] = pos[:, 0:-1:3]
    pos = torch.as_tensor(pos, dtype=dtype, device=cuda)
    params = pairwise.pack_params(spec.cfc_params, dtype, cuda)
    kw = dict(nop=33, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep, with_log_psi=with_log_psi)
    got = pairwise.energy_and_drift(pos, params, **kw)
    want = pairwise.energy_and_drift_plain(pos, params, **kw)
    # (rtol, atol) of log|psi|, the energy and the drift, as above.
    tols = ([(1e-5, 1e-5), (2e-5, 2e-5), (1e-3, 1e-4)]
            if dtype == torch.float32 else [(1e-10, 1e-10)] * 3)
    for g, w, (rtol, atol) in zip(got, want, tols[-len(got):]):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


def test_pair_kernel_wraps_positions_outside_the_supercell(cuda):
    """Positions outside [0, L) are wrapped into it for the pair terms:
    the same energy and drift as the plain version's rounded minimum
    image, f64."""
    spec = _logpsi_spec(64, "bench")
    static = spec.static_spec
    rng = np.random.default_rng(3)
    pos = (rng.uniform(0, 64.0, (64, 64))
           + 64.0 * rng.integers(-2, 3, (64, 64)))
    pos = torch.as_tensor(pos, dtype=torch.float64, device=cuda)
    params = pairwise.pack_params(spec.cfc_params, torch.float64, cuda)
    kw = dict(nop=64, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep)
    for got, want in zip(
            pairwise.energy_and_drift(pos, params, with_log_psi=True, **kw),
            pairwise.energy_and_drift_plain(pos, params, with_log_psi=True,
                                            **kw)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


#: (rtol, atol) of log|psi|, the energy and the drift against the plain
#: version: the single-row tests' tolerances.
PLAIN_TOLS = {torch.float32: [(1e-5, 1e-5), (2e-5, 2e-5), (1e-3, 1e-4)],
              torch.float64: [(1e-10, 1e-10)] * 3}


def _check_both_variants(pos, params, kw, equal_nan=False, log_psi=True):
    """The forward and the log variant against their plain versions
    (log|psi| too unless ``log_psi`` is False); in f64 their energy and
    drift bit for bit."""
    tols = PLAIN_TOLS[pos.dtype]
    outs = {}
    for with_log_psi in (False, True):
        got = pairwise.energy_and_drift(pos, params, **kw,
                                        with_log_psi=with_log_psi)
        want = pairwise.energy_and_drift_plain(pos, params, **kw,
                                               with_log_psi=with_log_psi)
        checked = list(zip(got, want, tols[-len(got):]))
        if with_log_psi and not log_psi:
            checked = checked[1:]
        for g, w, (rtol, atol) in checked:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan)
        outs[with_log_psi] = got
    if pos.dtype == torch.float64:
        for a, b in zip(outs[False], outs[True][1:]):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())


def _bench_params(nop, length, dtype, device, rm=None):
    """The bench model's packed vector at N = nop in a supercell of
    ``length``; ``rm`` overrides the contact cutoff slot alone."""
    spec = mrbp.Spec(**dict(BENCH, boson_number=nop,
                            supercell_size=float(length)))
    params = pairwise.pack_params(spec.cfc_params, dtype, device)
    if rm is not None:
        params[pairwise.P_RM] = rm
    static = spec.static_spec
    return params, dict(nop=nop, is_free=static.is_free,
                        is_ideal=static.is_ideal,
                        defects_sep=static.defects_sep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["bench", "free"])
def test_pair_kernel_dense(cuda, kind, dtype):
    """N = 128 in L = 16: ~6 particles within rm of each, so most warp
    steps vote and take K1's pair body, both variants.  In the bench
    model log|psi| is the difference of the one-body sum (~ +35) and the
    pair sum (~ -34), ~0.2, which the plain f32 version itself misses by
    1.7e-5, more than the relative tolerance allows at 0.2: there f32
    holds the energy and the drift, and the free gas (the pair sum alone)
    holds log|psi|."""
    params, kw = _bench_params(128, 16.0, dtype, cuda)
    kw["is_free"] = kind == "free"
    pos = torch.as_tensor(np.random.default_rng(5).uniform(
        0, 16.0, (64, 128)), dtype=dtype, device=cuda)
    assert pairwise.vote_share(pos, params, 128) > 0.5
    _check_both_variants(pos, params, kw, log_psi=(
        kind == "free" or dtype == torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_kernel_one_lane_votes(cuda, dtype):
    """Jittered lattices with every pair outside the cutoff, but for one
    pair of one walker, which one lane of one warp takes at step 1: that
    warp step alone takes K1's body."""
    nop, walkers = 64, 8
    params, kw = _bench_params(nop, nop, dtype, cuda)
    rng = np.random.default_rng(9)
    pos = np.arange(nop) + 0.5 + rng.uniform(-0.2, 0.2, (walkers, nop))
    pos[3, 37] = pos[3, 38] - 0.1
    pos = torch.as_tensor(pos, dtype=dtype, device=cuda)
    # Per walker 31 voted steps of 2 warps and the even N's last step.
    assert pairwise.vote_share(pos, params, nop) == 1 / (walkers * 63)
    _check_both_variants(pos, params, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_kernel_rm_0_with_coincident_particles(cuda, dtype):
    """With rm = 0 coincident particles still vote (the vote's cutoff is
    the least positive value) and take K1's body, which gives both the
    +ldz drift term, an infinite one, as the plain version does."""
    nop = 33
    params, kw = _bench_params(nop, nop, dtype, cuda, rm=0.0)
    pos = np.random.default_rng(4).uniform(0, float(nop), (16, nop))
    pos[:4, 7] = pos[:4, 20]
    pos = torch.as_tensor(pos, dtype=dtype, device=cuda)
    assert pairwise.vote_share(pos, params, nop) > 0.0
    _check_both_variants(pos, params, kw, equal_nan=True)
    _, drift = pairwise.energy_and_drift(pos, params, **kw)
    assert bool((drift[:4, 7] == float("inf")).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop", [1000, 1024])
def test_pair_kernel_at_1024_threads(cuda, nop, dtype):
    """The block size of 2 rings in float and 1 in double, at 4 particles
    a unit length: ~10% of warp steps vote."""
    params, kw = _bench_params(nop, nop / 4, dtype, cuda)
    pos = torch.as_tensor(np.random.default_rng(nop).uniform(
        0, nop / 4, (8, nop)), dtype=dtype, device=cuda)
    assert 0.0 < pairwise.vote_share(pos, params, nop) < 1.0
    _check_both_variants(pos, params, kw)


@pytest.mark.parametrize("with_log_psi", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop", [64, 128])
def test_pair_kernel_table_rows_equal_single_row_launches(
        cuda, nop, dtype, with_log_psi):
    """A 4-row table at N = 64 and 128: each row bit-equal to a launch on
    its rows alone."""
    per_row = 48
    pos, table, kw = _table_inputs(dtype, cuda, per_row, nop=nop)
    kw["with_log_psi"] = with_log_psi
    got = pairwise.energy_and_drift(pos, table, **kw)
    for r in range(len(SWEEP_ROWS)):
        rows = slice(r * per_row, (r + 1) * per_row)
        want = pairwise.energy_and_drift(pos[rows].contiguous(),
                                         table[r].contiguous(), **kw)
        for g, w in zip(got, want):
            assert torch.equal(g[rows], w)


def _diffuse_spec(nop, spec_kwargs=None):
    """The bench model at N = L = nop, or ``spec_kwargs`` over it."""
    return mrbp.Spec(**{**BENCH, "boson_number": nop,
                        "supercell_size": float(nop), **(spec_kwargs or {})})


def _diffuse_inputs(nop, num_walkers, dtype, device, seed=0,
                    spec_kwargs=None):
    spec = _diffuse_spec(nop, spec_kwargs)
    static = spec.static_spec
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    cpos = t(rng.uniform(0, spec.supercell_size, (num_walkers, nop)))
    params = pairwise.pack_params(spec.cfc_params, dtype, device)
    energy, drift = pairwise.energy_and_drift(cpos, params, nop=nop,
                                              is_free=False, is_ideal=False)
    kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep)
    return dict(cpos=cpos, cdrift=drift, cenergy=energy, params=params,
                dt=1e-3, sigma=float(np.sqrt(2e-3)),
                e_ref=t(8.4 * nop), rng_seed=0x1234_5678_9ABC,
                step=(1 << 33) + 7), t(rng.standard_normal(
                    (num_walkers, nop))), kw


def _min_image_err(a, b, sc):
    d = a - b
    return (d - sc * torch.round(d / sc)).abs().max().item()


def _step_diffuse(args, nop, xi=None, spec_kwargs=None):
    """The DMC step's own diffusion (``dmc.Sampling.diffuse``) on the
    fused kernel's inputs: K2's noise (or ``xi``) pre-scaled by sigma,
    then the torch move and recast, K1 and the weight."""
    cpos = args["cpos"]
    spec = _diffuse_spec(nop, spec_kwargs)
    sampling = dmc.Sampling(spec, time_step=args["dt"],
                            max_num_walkers=cpos.shape[0],
                            target_num_walkers=cpos.shape[0],
                            rng_seed=args["rng_seed"])
    assert sampling.sigma_spread == args["sigma"]
    if xi is None:
        xi = prng.normal(args["rng_seed"], args["step"], cpos.shape,
                         cpos.dtype, cpos.device)
    return sampling.diffuse(
        cpos, args["cdrift"], args["cenergy"], sampling.sigma_spread * xi,
        args["e_ref"], mrbp.cast_params(spec.cfc_params, cpos.dtype,
                                        cpos.device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop,num_walkers", [(128, 512), (13, 77),
                                             (33, 64), (2, 5)])
def test_diffuse_kernel_matches_plain(cuda, nop, num_walkers, dtype):
    """The fused diffusion kernel against its plain version (same key)
    and against the DMC step's own diffusion (K2, torch ops, K1), N not
    a multiple of 4 included: equal moved positions with the normals
    kernel's stream and with injected xi."""
    args, xi, kw = _diffuse_inputs(nop, num_walkers, dtype, cuda)
    count = pairwise.diffuse_energy_drift.launch_count
    fused = pairwise.diffuse_energy_drift(**args, **kw)
    torch.cuda.synchronize()
    assert pairwise.diffuse_energy_drift.launch_count == count + 1
    unfused = _step_diffuse(args, nop)
    plain = pairwise.diffuse_energy_drift_plain(**args, **kw)
    assert torch.equal(fused[0], unfused[0])
    assert _min_image_err(fused[0], plain[0], float(nop)) < 1e-4
    rtol = 2e-5 if dtype == torch.float32 else 1e-10
    for got, want in zip(fused[1:], unfused[1:]):
        torch.testing.assert_close(got, want, rtol=rtol, atol=rtol)
    injected = pairwise.diffuse_energy_drift(**args, xi=xi, **kw)
    injected_unfused = _step_diffuse(args, nop, xi)
    injected_plain = pairwise.diffuse_energy_drift_plain(**args, xi=xi,
                                                         **kw)
    assert torch.equal(injected[0], injected_unfused[0])
    assert torch.equal(injected[0], injected_plain[0])
    for got, want in zip(injected[1:], injected_plain[1:]):
        torch.testing.assert_close(got, want, rtol=rtol, atol=rtol)


def test_diffuse_kernel_rejects_bad_inputs(cuda):
    args, xi, kw = _diffuse_inputs(16, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="e_ref"):
        pairwise.diffuse_energy_drift(**dict(args, e_ref=args["e_ref"].cpu()),
                                      **kw)
    with pytest.raises(ValueError, match="xi"):
        pairwise.diffuse_energy_drift(**args, xi=xi[:, :8].contiguous(),
                                      **kw)


def _check_diffuse(args, xi, kw, spec_kwargs=None):
    """K3 against the DMC step's own diffusion (K2's noise, torch move
    and recast, K1, weight) and against its plain version, with K2's
    noise and with the injected ``xi`` (the plain version only with
    ``xi``: its normals are K2's to f32 rounding): moved positions bit
    for bit equal; the energy and the weight as phase J holds them, the
    drift as ``K1_F32_TOL`` (f32: sums in another order than K1's), f64
    within 1e-10.  The f32 weight may differ by what the energy's
    tolerance allows: dt / 2 times it."""
    nop = kw["nop"]
    f32 = args["cpos"].dtype == torch.float32
    for noise in (None, xi):
        count = pairwise.diffuse_energy_drift.launch_count
        got = pairwise.diffuse_energy_drift(**args, xi=noise, **kw)
        torch.cuda.synchronize()
        assert pairwise.diffuse_energy_drift.launch_count == count + 1
        wants = [_step_diffuse(args, nop, noise, spec_kwargs)]
        if noise is not None:
            wants.append(pairwise.diffuse_energy_drift_plain(
                **args, xi=noise, **kw))
        for want in wants:
            assert torch.equal(got[0], want[0])
            if f32:
                e_rtol = 2e-5
                w_rtol = max(1e-6, 0.5 * args["dt"] * e_rtol
                             * float(want[1].abs().max()))
                torch.testing.assert_close(got[1], want[1], rtol=e_rtol,
                                           atol=e_rtol)
                torch.testing.assert_close(got[2], want[2], rtol=1e-3,
                                           atol=1e-4)
                torch.testing.assert_close(got[3], want[3], rtol=w_rtol,
                                           atol=0.0)
            else:
                for g, w in zip(got[1:], want[1:]):
                    torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


#: Every block size K3's instantiations split on (128, 256, 1024
#: threads), tiles of 32 with and without padding lanes, N < 4 and N not
#: a multiple of 4; odd walker counts, so that Philox quads straddle two
#: walkers.
DIFFUSE_NOPS = (1, 2, 3, 4, 5, 31, 32, 33, 64, 96, 128, 129, 256, 512, 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop", DIFFUSE_NOPS)
def test_diffuse_kernel_at_every_block_size(cuda, nop, dtype):
    num_walkers = 33 if nop <= 128 else 17 if nop <= 256 else 5
    args, xi, kw = _diffuse_inputs(nop, num_walkers, dtype, cuda, seed=nop)
    _check_diffuse(args, xi, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_diffuse_kernel_edges(cuda, dtype):
    """Moved positions (cdrift and xi 0) at 0 and r = rm from it,
    coincident, at 0 and just below L, and a move that recasts to just
    below or to L; parents moved across either boundary."""
    nop, walkers = 33, 8
    args, xi, kw = _diffuse_inputs(nop, walkers, dtype, cuda, seed=11)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    length = np_dtype(nop)
    rm = np_dtype(BENCH["tbf_contact_cutoff"])
    cpos = args["cpos"].cpu().numpy().copy()
    cdrift = args["cdrift"].cpu().numpy().copy()
    noise = xi.cpu().numpy().copy()
    edges = [0.0, rm, np.nextafter(length, np_dtype(0)), 0.0, 7.25, 7.25,
             7.25 + rm, 12.5]
    cpos[:, :len(edges)] = np.asarray(edges, dtype=np_dtype)
    cdrift[:, :len(edges)] = 0.0
    noise[:, :len(edges)] = 0.0
    # Across L and across 0, and a move of -1e-9 that recasts to L - 1e-9
    # (in f32 to L itself, which the pair terms take as 0).
    cpos[:, 8], cdrift[:, 8], noise[:, 8] = length - np_dtype(1e-3), 10.0, 1.0
    cpos[:, 9], cdrift[:, 9], noise[:, 9] = 1e-3, -10.0, -1.0
    cpos[:, 10], cdrift[:, 10] = 0.0, 0.0
    noise[:, 10] = -1e-9 / args["sigma"]
    args = dict(args, cpos=torch.as_tensor(cpos, device=cuda),
                cdrift=torch.as_tensor(cdrift, device=cuda))
    _check_diffuse(args, torch.as_tensor(noise, device=cuda), kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_diffuse_kernel_dense(cuda, dtype):
    """N = 128 in L = 16: ~6 particles within rm of each, so most warp
    steps hold a pair inside the cutoff and take K1's pair body."""
    dense = dict(supercell_size=16.0)
    args, xi, kw = _diffuse_inputs(128, 64, dtype, cuda, seed=5,
                                   spec_kwargs=dense)
    z = args["cpos"]
    r = (z[:, :, None] - z[:, None, :]).abs()
    r = torch.minimum(r, 16.0 - r)
    assert float((r < BENCH["tbf_contact_cutoff"]).double().mean()) > 0.04
    _check_diffuse(args, xi, kw, dense)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop", [33, 64, 128, 1024])
def test_diffuse_kernel_energy_and_drift_are_k1s(cuda, nop, dtype):
    """K3 runs K1's pair loop at its moved positions: its energy and drift
    equal K1's there bit for bit."""
    args, _, kw = _diffuse_inputs(nop, 5 if nop == 1024 else 33, dtype, cuda,
                                  seed=nop + 2)
    npos, nenergy, ndrift, _ = pairwise.diffuse_energy_drift(**args, **kw)
    energy, drift = pairwise.energy_and_drift(npos, args["params"], **kw)
    assert torch.equal(nenergy, energy) and torch.equal(ndrift, drift)


@pytest.mark.parametrize("gaussian", [False, True],
                         ids=["uniform", "gaussian"])
def test_vmc_on_the_card_matches_the_cpu_replay(cuda, gaussian):
    """The Metropolis chains with the log|psi| kernel on the card
    against the same replay on the CPU, f64, on injected draws."""
    spec = mrbp.Spec(**dict(BENCH, boson_number=16, supercell_size=16.0,
                            num_defects=4, defect_magnitude=10.0))
    spread = 0.15 if gaussian else 0.4
    sampling = vmc.Sampling(spec, move_spread=spread, rng_seed=3,
                            num_walkers=64, gaussian=gaussian)
    rng = np.random.default_rng(1)
    confs = rng.uniform(0, 16.0, (64, 16))
    moves = (spread * rng.standard_normal((10, 64, 16)) if gaussian
             else rng.random((10, 64, 16)))
    accept_u = rng.random((10, 64))
    on_cpu = sampling.replay_chain(
        sampling.build_state(confs, device="cpu"), moves, accept_u)
    count = pairwise.energy_and_drift.log_psi_launch_count
    on_card = sampling.replay_chain(sampling.build_state(confs, device=cuda),
                                    moves, accept_u)
    assert pairwise.energy_and_drift.log_psi_launch_count == count + 11
    assert torch.equal(on_card[2].cpu(), on_cpu[2])
    for got, want in zip(on_card[:2], on_cpu[:2]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-12, atol=1e-12)


# -- the execution layer on the card -----------------------------------------------

PROC_SMALL = dict(
    model_spec=dict(BENCH, boson_number=16, supercell_size=16.0),
    time_step=1e-3, max_num_walkers=96, target_num_walkers=64,
    num_blocks=2, num_time_steps_block=16, burn_in_blocks=1, rng_seed=5,
    dtype="float64", est_every=2,
    density_spec=dict(num_bins=16), ssf_spec=dict(num_modes=4),
    pair_corr_spec=dict(num_bins=8, est_every_mult=2),
    itc_spec=dict(num_modes=3, num_lags=4))


def test_proc_exec_runs_on_the_card_and_traces_it(cuda, tmp_path):
    """No device named: the start state lies on the card and ``exec``
    runs there, through the kernels; ``profile_dir`` writes the first
    measured block's trace and changes nothing."""
    from phd_qmclib_torch.qmc_exec import dmc as dmc_exec

    proc = dmc_exec.Proc.from_config(PROC_SMALL)
    start = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(), proc)
    assert start.state.pos.device.type == "cuda"
    counts = (pairwise.energy_and_drift.launch_count,
              prng.normal.launch_count,
              histogram.walker_histogram.launch_count)
    plain = proc.exec(start)
    steps = 3 * 16
    assert pairwise.energy_and_drift.launch_count >= counts[0] + steps
    assert prng.normal.launch_count == counts[1] + steps
    assert histogram.walker_histogram.launch_count > counts[2]
    assert plain.state.pos.device.type == "cuda"
    traced = proc.evolve({"profile_dir": str(tmp_path / "trace")}).exec(start)
    assert (tmp_path / "trace" / "dmc_block0.trace.json").stat().st_size > 0
    np.testing.assert_array_equal(traced.data.blocks.energy.totals,
                                  plain.data.blocks.energy.totals)
    assert torch.equal(traced.state.pos, plain.state.pos)
    density = plain.data.blocks.density
    np.testing.assert_allclose(density.mean.sum(), 16.0, rtol=1e-12)


def test_vmc_proc_exec_runs_on_the_card(cuda):
    from phd_qmclib_torch.qmc_exec import vmc as vmc_exec

    proc = vmc_exec.Proc.from_config(dict(
        model_spec=PROC_SMALL["model_spec"], move_spread=0.3, num_walkers=64,
        num_blocks=2, num_steps_block=16, burn_in_blocks=1, rng_seed=3,
        dtype="float64", ssf_spec=dict(num_modes=4)))
    start = vmc_exec.ProcInput.from_model_sys_conf_spec(
        vmc_exec.ModelSysConfSpec(dist_type="REGULAR"), proc)
    assert start.state.pos.device.type == "cuda"
    count = pairwise.energy_and_drift.log_psi_launch_count
    result = proc.exec(start)
    assert pairwise.energy_and_drift.log_psi_launch_count >= count + 48
    assert result.state.pos.device.type == "cuda"
    assert np.isfinite(result.data.blocks.energy.totals).all()
    np.testing.assert_allclose(
        result.data.blocks.ss_factor.fdk_sqr_abs_part.totals[:, 0], 16.0 ** 2)


# -- K1 log's parameter VJP and the gradient optimizer ---------------------------

#: The VJP kernel against autograd of the plain version: f64 every slot
#: within 1e-9 (sums of W N^2/2 terms in another order); f32 against the
#: f64 plain version at the same inputs, each slot within 1e-3 of itself
#: plus 1e-5 of the largest slot (chip_smoke.py's K1_VJP_F32_TOL: the
#: f32 forward's drift, which the kernel takes, is good to 1e-3).
VJP_F64_RTOL = 1e-9
VJP_F32_RTOL, VJP_F32_RTOL_OF_MAX = 1e-3, 1e-5


def _vjp_spec(nop, kind):
    kwargs = dict(BENCH, boson_number=nop, supercell_size=float(nop))
    if kind == "free":
        kwargs.update(lattice_depth=0.0)
    elif kind == "ideal":
        kwargs.update(interaction_strength=0.0)
    elif kind == "defected":
        kwargs.update(num_defects=1 if nop == 5 else 8,
                      defect_magnitude=10.0)
    return mrbp.Spec(**kwargs)


def _vjp_inputs(spec, num_walkers, dtype, device, seed=0):
    """Positions in [0, L), the packed parameters, the forward's drift and
    seeded normal upstream gradients."""
    static = spec.static_spec
    kw = dict(nop=static.boson_number, is_free=static.is_free,
              is_ideal=static.is_ideal, defects_sep=static.defects_sep)
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(
        0, spec.supercell_size, (num_walkers, spec.boson_number)),
        dtype=dtype, device=device)
    g_lp, g_e = (torch.as_tensor(rng.standard_normal(num_walkers),
                                 dtype=dtype, device=device)
                 for _ in range(2))
    params = pairwise.pack_params(spec.cfc_params, dtype, device)
    _, _, drift = pairwise.energy_and_drift(pos, params, with_log_psi=True,
                                            **kw)
    return pos, params, drift, g_lp, g_e, kw


@pytest.mark.parametrize("kind", ["bench", "free", "ideal", "defected"])
@pytest.mark.parametrize("nop", [5, 64, 128])
def test_params_vjp_kernel_matches_plain_f64(cuda, nop, kind):
    *args, kw = _vjp_inputs(_vjp_spec(nop, kind), 256, torch.float64, cuda)
    count = pairwise.energy_and_drift.params_vjp_launch_count
    got = pairwise.energy_and_drift_params_vjp(*args, **kw)
    torch.cuda.synchronize()
    assert pairwise.energy_and_drift.params_vjp_launch_count == count + 1
    want = pairwise.energy_and_drift_params_vjp_plain(*args, **kw)
    assert got.shape == (pairwise.PARAMS_SIZE,)
    torch.testing.assert_close(got, want, rtol=VJP_F64_RTOL, atol=0.0)
    assert float(got[pairwise.P_RM]) == 0.0


@pytest.mark.parametrize("nop,num_walkers", [(128, 4096), (64, 4096),
                                             (33, 512), (1024, 8)])
def test_params_vjp_kernel_f32_against_the_f64_plain(cuda, nop, num_walkers):
    pos, params, drift, g_lp, g_e, kw = _vjp_inputs(
        _vjp_spec(nop, "bench"), num_walkers, torch.float32, cuda)
    got = pairwise.energy_and_drift_params_vjp(pos, params, drift, g_lp,
                                               g_e, **kw)
    want = pairwise.energy_and_drift_params_vjp_plain(
        pos.double(), params.double(), None, g_lp.double(), g_e.double(),
        **kw)
    err = (got.double() - want).abs()
    limit = VJP_F32_RTOL * want.abs() + VJP_F32_RTOL_OF_MAX * want.abs().max()
    assert bool((err <= limit).all()), (err / limit).max()


#: Particle counts that take every instantiation of the VJP kernel (128,
#: 256 and 1024 threads) and both parities of the half ring.
VJP_NOPS = [1, 2, 3, 31, 32, 33, 64, 96, 128, 129, 256, 512, 1024]


def _vjp_check(got, pos, params, g_lp, g_e, kw, dtype):
    """f64: every slot within VJP_F64_RTOL of autograd of the plain
    version; f32: within the f32 limits of the f64 plain version at the
    same inputs.  The rm slot is exactly 0 either way."""
    want = pairwise.energy_and_drift_params_vjp_plain(
        pos.double(), params.double(), None, g_lp.double(), g_e.double(),
        **kw)
    assert float(got[pairwise.P_RM]) == 0.0
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=VJP_F64_RTOL, atol=0.0)
    else:
        err = (got.double() - want).abs()
        limit = (VJP_F32_RTOL * want.abs()
                 + VJP_F32_RTOL_OF_MAX * want.abs().max())
        assert bool((err <= limit).all()), (err / limit).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop", VJP_NOPS)
def test_params_vjp_kernel_at_every_block_size(cuda, nop, dtype):
    walkers = 16 if nop >= 512 else 64
    pos, params, drift, g_lp, g_e, kw = _vjp_inputs(
        _vjp_spec(nop, "defected" if nop % 8 == 0 else "bench"), walkers,
        dtype, cuda, seed=nop)
    count = pairwise.energy_and_drift.params_vjp_launch_count
    got = pairwise.energy_and_drift_params_vjp(pos, params, drift, g_lp,
                                               g_e, **kw)
    torch.cuda.synchronize()
    assert pairwise.energy_and_drift.params_vjp_launch_count == count + 1
    _vjp_check(got, pos, params, g_lp, g_e, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop", [8, 33])
def test_params_vjp_kernel_at_the_edges(cuda, nop, dtype):
    """A pair exactly at r = rm (outside the cutoff, as in the plain
    version), coincident particles, and positions at 0 and just below L
    (a pair across the boundary) in every walker, the rest random."""
    spec = _vjp_spec(nop, "bench")
    rm = spec.tbf_contact_cutoff
    length = spec.supercell_size
    walkers = 64
    rng = np.random.default_rng(nop)
    pos = rng.uniform(0, length, (walkers, nop))
    below_l = np.nextafter(np.array(length, dtype=np.float32 if dtype ==
                                    torch.float32 else np.float64), 0.0)
    pos[:, :5] = [0.0, float(torch.tensor(rm, dtype=dtype)), 3.0, 3.0,
                  float(below_l)]
    pos_t = torch.as_tensor(pos, dtype=dtype, device=cuda)
    assert float(pos_t[0, 1] - pos_t[0, 0]) == float(
        torch.tensor(rm, dtype=dtype))
    params = pairwise.pack_params(spec.cfc_params, dtype, cuda)
    static = spec.static_spec
    kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep)
    g_lp, g_e = (torch.as_tensor(rng.standard_normal(walkers), dtype=dtype,
                                 device=cuda) for _ in range(2))
    _, _, drift = pairwise.energy_and_drift(pos_t, params,
                                            with_log_psi=True, **kw)
    got = pairwise.energy_and_drift_params_vjp(pos_t, params, drift, g_lp,
                                               g_e, **kw)
    _vjp_check(got, pos_t, params, g_lp, g_e, kw, dtype)


def test_params_vjp_rejects_bad_inputs(cuda):
    pos, params, drift, g_lp, g_e, kw = _vjp_inputs(
        _vjp_spec(16, "bench"), 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="drift"):
        pairwise.energy_and_drift_params_vjp(pos, params, drift[:, :8],
                                             g_lp, g_e, **kw)
    with pytest.raises(ValueError, match="g_e"):
        pairwise.energy_and_drift_params_vjp(pos, params, drift, g_lp,
                                             g_e.double(), **kw)


def test_solves_pack_and_kernel_gradcheck(cuda):
    """theta = (rm, orbital v0) -> the implicit solves -> pack_params ->
    K1 log forward and its VJP kernel backward -> the weighted variance:
    torch.autograd.gradcheck in f64 on the card."""
    from phd_qmclib_torch import wf_opt

    spec = _vjp_spec(16, "defected")
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 16.0, (64, 16))
    lp0 = mrbp.core_funcs(spec).log_psi(torch.as_tensor(pos),
                                        spec.cfc_params).numpy()
    opt = wf_opt.GradCSWFOptimizer(spec, pos, lp0 + 0.1 * rng.standard_normal(
        64), opt_obf_lattice_depth=True, device=cuda)
    theta = torch.tensor([0.6, 14.0], dtype=torch.float64, device=cuda,
                         requires_grad=True)
    count = pairwise.energy_and_drift.params_vjp_launch_count
    assert torch.autograd.gradcheck(opt._variance_fn, (theta,), eps=1e-6,
                                    atol=1e-7, rtol=1e-5)
    assert pairwise.energy_and_drift.params_vjp_launch_count > count


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grad_exec_launches_the_vjp_once_per_backward(cuda, monkeypatch,
                                                      dtype):
    """The gradient optimizer on the card: K1 log once per grid point and
    per evaluation, the VJP kernel once per backward, and no plain pair
    function on a CUDA tensor."""
    from phd_qmclib_torch import wf_opt

    def refuse_cuda(fn):
        def wrapped(pos, *args, **kwargs):
            assert pos.device.type == "cpu", f"{fn.__name__} on the card"
            return fn(pos, *args, **kwargs)
        return wrapped

    for name in ("energy_and_drift_plain",
                 "energy_and_drift_params_vjp_plain"):
        monkeypatch.setattr(pairwise, name,
                            refuse_cuda(getattr(pairwise, name)))
    spec = _vjp_spec(16, "bench")
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 16.0, (256, 16))
    lp0 = mrbp.core_funcs(spec).log_psi(torch.as_tensor(pos),
                                        spec.cfc_params).numpy()
    opt = wf_opt.GradCSWFOptimizer(spec, torch.as_tensor(pos, dtype=dtype),
                                   lp0, device=cuda)
    backward_calls = []
    value_and_grad = opt._value_and_grad_fn

    def counting(x):
        backward_calls.append(x)
        return value_and_grad(x)

    object.__setattr__(opt, "_value_and_grad_fn", counting)
    counts = (pairwise.energy_and_drift.log_psi_launch_count,
              pairwise.energy_and_drift.params_vjp_launch_count)
    opt_spec = opt.exec()
    torch.cuda.synchronize()
    assert backward_calls
    assert pairwise.energy_and_drift.params_vjp_launch_count \
        == counts[1] + len(backward_calls)
    assert pairwise.energy_and_drift.log_psi_launch_count \
        == counts[0] + opt.num_grid + len(backward_calls)
    lo, hi = opt.principal_function_bounds[0]
    assert lo <= opt_spec.tbf_contact_cutoff <= hi
    assert opt.principal_function(opt_spec.tbf_contact_cutoff) \
        <= opt.principal_function(spec.tbf_contact_cutoff)


# -- the row variants of a fused parameter sweep -----------------------------------

#: Four sweep rows of the bench model: couplings, cutoffs and supercells
#: (so L, the minimum image's and the bin widths') differ.
SWEEP_ROWS = ((1.0, 0.4, 128.0), (0.5, 0.35, 120.0), (2.0, 0.45, 136.0),
              (4.0, 0.3, 128.0))


def _table_inputs(dtype, device, per_row, nop=128):
    specs = [mrbp.Spec(**dict(BENCH, interaction_strength=gn,
                              tbf_contact_cutoff=rm, boson_number=nop,
                              supercell_size=sc * nop / 128))
             for gn, rm, sc in SWEEP_ROWS]
    table = torch.stack([pairwise.pack_params(s.cfc_params, dtype, device)
                         for s in specs])
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.uniform(0, s.supercell_size, (per_row, nop))
                          for s in specs])
    static = specs[0].static_spec
    kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep)
    return torch.as_tensor(pos, dtype=dtype, device=device), table, kw


@pytest.mark.parametrize("with_log_psi", [False, True])
@pytest.mark.parametrize("dtype,rtol_e,rtol_d,atol_d", [
    (torch.float32, 2e-5, 1e-3, 1e-4), (torch.float64, 1e-10, 1e-10, 1e-10)])
def test_pair_kernel_table_matches_rows_and_plain(cuda, dtype, rtol_e,
                                                  rtol_d, atol_d,
                                                  with_log_psi):
    """A 4-row table: each row bit-equal to a launch on its rows alone,
    and the whole within the single-row test's tolerances of the plain
    version."""
    per_row = 96
    pos, table, kw = _table_inputs(dtype, cuda, per_row)
    kw["with_log_psi"] = with_log_psi
    name = "log_psi_table_launch_count" if with_log_psi \
        else "table_launch_count"
    count = getattr(pairwise.energy_and_drift, name)
    got = pairwise.energy_and_drift(pos, table, **kw)
    torch.cuda.synchronize()
    assert getattr(pairwise.energy_and_drift, name) == count + 1
    for r in range(len(SWEEP_ROWS)):
        rows = slice(r * per_row, (r + 1) * per_row)
        want = pairwise.energy_and_drift(pos[rows].contiguous(),
                                         table[r].contiguous(), **kw)
        for g, w in zip(got, want):
            assert torch.equal(g[rows], w)
    plain = pairwise.energy_and_drift_plain(pos, table, **kw)
    for g, p, rtol, atol in zip(got, plain, (rtol_e,) * 2 + (rtol_d,),
                                (rtol_e,) * 2 + (atol_d,)):
        torch.testing.assert_close(g, p, rtol=rtol, atol=atol)


def test_pair_kernel_rejects_a_table_that_does_not_divide(cuda):
    pos, table, kw = _table_inputs(torch.float32, cuda, 4)
    with pytest.raises(ValueError, match="table of R"):
        pairwise.energy_and_drift(pos[:-1].contiguous(), table, **kw)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("rows,shape", [
    (4, (4352, 64)), (4, (7, 13)), (4, (5, 3)), (1, (33, 7)), (3, (33, 7)),
    (64, (33, 7)), (64, (64, 16))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normals_rows_equal_row_launches_and_plain(cuda, rows, shape, offset,
                                                  dtype):
    """1 to 64 keys and scales in one launch, at a step past 2^32: each
    row word for word its single-row launch and the plain version, also
    where a row's length is not a multiple of 4 (rows then start
    unaligned) and in an output that starts one element past a 16-byte
    boundary."""
    keys = [11, 12, (1 << 64) - 3, 1 << 40][:rows] if rows <= 4 else [
        (7919 * r + 3) << (r % 3 * 20) for r in range(rows)]
    scales = torch.tensor([0.04, 0.05, 1.0, 0.3], dtype=dtype,
                          device=cuda)[:rows] if rows <= 4 else \
        torch.linspace(0.01, 2.0, rows, dtype=dtype, device=cuda)
    step = (1 << 33) + 9
    numel = rows * shape[0] * shape[1]
    out = torch.empty(offset + numel, dtype=dtype, device=cuda)[offset:] \
        .view((rows,) + shape)
    assert (out.data_ptr() % 16 == 0) == (offset == 0)
    count = prng.normal_rows.launch_count
    prng.normal_rows(prng.key_table(keys, cuda), step, scales, out)
    torch.cuda.synchronize()
    assert prng.normal_rows.launch_count == count + 1
    plain = prng.normal_rows_plain(prng.key_table(keys, "cpu"), step,
                                   scales.cpu(), torch.empty_like(out.cpu()))
    for r, key in enumerate(keys):
        want = prng.normal(key, step, shape, dtype, cuda,
                           scale=float(scales[r]))
        assert torch.equal(out[r], want), r
        torch.testing.assert_close(out[r].cpu(), plain[r], rtol=1e-6,
                                   atol=2e-6)


@pytest.mark.parametrize("what", ["density", "g2", "tiled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_histogram_groups_equal_group_launches_and_plain(cuda, what, dtype):
    """Four bin widths (one per sweep row) in one launch, at the density
    shape, the g2 shape (rows of distances) and past the one-warp bins:
    each group bit-equal to a launch on its rows alone, and the whole to
    the plain version."""
    sizes = torch.tensor([sc for _, _, sc in SWEEP_ROWS], dtype=dtype,
                         device=cuda)
    rng = np.random.default_rng(5)
    if what == "g2":
        pos = rng.uniform(0, 68, (4, 256, 64, 64))
        bins, widths = 128, 0.5 * sizes / 128
    else:
        pos = rng.uniform(0, 136, (4, 1088, 64))
        bins = 13000 if what == "tiled" else 128
        widths = sizes / bins
    pos = torch.as_tensor(pos, dtype=dtype, device=cuda)
    table = widths.view((4,) + (1,) * (pos.dim() - 1)).contiguous()
    count = histogram.walker_histogram.group_launch_count
    got = histogram.walker_histogram(pos, table, bins)
    torch.cuda.synchronize()
    assert histogram.walker_histogram.group_launch_count == count + 1
    for r in range(4):
        assert torch.equal(got[r], histogram.walker_histogram(
            pos[r], widths[r], bins))
    assert torch.equal(got, histogram.walker_histogram_plain(pos, table,
                                                             bins))


def test_fused_step_on_the_card_matches_the_cpu_replay(cuda):
    """The fused step of three rows (coupling, supercell and time step
    differ) with K1's table and the rows' controllers on the card, in
    f64, against the same fused step on the CPU under the same injected
    draws."""
    from phd_qmclib_torch.parallel import ParamSweep

    rows = tuple(dmc.Sampling(
        mrbp.Spec(**dict(BENCH, interaction_strength=gn, boson_number=16,
                         supercell_size=sc)), dt, 64, 48, rng_seed=3)
        for gn, sc, dt in ((1.0, 16.0, 1e-2), (2.0, 16.0, 2e-2),
                           (0.5, 18.0, 1e-2)))
    sweep = ParamSweep(rows)
    rng = np.random.default_rng(0)
    confs = [rng.uniform(0, s.model_spec.supercell_size, (48, 16))
             for s in rows]
    comb_u = rng.random((10, 3, 64))
    xi = 0.1 * rng.standard_normal((10, 3, 64, 16))
    on_cpu = sweep.replay_states(sweep.build_states(
        confs, dtype=np.float64, device="cpu"), comb_u, xi)
    count = pairwise.energy_and_drift.table_launch_count
    on_card = sweep.replay_states(sweep.build_states(
        confs, dtype=np.float64, device=cuda), comb_u, xi)
    assert pairwise.energy_and_drift.table_launch_count == count + 10
    assert torch.equal(on_card["parent"].cpu(), on_cpu["parent"])
    # The single-row replay's tolerance (f64 sums in another order).
    for name in ("pos", "energies", "weights", "ref_energy"):
        torch.testing.assert_close(on_card[name].cpu(), on_cpu[name],
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_that_differ_in_dt_equal_their_standalone_runs(cuda, dtype):
    """A fused sweep whose rows differ in the time step: each row's
    controller divides by its dt as torch's scalar division does on the
    card (the multiply by the double's reciprocal rounded to the
    tensor's type), so each row equals its standalone run bit for bit."""
    from phd_qmclib_torch.parallel import ParamSweep
    from phd_qmclib_torch.samplers.dmc import _rows_divisor

    dts = (4e-3, 2e-3, 1e-3, 5e-4)
    x = torch.as_tensor(np.random.default_rng(1).uniform(-0.2, 0.2, 10 ** 5),
                        dtype=dtype, device=cuda).view(4, -1)
    divisor = _rows_divisor(dts, dtype, cuda)
    got = divisor.divide(x.T).T
    for r, dt in enumerate(dts):
        assert torch.equal(got[r], x[r] / dt)

    spec = mrbp.Spec(**dict(BENCH, boson_number=16, supercell_size=16.0))
    rows = tuple(dmc.Sampling(spec, dt, 64, 48, rng_seed=5 + r)
                 for r, dt in enumerate(dts))
    sweep = ParamSweep(rows)
    rng = np.random.default_rng(2)
    confs = [rng.uniform(0, 16.0, (48, 16)) for _ in rows]
    fused = list(zip(range(3), sweep.blocks(
        sweep.build_states(confs, dtype=dtype, device=cuda), 64)))
    for r, s in enumerate(rows):
        alone = s.blocks(s.build_state(confs[r], dtype=dtype, device=cuda),
                         64)
        for _, block in fused:
            one = next(alone)
            for name in ("energy", "weight", "num_walkers", "ref_energy",
                         "accum_energy"):
                assert torch.equal(getattr(block.iter_props, name)[:, r],
                                   getattr(one.iter_props, name)), name


# -- the OBDM grid -------------------------------------------------------------

def _obd_inputs(nop, kind, num_walkers, dtype, device, num_pos=32, seed=0,
                span=(0.0, 1.0)):
    """The spec of ``_logpsi_spec`` (defects do not enter the trial
    function; "free ideal" is both), walkers uniform over ``span`` times
    L and the estimator's grid of ``num_pos`` offsets over [0, L/2]."""
    spec = _logpsi_spec(nop, kind) if kind != "free ideal" else mrbp.Spec(
        **dict(BENCH, boson_number=nop, supercell_size=float(nop),
               lattice_depth=0.0, interaction_strength=0.0))
    length = spec.supercell_size
    pos = np.random.default_rng(seed).uniform(
        span[0] * length, span[1] * length, (num_walkers, nop))
    offsets = np.linspace(0.0, 0.5 * length, num_pos)
    funcs = mrbp.core_funcs(spec)
    return (funcs, torch.as_tensor(offsets, dtype=dtype, device=device),
            torch.as_tensor(pos, dtype=dtype, device=device),
            mrbp.cast_params(spec.cfc_params, dtype, device))


#: f64 kernel against the f64 plain version: the same formulas, the pair
#: sums in another order.
OBD_F64_TOL = 1e-12
#: The JAX package's OBDM grid at fixed inputs, made on the CPU by
#: ``fixtures/make_obd_grid_jax.py``.
OBD_JAX_FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
                   / "obd_grid_jax.npz")


@pytest.mark.parametrize("num_pos", [1, 5, 32, 37])
@pytest.mark.parametrize("kind", ["bench", "free", "ideal", "free ideal"])
@pytest.mark.parametrize("nop,num_walkers", [(1, 64), (2, 64), (33, 64),
                                             (128, 96), (128, 1),
                                             (1024, 4)])
def test_obd_kernel_matches_plain_f64(cuda, nop, num_walkers, kind,
                                      num_pos):
    """Every N the kernel's schedule treats apart (one particle, a pair,
    a warp and one, the production width, the largest CTA), one walker,
    and offset counts below, at and past one warp's 32 lanes: within
    1e-12 of the plain version, and exactly 1 at offset 0."""
    funcs, offsets, pos, cfc = _obd_inputs(nop, kind, num_walkers,
                                           torch.float64, cuda, num_pos)
    count = pairwise.obd_grid.launch_count
    got = funcs.one_body_density_grid(offsets, pos, cfc)
    torch.cuda.synchronize()
    assert pairwise.obd_grid.launch_count == count + 1
    assert got.shape == (num_walkers, num_pos)
    want = funcs.one_body_density_grid_plain(offsets, pos, cfc)
    torch.testing.assert_close(got, want, rtol=OBD_F64_TOL, atol=OBD_F64_TOL)
    # n1(0) = 1 per walker, so the column sums to the walker count.
    assert torch.equal(got[:, 0], torch.ones_like(got[:, 0]))


@pytest.mark.parametrize("name", ["bench", "defected", "free", "ideal"])
def test_obd_kernel_matches_the_jax_package_f64(cuda, name):
    """The dispatched grid on the card in f64 against the JAX package's
    own on the CPU, at the same inputs: ``fixtures/obd_grid_jax.npz``
    (N = 128, 8 walkers, the estimator's 32 offsets, the last exactly
    L/2), which ``test_torch_estimators.py`` keeps equal to what the JAX
    package computes there."""
    with np.load(OBD_JAX_FIXTURE) as fixture:
        kwargs = json.loads(str(fixture[f"{name}_spec"]))
        pos, offsets, want = (fixture[f"{name}_{key}"]
                              for key in ("pos", "offsets", "obd"))
    spec = mrbp.Spec(**kwargs)
    count = pairwise.obd_grid.launch_count
    got = mrbp.core_funcs(spec).one_body_density_grid(
        torch.as_tensor(offsets, device=cuda),
        torch.as_tensor(pos, device=cuda),
        mrbp.cast_params(spec.cfc_params, torch.float64, cuda))
    torch.cuda.synchronize()
    assert pairwise.obd_grid.launch_count == count + 1
    torch.testing.assert_close(got.cpu(), torch.as_tensor(want),
                               rtol=OBD_F64_TOL, atol=OBD_F64_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_obd_kernel_at_offsets_outside_and_on_the_edge(cuda, dtype):
    """Positions across (-L, 2L) and the grid's last offset exactly L/2:
    the kernel wraps them as the plain version's minimum image does."""
    funcs, offsets, pos, cfc = _obd_inputs(64, "bench", 128, torch.float64,
                                           cuda, span=(-1.0, 2.0))
    assert float(offsets[-1]) == 32.0
    if dtype == torch.float64:
        torch.testing.assert_close(
            funcs.one_body_density_grid(offsets, pos, cfc),
            funcs.one_body_density_grid_plain(offsets, pos, cfc),
            rtol=OBD_F64_TOL, atol=OBD_F64_TOL)
        return
    # The f64 version at the f32 positions is the oracle of both f32 ones.
    pos32, off32 = pos.float(), offsets.float()
    cfc32 = mrbp.cast_params(cfc, torch.float32, cuda)
    want = funcs.one_body_density_grid_plain(off32.double(), pos32.double(),
                                             cfc)
    gap = _obd_gap(funcs.one_body_density_grid(off32, pos32, cfc32), want)
    plain_gap = _obd_gap(funcs.one_body_density_grid_plain(off32, pos32,
                                                           cfc32), want)
    assert gap <= 4 * plain_gap, (gap, plain_gap)


def _obd_gap(got, want) -> float:
    return float((got.double() - want).abs().max())


@pytest.mark.parametrize("kind", ["bench", "free"])
@pytest.mark.parametrize("nop,num_walkers", [(64, 1024), (128, 512)])
def test_obd_kernel_f32_against_the_f64_plain(cuda, nop, num_walkers, kind):
    """f32 at the two cells' widths: the kernel's largest gap from the f64
    plain version at the same (f32) inputs is at most 4 times the plain
    f32 version's own (the approximate log2 and the pair sums' order
    against torch's log and reduction)."""
    funcs, offsets, pos, cfc = _obd_inputs(nop, kind, num_walkers,
                                           torch.float32, cuda, seed=nop)
    want = funcs.one_body_density_grid_plain(
        offsets.double(), pos.double(),
        mrbp.cast_params(cfc, torch.float64, cuda))
    got = funcs.one_body_density_grid(offsets, pos, cfc)
    plain = funcs.one_body_density_grid_plain(offsets, pos, cfc)
    gap, plain_gap = _obd_gap(got, want), _obd_gap(plain, want)
    assert 0 < gap <= 4 * plain_gap, (gap, plain_gap)
    assert torch.equal(got[:, 0], torch.ones_like(got[:, 0]))


@pytest.mark.parametrize("shared_grid", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_obd_kernel_rows_equal_their_single_row_launches(cuda, dtype,
                                                         shared_grid):
    """A fused sweep's three rows (coupling, cutoff and supercell differ;
    the grid per row, or one grid shared) in one launch: each row bit for
    bit its launch alone, and in f64 within 1e-12 of the plain version."""
    specs = [mrbp.Spec(**dict(BENCH, interaction_strength=gn,
                              tbf_contact_cutoff=rm, boson_number=64,
                              supercell_size=sc / 2))
             for gn, rm, sc in SWEEP_ROWS[:3]]
    rng = np.random.default_rng(6)
    pos = torch.as_tensor(np.stack([
        rng.uniform(0, s.supercell_size, (40, 64)) for s in specs]),
        dtype=dtype, device=cuda)
    grids = [np.linspace(0.0, 30.0 if shared_grid else s.supercell_size / 2,
                         32) for s in specs]
    szs = torch.as_tensor(grids[0] if shared_grid else np.stack(
        grids, axis=1)[..., None, None], dtype=dtype, device=cuda)
    cfc = dmc._rows_cfc(specs, dtype, cuda)
    funcs = mrbp.core_funcs(specs[0])
    count = pairwise.obd_grid.table_launch_count
    got = funcs.one_body_density_grid(szs, pos, cfc)
    torch.cuda.synchronize()
    assert pairwise.obd_grid.table_launch_count == count + 1
    assert got.shape == (3, 40, 32)
    # The samplers' table, packed row by row, gives the same rows.
    table = torch.stack([pairwise.pack_params(
        mrbp.cast_params(s.cfc_params, dtype, cuda), dtype, cuda)
        for s in specs])
    got_table = funcs.one_body_density_grid(szs, pos, cfc, table)
    for r, spec in enumerate(specs):
        alone = funcs.one_body_density_grid(
            torch.as_tensor(grids[r], dtype=dtype, device=cuda), pos[r],
            mrbp.cast_params(spec.cfc_params, dtype, cuda))
        assert torch.equal(got[r], alone), r
        assert torch.equal(got_table[r], alone), r
    if dtype == torch.float64:
        torch.testing.assert_close(
            got, funcs.one_body_density_grid_plain(szs, pos, cfc),
            rtol=OBD_F64_TOL, atol=OBD_F64_TOL)


def test_obd_kernel_rejects_bad_inputs(cuda):
    funcs, offsets, pos, cfc = _obd_inputs(64, "bench", 8, torch.float32,
                                           cuda)
    params = pairwise.pack_params(cfc, torch.float32, cuda)
    kw = dict(nop=64, is_free=False, is_ideal=False)
    with pytest.raises(ValueError, match="contiguous"):
        pairwise.obd_grid(offsets, pos.t().contiguous().t(), params, **kw)
    with pytest.raises(ValueError, match="params"):
        pairwise.obd_grid(offsets, pos, params.double(), **kw)
    with pytest.raises(ValueError, match="offsets"):
        pairwise.obd_grid(offsets.double(), pos, params, **kw)
    with pytest.raises(ValueError, match="offsets"):
        pairwise.obd_grid(offsets, pos, params[None].expand(2, -1)
                          .contiguous(), **kw)
    with pytest.raises(ValueError, match="params"):
        pairwise.obd_grid(offsets[None].expand(3, -1).contiguous(), pos,
                          params[None].expand(3, -1).contiguous(), **kw)
    wide = torch.zeros((2, 1025), device=cuda)
    with pytest.raises(ValueError, match="nop"):
        pairwise.obd_grid(offsets, wide, params, **dict(kw, nop=1025))


# -- the S(k) harmonics --------------------------------------------------------

SSF_MODES = [1, 2, 3, 32, 64, 65]
SSF_NOPS = [1, 2, 37, 64, 128]
#: The f64 kernel against the f64 plain version, relative to each slot's
#: scale (N^2 for |rho_k|^2, N for Re/Im rho_k): the same elements, the
#: particle sums in another order.
SSF_F64_RTOL = 1e-12
#: The JAX package's S(k) parts at fixed inputs, made on the CPU by
#: ``fixtures/make_ssf_harmonics_jax.py``.
SSF_JAX_FIXTURE = (pathlib.Path(__file__).parent / "fixtures"
                   / "ssf_harmonics_jax.npz")


def _ssf_inputs(nop, num_walkers, dtype, device, seed=0, length=None,
                span=(-1.0, 2.0)):
    """Walkers uniform over ``span`` times L (the samplers' positions lie
    in [0, L); the recurrence takes any)."""
    length = float(nop) if length is None else length
    spec = mrbp.Spec(**dict(BENCH, boson_number=nop, supercell_size=length))
    pos = np.random.default_rng(seed).uniform(
        span[0] * length, span[1] * length, (num_walkers, nop))
    return (mrbp.core_funcs(spec),
            torch.as_tensor(pos, dtype=dtype, device=device),
            mrbp.cast_params(spec.cfc_params, dtype, device))


def _ssf_close(got, want, nop, rtol):
    torch.testing.assert_close(got[..., 0], want[..., 0], rtol=rtol,
                               atol=rtol * nop ** 2)
    torch.testing.assert_close(got[..., 1:], want[..., 1:], rtol=rtol,
                               atol=rtol * nop)


def _ssf_reorder_tol(want, nop):
    """How far two sums of the same N float32 elements can lie apart, in
    any two orders: each within gamma_{N-1} sum_i |x_i| of the exact sum,
    every element within 1.01 of 0 (cos and sin, and the recurrence's
    rounding, under 1e-2 at 65 modes); then |rho|^2 = re^2 + im^2 through
    the squares, and its three roundings on each side."""
    u = 2.0 ** -24
    gamma = (nop - 1) * u / (1 - (nop - 1) * u)
    d = 2 * gamma * 1.01 * nop
    re, im = want[..., 1].abs(), want[..., 2].abs()
    d0 = 2 * (re + im) * d + 2 * d * d + 6 * u * (re ** 2 + im ** 2 + 4 * d)
    return d0, d


@pytest.mark.parametrize("num_modes", SSF_MODES)
@pytest.mark.parametrize("nop", SSF_NOPS)
def test_ssf_kernel_matches_plain_f64(cuda, nop, num_modes):
    """Each N the warp treats apart (one particle, a pair, a warp and
    five, two and four particles a lane) and M below, at and past one and
    two chunks of 32 modes: within 1e-12 of the plain version, the k = 0
    mode exact; with one or two particles, where no order of the sum
    differs, bit for bit."""
    funcs, pos, cfc = _ssf_inputs(nop, 48, torch.float64, cuda, seed=nop)
    count = ssf.ssf_harmonics.launch_count
    got = funcs.fourier_density_parts_harmonics(num_modes, pos, cfc)
    torch.cuda.synchronize()
    assert ssf.ssf_harmonics.launch_count == count + 1
    assert got.shape == (48, num_modes, 3)
    want = funcs.fourier_density_parts_harmonics_plain(num_modes, pos, cfc)
    _ssf_close(got, want, nop, SSF_F64_RTOL)
    assert torch.equal(got[:, 0], want[:, 0])
    if nop <= 2:
        assert torch.equal(got, want)


@pytest.mark.parametrize("num_modes", SSF_MODES)
@pytest.mark.parametrize("nop", SSF_NOPS)
def test_ssf_kernel_f32_within_the_reordering_bound(cuda, nop, num_modes):
    """f32: the kernel rounds each element as the plain version does, so
    the two differ by the order of the particle sums alone
    (``_ssf_reorder_tol``), and not at all with one or two particles."""
    funcs, pos, cfc = _ssf_inputs(nop, 256, torch.float32, cuda, seed=nop)
    got = funcs.fourier_density_parts_harmonics(num_modes, pos, cfc)
    want = funcs.fourier_density_parts_harmonics_plain(num_modes, pos, cfc)
    if nop <= 2:
        assert torch.equal(got, want)
        return
    d0, d = _ssf_reorder_tol(want, nop)
    assert bool(((got[..., 0] - want[..., 0]).abs() <= d0).all())
    assert float((got[..., 1:] - want[..., 1:]).abs().max()) <= d
    assert torch.equal(got[:, 0], want[:, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssf_kernel_at_the_cells_shapes(cuda, dtype):
    """The sk, variational and production shapes' widths and modes (a
    slice of their walkers): within the f32 reordering bound, or 1e-12
    in f64, of the plain version; positions in [0, L), as the samplers
    keep them."""
    for nop, num_modes in ((64, 32), (64, 64), (128, 64)):
        funcs, pos, cfc = _ssf_inputs(nop, 2048, dtype, cuda, seed=3,
                                      span=(0.0, 1.0))
        got = funcs.fourier_density_parts_harmonics(num_modes, pos, cfc)
        want = funcs.fourier_density_parts_harmonics_plain(num_modes, pos,
                                                           cfc)
        if dtype == torch.float64:
            _ssf_close(got, want, nop, SSF_F64_RTOL)
            continue
        d0, d = _ssf_reorder_tol(want, nop)
        assert bool(((got[..., 0] - want[..., 0]).abs() <= d0).all())
        assert float((got[..., 1:] - want[..., 1:]).abs().max()) <= d


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssf_pair_is_the_parts_slots_bit_for_bit(cuda, dtype):
    """The ITC amplitudes are slots 1-2 of the same kernel's output, one
    launch each."""
    funcs, pos, cfc = _ssf_inputs(64, 100, dtype, cuda)
    count = ssf.ssf_harmonics.launch_count
    parts = funcs.fourier_density_parts_harmonics(33, pos, cfc)
    pair = funcs.fourier_density_reim_harmonics(33, pos, cfc)
    torch.cuda.synchronize()
    assert ssf.ssf_harmonics.launch_count == count + 2
    assert pair.shape == (100, 33, 2)
    assert torch.equal(pair, parts[..., 1:3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssf_kernel_without_walkers(cuda, dtype):
    funcs, pos, cfc = _ssf_inputs(16, 0, dtype, cuda)
    counts = (ssf.ssf_harmonics.launch_count,
              ssf.ssf_harmonics.table_launch_count)
    got = funcs.fourier_density_parts_harmonics(5, pos, cfc)
    assert got.shape == (0, 5, 3) and got.device.type == "cuda"
    assert funcs.fourier_density_reim_harmonics(5, pos, cfc).shape \
        == (0, 5, 2)
    assert (ssf.ssf_harmonics.launch_count,
            ssf.ssf_harmonics.table_launch_count) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ssf_kernel_rows_equal_their_single_row_launches(cuda, dtype):
    """A fused sweep's four rows at fixed N and four L (a density scan)
    in one launch of the table: each row bit for bit its launch alone, and
    within 1e-12 of the plain version in f64."""
    lengths = (64.0, 60.5, 70.0, 48.0)
    specs = [mrbp.Spec(**dict(BENCH, boson_number=64, supercell_size=sc))
             for sc in lengths]
    rng = np.random.default_rng(7)
    pos = torch.as_tensor(np.stack([
        rng.uniform(0, sc, (40, 64)) for sc in lengths]), dtype=dtype,
        device=cuda)
    cfc = dmc._rows_cfc(specs, dtype, cuda)
    funcs = mrbp.core_funcs(specs[0])
    count = ssf.ssf_harmonics.table_launch_count
    got = funcs.fourier_density_parts_harmonics(40, pos, cfc)
    torch.cuda.synchronize()
    assert ssf.ssf_harmonics.table_launch_count == count + 1
    assert got.shape == (4, 40, 40, 3)
    for r, spec in enumerate(specs):
        alone = funcs.fourier_density_parts_harmonics(
            40, pos[r], mrbp.cast_params(spec.cfc_params, dtype, cuda))
        assert torch.equal(got[r], alone), r
    want = funcs.fourier_density_parts_harmonics_plain(40, pos, cfc)
    if dtype == torch.float64:
        _ssf_close(got, want, 64, SSF_F64_RTOL)
    else:
        d0, d = _ssf_reorder_tol(want, 64)
        assert float((got[..., 1:] - want[..., 1:]).abs().max()) <= d


@pytest.mark.parametrize("name", ["odd", "production", "sk"])
def test_ssf_kernel_matches_the_jax_package_f64(cuda, name):
    """The dispatched S(k) parts on the card in f64 against the JAX
    package's own on the CPU, at the same inputs:
    ``fixtures/ssf_harmonics_jax.npz`` (N = 128 at 64 modes, 64 at 32,
    37 at 65 with L = 40.5 and positions across (-L, 2L)), which
    ``test_torch_estimators.py`` keeps equal to what the JAX package
    computes there."""
    with np.load(SSF_JAX_FIXTURE) as fixture:
        kwargs = json.loads(str(fixture[f"{name}_spec"]))
        num_modes = int(fixture[f"{name}_modes"])
        pos, want = fixture[f"{name}_pos"], fixture[f"{name}_parts"]
    spec = mrbp.Spec(**kwargs)
    count = ssf.ssf_harmonics.launch_count
    got = mrbp.core_funcs(spec).fourier_density_parts_harmonics(
        num_modes, torch.as_tensor(pos, device=cuda),
        mrbp.cast_params(spec.cfc_params, torch.float64, cuda))
    torch.cuda.synchronize()
    assert ssf.ssf_harmonics.launch_count == count + 1
    _ssf_close(got.cpu(), torch.as_tensor(want), kwargs["boson_number"],
               SSF_F64_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("length", [1.0, 3.0, 40.5, 60.0, 127.3])
@pytest.mark.parametrize("nop", [1, 2])
def test_ssf_kernel_divides_as_the_plain_version(cuda, nop, length, dtype):
    """With one or two particles no order of the sum differs, so every
    mode is bit for bit the plain version's: the kernel's k_1 = 2 pi / L
    is torch's division, and each element is rounded alike."""
    funcs, pos, cfc = _ssf_inputs(nop, 64, dtype, cuda, length=length)
    got = funcs.fourier_density_parts_harmonics(65, pos, cfc)
    assert torch.equal(got, funcs.fourier_density_parts_harmonics_plain(
        65, pos, cfc))


def test_ssf_kernel_rejects_bad_inputs(cuda):
    pos = torch.zeros((8, 64), device=cuda)
    lengths = torch.full((1,), 64.0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ssf.ssf_harmonics(torch.zeros((64, 8), device=cuda).t(), lengths,
                          num_modes=4)
    with pytest.raises(ValueError, match="table"):
        ssf.ssf_harmonics(pos, lengths.cpu(), num_modes=4)
    with pytest.raises(ValueError, match="table"):
        ssf.ssf_harmonics(pos, lengths.double(), num_modes=4)
    with pytest.raises(ValueError, match="table"):
        ssf.ssf_harmonics(pos, lengths.expand(3).contiguous(), num_modes=4)
    with pytest.raises(ValueError, match="shape"):
        ssf.ssf_harmonics(torch.zeros((2, 1025), device=cuda), lengths,
                          num_modes=4)


@pytest.mark.parametrize("est_every", [1, 4])
def test_vmc_on_the_card_measures_s_k_through_the_kernel(cuda, est_every):
    """Every S(k) evaluation of a VMC block on the card is one launch:
    each step's proposal in the every-step mode, each measured chunk in
    the chunked one, and the seed of the state's parts."""
    spec = mrbp.Spec(**dict(BENCH, boson_number=64, supercell_size=64.0))
    confs = np.random.default_rng(1).uniform(0, 64.0, (256, 64))
    sampling = vmc.Sampling(spec, move_spread=0.3, num_walkers=256,
                            rng_seed=3, est_every=est_every,
                            ssf_est_spec=vmc.SSFEstSpec(num_modes=32))
    count = ssf.ssf_harmonics.launch_count
    state = sampling.build_state(confs.astype(np.float32), device=cuda)
    assert ssf.ssf_harmonics.launch_count == count + 1
    block = next(sampling.blocks(16, state))
    torch.cuda.synchronize()
    assert ssf.ssf_harmonics.launch_count == count + 1 + 16 // est_every
    assert torch.equal(block.iter_ssf[:, 0, 1],
                       torch.full_like(block.iter_ssf[:, 0, 1], 64 * 256))
