"""The hand-written CUDA kernels against their plain torch versions.

Needs an NVIDIA Hopper GPU and ``nvcc`` (the kernels build for
``sm_90a`` at first use); without a GPU every test skips.  Run on the
card with::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(``tests/conftest.py`` imports the JAX package, which the GPU host need
not have; this file imports only the port.)
"""
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import histogram, pairwise, prng
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


def _diffuse_inputs(nop, num_walkers, dtype, device, seed=0):
    spec = mrbp.Spec(**dict(BENCH, boson_number=nop,
                            supercell_size=float(nop)))
    static = spec.static_spec
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    cpos = t(rng.uniform(0, nop, (num_walkers, nop)))
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


def _step_diffuse(args, nop, xi=None):
    """The DMC step's own diffusion (``dmc.Sampling.diffuse``) on the
    fused kernel's inputs: K2's noise (or ``xi``) pre-scaled by sigma,
    then the torch move and recast, K1 and the weight."""
    cpos = args["cpos"]
    spec = mrbp.Spec(**dict(BENCH, boson_number=nop,
                            supercell_size=float(nop)))
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
