"""The kernels' launch path, on the CPU: K2's ``scale``/``out=`` forms
against its plain version, the checks of ``out``, the persistent grids
of K2 and K4 (every tile and every row exactly once), and the samplers'
scaled noise drawn into one buffer per run.

The kernels themselves run on the card
(``tests/test_torch_cuda_kernels.py``): there ``scale``/``out=`` must be
bit for bit ``scale *`` the unscaled kernel's output, as here.
"""
import math

import numpy as np
import pytest
import torch

from phd_qmclib_torch import utils
from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import _build, histogram, prng
from phd_qmclib_torch.samplers import dmc, vmc

torch.set_num_threads(1)

SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0, interaction_strength=1.0,
            boson_number=8, supercell_size=8.0, tbf_contact_cutoff=0.4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(6, 10), (7, 13), (1,), (3, 5, 7)])
def test_scaled_out_form_equals_scale_times_plain(shape, dtype):
    """``normal(..., scale=s, out=buf)`` is bit for bit ``s *
    normal_plain(...)`` (torch's multiply by the scalar in ``dtype``), and
    it returns ``buf``."""
    key, step = (7 << 32) + 3, (1 << 33) + 11
    for scale in (math.sqrt(2e-3), 0.4, 1.0, 3.0):
        buf = torch.full(shape, math.nan, dtype=dtype)
        got = prng.normal(key, step, shape, dtype, device="cpu", scale=scale,
                          out=buf)
        assert got is buf
        want = scale * prng.normal_plain(key, step, shape, dtype)
        assert torch.equal(got, want)
        assert torch.equal(prng.normal(key, step, shape, dtype, device="cpu",
                                       scale=scale), want)
    assert torch.equal(prng.normal(key, step, shape, dtype, device="cpu"),
                       prng.normal_plain(key, step, shape, dtype))


def test_scaled_f32_is_the_f32_multiply():
    """In f32 the scale is cast to f32 before the multiply, as torch
    multiplies an f32 tensor by a Python float: not the f64 product
    rounded once."""
    shape, scale = (64, 128), math.sqrt(2e-3)
    z = prng.normal_plain(1, 2, shape)
    got = prng.normal(1, 2, shape, device="cpu", scale=scale)
    assert torch.equal(got, z * torch.tensor(scale, dtype=torch.float32))


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.empty((6, 11)), "out must be"),
    (lambda: torch.empty((6, 10), dtype=torch.float64), "out must be"),
    (lambda: torch.empty((10, 6)).t(), "out must be"),
    (lambda: torch.empty((6, 10), device="meta"), "out must be"),
])
def test_bad_out_raises(bad, match):
    with pytest.raises(ValueError, match=match):
        prng.normal(5, 17, (6, 10), torch.float32, device="cpu", out=bad())


def test_out_on_another_device_than_asked_raises():
    with pytest.raises(ValueError, match="out must be"):
        prng.normal(5, 17, (6, 10), torch.float32, device="meta",
                    out=torch.empty((6, 10)))


def test_output_template_only_for_a_fixed_device():
    """The allocating form's cached template: kept for a device with an
    index (or the CPU), never for ``"cuda"``, which names whatever device
    is current at the call."""
    assert prng._like(torch.float32, "cuda") is None
    assert prng._like(torch.float64, torch.device("cuda")) is None
    like = prng._like(torch.float64, "cpu")
    assert like.dtype == torch.float64 and like.device.type == "cpu"
    assert prng._like(torch.float64, torch.device("cpu")).numel() == 0


def test_transform_check_needs_the_card():
    with pytest.raises(ValueError, match="no kernel"):
        prng.box_muller_mismatches("cpu")


@pytest.mark.parametrize("key,step", [(-1, 0), (0, -1), (1 << 64, 0),
                                      (0, 1 << 64)])
def test_keys_outside_64_bits_raise(key, step):
    with pytest.raises(ValueError, match="64-bit"):
        prng.check_key(key, step)
    assert prng.check_key(1, (1 << 64) - 1) == (1, (1 << 64) - 1)


def _tiles_by_cta(num_tiles: int, grid: int):
    """The tiles each CTA of a persistent kernel takes: ``c, c + grid,
    ...`` (the loops of ``csrc/prng.cu`` and ``csrc/histogram.cu``)."""
    return [list(range(c, num_tiles, grid)) for c in range(grid)]


@pytest.mark.parametrize("num_tiles", [1, 7, 131, 132, 133, 528, 529,
                                       2176, 17408, 2_228_224])
@pytest.mark.parametrize("sms,ctas_per_sm", [(132, 4), (132, 8), (1, 1),
                                             (114, 3)])
def test_persistent_grid_takes_every_tile_once(num_tiles, sms, ctas_per_sm):
    grid = _build.persistent_grid(num_tiles, sms, ctas_per_sm)
    assert 1 <= grid <= min(num_tiles, sms * ctas_per_sm)
    assert grid == min(num_tiles, sms * ctas_per_sm)
    if num_tiles <= 20_000:
        taken = sorted(t for tiles in _tiles_by_cta(num_tiles, grid)
                       for t in tiles)
        assert taken == list(range(num_tiles))
        # No CTA idles.
        assert all(_tiles_by_cta(num_tiles, grid))


@pytest.mark.parametrize("num_rows", [1, 5, 37, 1055, 2053, 17408])
@pytest.mark.parametrize("num_bins", [1, 7, 128, 129, 1536, 1537, 12288])
def test_histogram_launch_shape_takes_every_row_once(num_rows, num_bins):
    """K4's warps and grid: the bins of every warp of a CTA fit 48 KB,
    the resident CTAs fit an SM's shared memory, and the rows, walked
    as the kernel walks them (warp w of CTA c takes rows ``c W + w``,
    then every ``grid W``-th), are each taken exactly once."""
    sms, ctas_per_sm = 132, 8
    warps, grid = histogram.launch_shape(num_rows, num_bins, sms,
                                         ctas_per_sm)
    assert 1 <= warps <= histogram.MAX_WARPS
    assert warps * num_bins * 4 <= histogram.SHARED_BYTES
    per_cta = warps * num_bins * 4 + histogram.CTA_RESERVED_BYTES
    resident = min(ctas_per_sm, histogram.SM_SHARED_BYTES // per_cta)
    assert 1 <= grid <= sms * resident
    stride = grid * warps
    taken = np.zeros(num_rows, dtype=np.int64)
    for cta in range(grid):
        for warp in range(warps):
            taken[cta * warps + warp::stride] += 1
    assert (taken == 1).all()
    assert grid == min(-(-num_rows // warps), sms * resident)


def test_histogram_launch_shape_at_the_main_path():
    """The density and g2 rows: 8 warps, 8 CTAs on each of 132 SMs."""
    assert histogram.launch_shape(17408, 128, 132, 8) == (8, 1056)
    assert histogram.launch_shape(17408 * 128, 128, 132, 8) == (8, 1056)
    assert histogram.launch_shape(5, 12288, 132, 8) == (1, 5)


@pytest.mark.parametrize("num_rows", [1, 5, 527, 528, 529, 17408])
@pytest.mark.parametrize("num_bins", [12289, 12290, 24576, 24577, 65536,
                                      100003, 1 << 22])
def test_histogram_tiled_launch_shape_takes_every_bin_once(num_rows,
                                                           num_bins):
    """K4 beyond one warp's bins: the tile's int counts fit 48 KB, the
    tiles are the fewest that do, a multiple of 4 wide, and, walked as
    the kernel walks them, cover every bin exactly once; the rows, one
    CTA each at a time, are each taken exactly once."""
    sms, ctas_per_sm = 132, 8
    tile, grid = histogram.tiled_launch_shape(num_rows, num_bins, sms,
                                              ctas_per_sm)
    assert tile % 4 == 0 and 4 <= tile <= histogram.MAX_BINS
    num_tiles = -(-num_bins // tile)
    assert num_tiles == -(-num_bins // histogram.MAX_BINS)
    covered = np.zeros(num_bins, dtype=np.int64)
    t0 = 0
    while t0 < num_bins:
        width = min(tile, num_bins - t0)
        covered[t0:t0 + width] += 1
        t0 += width
    assert (covered == 1).all()
    per_cta = tile * 4 + histogram.CTA_RESERVED_BYTES
    resident = min(ctas_per_sm, 2048 // 256,
                   histogram.SM_SHARED_BYTES // per_cta)
    assert resident >= 4
    assert grid == min(num_rows, sms * resident)
    taken = np.zeros(num_rows, dtype=np.int64)
    for cta in range(grid):
        taken[cta::grid] += 1
    assert (taken == 1).all()


def test_histogram_tiled_launch_shape_at_the_checked_sizes():
    """12,289 bins: two tiles of 6,148 and 8 CTAs on each of 132 SMs;
    65,536 bins: six tiles of 10,924 and 5 CTAs per SM by their shared
    memory.  12,288 bins and fewer keep the one-row-per-warp plan."""
    assert histogram.tiled_launch_shape(17408, 12289, 132, 8) == (6148, 1056)
    assert histogram.tiled_launch_shape(17408, 65536, 132, 8) == (10924, 660)
    assert histogram.tiled_launch_shape(64, 65536, 132, 8) == (10924, 64)
    assert histogram.launch_shape(17408, 12288, 132, 8) == (1, 528)


def _dmc_sampling():
    return dmc.Sampling(mrbp.Spec(**SPEC), time_step=1e-2,
                        max_num_walkers=8, target_num_walkers=6, rng_seed=3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dmc_draws_scaled_noise_into_one_buffer(dtype):
    """The DMC step's noise is ``sigma * normal_plain`` of its global
    step, bit for bit, written into the one buffer of the run."""
    sampling = _dmc_sampling()
    confs = np.random.default_rng(0).uniform(0, 8.0, (6, 8))
    state = sampling.build_state(confs, dtype=dtype, device="cpu")
    noise = torch.empty((1,) + state.pos.shape, dtype=dtype)
    nts = 4
    consts = sampling._consts(dtype, "cpu")
    for step, (comb_u, xi) in enumerate(
            sampling._draws(consts, 2, nts, noise, None)):
        assert xi is noise
        want = sampling.sigma_spread * prng.normal_plain(
            sampling.rng_seed, 2 * nts + step, state.pos.shape, dtype)
        assert torch.equal(xi[0], want)
        assert comb_u.shape == (1,) + state.weights.shape


def test_vmc_draws_scaled_gaussian_moves_into_one_buffer():
    sampling = vmc.Sampling(mrbp.Spec(**SPEC), move_spread=0.15, rng_seed=3,
                            num_walkers=6, gaussian=True)
    state = sampling.build_state(
        np.random.default_rng(1).uniform(0, 8.0, (6, 8)), device="cpu")
    noise = torch.empty((1,) + state.pos.shape, dtype=state.pos.dtype)
    consts = sampling._consts(state.pos.dtype, "cpu")
    for step, (disp, u) in enumerate(sampling._draws(
            consts, 1, 3, noise.shape, noise.dtype, noise.device, noise,
            None)):
        assert disp.data_ptr() == noise.data_ptr()
        want = 0.15 * prng.normal_plain(3, 3 + step, state.pos.shape,
                                        state.pos.dtype)
        assert torch.equal(disp[0], want)
        assert u.shape == (1,) + state.pos.shape[:1]


def test_blocks_reuse_the_noise_buffer_without_changing_the_chain():
    """Blocks of DMC on the CPU: the state after two blocks equals a step
    by step replay of the same draws, each drawn into a fresh tensor."""
    sampling = _dmc_sampling()
    confs = np.random.default_rng(0).uniform(0, 8.0, (6, 8))
    state = sampling.build_state(confs, device="cpu")
    blocks = sampling.blocks(state, num_time_steps_block=4)
    last = [next(blocks) for _ in range(2)][-1].last_state
    comb, xis = [], []
    for block in range(2):
        gen = torch.Generator()
        gen.manual_seed(utils.block_seed(3, block))
        for step in range(4):
            comb.append(torch.rand(state.weights.shape, generator=gen,
                                   dtype=state.pos.dtype))
            xis.append(sampling.sigma_spread * prng.normal_plain(
                3, block * 4 + step, state.pos.shape, state.pos.dtype))
    replay = sampling.replay_states(state, torch.stack(comb),
                                    torch.stack(xis))
    assert torch.equal(replay["pos"][-1], last.pos)
    assert torch.equal(replay["energies"][-1], last.energies)
