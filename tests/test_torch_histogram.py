"""The port's per-walker histogram against the JAX package's, on the CPU.

The plain torch version (what the wrapper runs on a CPU tensor) must
equal the JAX one-hot formulation and the interpret-mode Pallas kernel
bit for bit, at the shapes of ``tests/ops/test_histogram.py``, in f32
and f64, and on the bin edges and out-of-range values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phd_qmclib_torch.ops import histogram as thg
from phd_qmclib_tpu.ops import histogram as jhg

torch.set_num_threads(1)

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _both(pos: np.ndarray, bin_size: float, num_bins: int, tw: int):
    """(port, JAX one-hot, JAX Pallas) histograms of the same input."""
    jpos = jnp.asarray(pos)
    jbs = jnp.asarray(bin_size, dtype=pos.dtype)
    tpos = torch.as_tensor(pos)
    tbs = torch.tensor(bin_size, dtype=tpos.dtype)
    return (thg.walker_histogram(tpos, tbs, num_bins).numpy(),
            np.asarray(jhg.walker_histogram_onehot(jpos, jbs, num_bins)),
            np.asarray(jhg.walker_histogram_pallas(jpos, jbs, num_bins,
                                                   tw=tw, interpret=True)))


@pytest.mark.parametrize("np_dtype,torch_dtype", DTYPES)
@pytest.mark.parametrize("w,n,b,tw", [(96, 128, 128, 32),
                                      (64, 16, 12, 64),
                                      (10, 8, 5, 4)])
def test_plain_matches_jax_exactly(w, n, b, tw, np_dtype, torch_dtype):
    rng = np.random.default_rng(w + n)
    sc = float(b)
    pos = rng.uniform(0, sc, (w, n)).astype(np_dtype)
    got, onehot, pallas = _both(pos, sc / b, b, tw)
    assert got.dtype == np_dtype and got.shape == (w, b)
    np.testing.assert_array_equal(got, onehot)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got.sum(axis=1), n)


@pytest.mark.parametrize("np_dtype,torch_dtype", DTYPES)
def test_bin_edges_and_clipping_match(np_dtype, torch_dtype):
    b, sc = 16, 16.0
    # Exact edges, the last edge, and slightly-out-of-range values that
    # the clip must send to the boundary bins identically.
    vals = np.concatenate([np.arange(b) * (sc / b), [sc - 1e-6, 0.0],
                           [15.9999990]])
    pos = np.tile(vals, (4, 1)).astype(np_dtype)
    got, onehot, pallas = _both(pos, sc / b, b, 2)
    np.testing.assert_array_equal(got, onehot)
    np.testing.assert_array_equal(got, pallas)


def test_out_of_range_values_clip_to_the_end_bins():
    """Negative, too large and infinite values clip as the JAX one-hot
    does; NaN goes to bin 0, as in the kernel."""
    b = 8
    pos = np.array([[-3.5, -0.0, 8.0, 100.0, np.inf, -np.inf, 7.999]])
    got, onehot, _ = _both(pos, 1.0, b, 1)
    np.testing.assert_array_equal(got, onehot)
    nan = thg.walker_histogram(torch.tensor([[np.nan, 1.5]]),
                               torch.tensor(1.0, dtype=torch.float64), b)
    assert nan[0, 0] == 1 and nan[0, 1] == 1


def test_leading_axes_and_bin_size_rounding():
    """(S, W, N) rows bin like their (W, N) slices, and a bin size that
    is not a power of two bins by the floor division, not the
    reciprocal."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 10.0, (3, 6, 16))
    bs = 10.0 / 7
    got = thg.walker_histogram(torch.as_tensor(pos),
                               torch.tensor(bs, dtype=torch.float64), 7)
    want = np.stack([np.asarray(jhg.walker_histogram_onehot(
        jnp.asarray(pos[s]), jnp.asarray(bs), 7)) for s in range(3)])
    np.testing.assert_array_equal(got.numpy(), want)
    edges = np.arange(7) * bs
    got = thg.walker_histogram(torch.as_tensor(edges[None]),
                               torch.tensor(bs, dtype=torch.float64), 7)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhg.walker_histogram_onehot(
            jnp.asarray(edges[None]), jnp.asarray(bs), 7)))


def test_wrapper_launches_nothing_on_the_cpu():
    count = thg.walker_histogram.launch_count
    thg.walker_histogram(torch.zeros((2, 3)), torch.tensor(1.0), 4)
    assert thg.walker_histogram.launch_count == count


@pytest.mark.parametrize("np_dtype,torch_dtype", DTYPES)
@pytest.mark.parametrize("num_bins", [12289, 65536])
def test_plain_matches_jax_beyond_one_warps_bins(num_bins, np_dtype,
                                                 torch_dtype):
    """More bins than the one-row-per-warp kernel holds: the plain
    version, which the card tests hold the tiled kernel against, equals
    the JAX sampler's ``walker_histogram`` on random rows and on a sample
    of the bin edges with their float neighbours."""
    rng = np.random.default_rng(num_bins)
    bs = np_dtype(127.3 / 256)
    sc = float(bs) * num_bins
    k = rng.integers(0, num_bins + 2, 40).astype(np_dtype)
    edges = k * bs
    vals = np.concatenate([
        edges, np.nextafter(edges, np_dtype(-np.inf)),
        np.nextafter(edges, np_dtype(np.inf)),
        np.array([0.0, -0.0, -0.5, -1e30, np.inf, -np.inf, 1e30],
                 dtype=np_dtype), rng.uniform(-0.05 * sc, 1.05 * sc, 65)
        .astype(np_dtype)])
    pos = vals.reshape(4, -1)
    got = thg.walker_histogram(torch.as_tensor(pos),
                               torch.tensor(bs, dtype=torch_dtype), num_bins)
    want = jhg.walker_histogram(jnp.asarray(pos), jnp.asarray(bs), num_bins)
    assert got.shape == (4, num_bins) and got.dtype == torch_dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.sum(dim=1).numpy(), pos.shape[1])
