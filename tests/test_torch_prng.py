"""The diffusion normals' plain torch version: the Box-Muller transform
against the JAX package's, the Philox4x32-10 bits against published
known-answer vectors, and the normals against the statistical gates of
``tests/ops/test_prng.py``.

The CUDA kernel is held against this plain version on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``): the
integer words equal, the normals equal to f32 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from phd_qmclib_torch.ops import prng as tprng
from phd_qmclib_tpu.ops import prng as jprng

torch.set_num_threads(1)


def test_cos2pi_matches_jax():
    u = np.linspace(0.0, 1.0, 200001, endpoint=False).astype(np.float32)
    got = tprng._cos2pi(torch.as_tensor(u)).numpy().astype(np.float64)
    want = np.asarray(jprng._cos2pi(jnp.asarray(u)), dtype=np.float64)
    assert np.abs(got - want).max() < 3e-7
    assert np.abs(got - np.cos(2 * np.pi * u.astype(np.float64))).max() \
        < 3e-7


def test_quarter_wave_polys_match_jax():
    x = np.linspace(0.0, np.pi / 2, 100001).astype(np.float32)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    for port, ref in ((tprng._sin_poly, jprng._sin_poly),
                      (tprng._cos_poly, jprng._cos_poly)):
        got = port(tx).numpy().astype(np.float64)
        assert np.abs(got - np.asarray(ref(jx), np.float64)).max() < 3e-7


def test_box_muller_matches_jax_transform():
    """The transform fed injected 24-bit uniforms, against the same
    composition of the JAX kernel's polynomials."""
    rng = np.random.default_rng(3)
    n = 100000
    u1 = ((rng.integers(0, 1 << 24, n) + 1.0) / (1 << 24)).astype(
        np.float32)
    u2 = (rng.integers(0, 1 << 24, n) / (1 << 24)).astype(np.float32)
    zc, zs = tprng.box_muller(torch.as_tensor(u1), torch.as_tensor(u2))
    radius = np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
    a = 2.0 * jnp.asarray(u2)
    b = a - 2.0 * jnp.round(0.5 * a)
    c = jnp.abs(b)
    flip = c > 0.5
    arg = jnp.pi * jnp.where(flip, 1.0 - c, c)
    cos_j = np.asarray(jnp.where(flip, -1.0, 1.0) * jprng._cos_poly(arg))
    sin_j = np.asarray(jnp.where(b >= 0, 1.0, -1.0) * jprng._sin_poly(arg))
    tol = 3e-7 * np.maximum(radius, 1.0)
    assert np.all(np.abs(zc.numpy() - radius * cos_j) <= tol)
    assert np.all(np.abs(zs.numpy() - radius * sin_j) <= tol)


@pytest.mark.parametrize("ctr,key,want", [
    # Known-answer vectors of Philox4x32-10 (Random123 kat_vectors).
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    words = tprng._philox(*(torch.tensor([c]) for c in ctr), *key)
    assert [int(w) for w in words[0]] == list(want)


def test_mulhilo_is_exact():
    rng = np.random.default_rng(4)
    b = np.concatenate([[0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF],
                        rng.integers(0, 1 << 32, 1000)])
    for m in (tprng.PHILOX_M0, tprng.PHILOX_M1):
        hi, lo = tprng._mulhilo(m, torch.as_tensor(b, dtype=torch.int64))
        prods = [m * int(x) for x in b]
        assert hi.tolist() == [p >> 32 for p in prods]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in prods]


def test_words_are_the_counter_layout():
    """Quad ``q`` of step ``s`` is Philox of the counter
    ``(q lo, q hi, s lo, s hi)`` under the key ``(seed lo, seed hi)``."""
    seed, step = (7 << 32) + 123, (3 << 32) + 9
    words = tprng.philox_words_plain(seed, step, 5)
    q = torch.arange(5)
    want = tprng._philox(q, torch.zeros_like(q), torch.full_like(q, 9),
                         torch.full_like(q, 3), 123, 7)
    assert torch.equal(words, want)


def test_normals_are_standard_normal():
    n = 400000
    z = tprng.normal_plain(11, 0, (n // 128, 128)).reshape(-1).numpy()
    assert z.dtype == np.float32
    ks = sps.kstest(z[:200000], "norm")
    assert ks.pvalue > 1e-3, ks
    # cos and sin outputs of one uniform pair are uncorrelated.
    quads = z.reshape(-1, 4)
    cos_half = quads[:, 0::2].reshape(-1)
    sin_half = quads[:, 1::2].reshape(-1)
    assert abs(np.corrcoef(cos_half, sin_half)[0, 1]) < 4.0 / np.sqrt(n / 2)
    # Neighbouring seeds and steps give uncorrelated streams.
    for other in (tprng.normal_plain(12, 0, (n // 128, 128)),
                  tprng.normal_plain(11, 1, (n // 128, 128))):
        corr = np.corrcoef(z, other.reshape(-1).numpy())[0, 1]
        assert abs(corr) < 4.0 / np.sqrt(n)
    assert abs(z.mean()) < 4.0 / np.sqrt(n)
    assert abs(z.std() - 1.0) < 4.0 / np.sqrt(2 * n)


def test_normals_are_a_function_of_key_and_step():
    a = tprng.normal(5, 17, (6, 10), device="cpu")
    assert torch.equal(a, tprng.normal(5, 17, (6, 10), device="cpu"))
    assert not torch.equal(a, tprng.normal(5, 18, (6, 10), device="cpu"))
    assert not torch.equal(a, tprng.normal(6, 17, (6, 10), device="cpu"))
    # Element i does not depend on the shape it was drawn in.
    flat = tprng.normal(5, 17, (63,), device="cpu")
    assert torch.equal(a.reshape(-1)[:60], flat[:60])
    wide = tprng.normal(5, 17, (6, 10), dtype=torch.float64, device="cpu")
    assert wide.dtype == torch.float64
    assert torch.equal(wide, a.to(torch.float64))
    count = tprng.normal.launch_count
    tprng.normal(5, 17, (6, 10), device="cpu")
    assert tprng.normal.launch_count == count
    with pytest.raises(ValueError, match="no kernel"):
        tprng.normal(5, 17, (6, 10), device="meta")
