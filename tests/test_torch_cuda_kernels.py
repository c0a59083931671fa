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
from phd_qmclib_torch.ops import pairwise, prng
from phd_qmclib_torch.samplers import dmc

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
    on_cpu = sampling.replay_states(sampling.build_state(confs), comb_u, xi)
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
