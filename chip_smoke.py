"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the DMC main path of ``phd_qmclib_torch`` at the bench
configuration (v0=20, r=1, gn=1, N=128 bosons, L=128, rm=0.4, dt=1e-3,
16,384 target walkers in a 17,408-slot buffer, f32) through its
hand-written CUDA kernels, without and with the estimators, and the VMC
path at the bench VMC configuration (the same model at N=64, L=64,
16,384 chains) and the variational example, and checks the kernels and
the physics:

A. the card's name and power limit; the kernels' build (``-Xptxas -v``);
B. the pair energy/drift kernel (K1) against its plain torch version,
   f32 at the main path's shape and f64;
C. the Philox normals kernel (K2) against its plain torch version: equal
   integer words, normals equal to f32 rounding, and their moments; its
   scaled ``out=`` form bit for bit ``scale *`` its unscaled output, f32
   and f64; its Box-Muller radius and unit cos/sin bit for bit those of
   the accurate ``logf``/``sqrtf`` form over all 2^24 values of each
   uniform;
D. a small f64 replay on the card against the same replay on the CPU,
   then the DMC run: 6 burn blocks and 2 timed blocks of 512 steps;
   E/N must land within 0.02 of the stored 8.41614 and inside the
   physical bracket (8.0107, 8.5089), K1 must have been launched on
   every step and K2 exactly once per step (the noise comes scaled);
F. the histogram kernel (K4) against its plain torch version, bit for
   bit: the density shape (17408 x 128, 128 bins, f32 and f64), the g2
   shape (the 17408 x 128 rows of 128 pair distances, 128 bins of L/256)
   and the bin edges: those of a unit bin, and those of a bin size that
   is not a power of two (127.3/256: every k bs and the floats just below
   and above it, +-0, negatives, NaN, +-inf, values past B bs); and its
   tiled kernel for more bins than one warp's shared memory holds, at
   12,289 and 65,536 bins, on random rows and on those edges;
G. DMC with estimators from phase D's last state: small f64 replays of
   the estimators, and of the ITC estimator (mixed and pure, cadence
   multiplier 2), on the card against the CPU; then G1, the bench
   estimator load (pure 128-bin density and pure 64-mode S(k) every
   step), G2, the production example without ITC (``est_every`` 8; pure
   density, S(k) with a 512-step window, 32-point OBDM and 128-bin g2
   every 64th step; CM diffusion with an 8-block window), and G3, the
   production example whole, with its pure ITC estimator (32 modes, 64
   lags, every 256th step), 2 timed blocks of 512 steps each: the E/N
   band, the sum rules at every measured step, and the kernels' launch
   counts.  G3 starts from G2's state on G2's random streams: its
   per-step ensemble scalars and final positions must equal G2's bit for
   bit (the estimator must not touch the dynamics); at every ITC row
   the k = 0 column is N^2 times the counts, lags beyond the fill carry
   zero sums and counts, and the fill counter ends at 4.  One ITC
   measuring step is timed on its own (the buffer gather, the
   amplitudes, the products and sums, the shift);
P. physics through the port's own statistics layer: the free ideal gas's
   F(k, tau) / F(k, 0) = exp(-k^2 tau), mixed and pure, at 16,384
   walkers, within 5 reblocked errors of its block-to-block spread (k = 0
   exactly 1); and the Tonks-Girardeau energy (N=5, L=5, gamma=5000,
   8,192 walkers, dt=4e-5) within 5 reblocked errors of the analytic
   pi^2/3 (1 - 1/N^2) (1 - 4/gamma);
H. the log|psi| variant of the pair kernel (K1 log) against its plain
   version: f32 at the VMC shape (16384 x 64) and the DMC shape
   (17408 x 128), f64 at 256 walkers, on the bench, free, ideal and
   defected models;
I. a small f64 VMC replay on the card against the same replay on the
   CPU (injected moves and acceptance uniforms, uniform and Gaussian
   proposals): equal acceptance decisions, positions within 1e-12;
V1. VMC at the bench VMC configuration (move_spread 0.4, 32-mode S(k)
   every step, uniform random starts): 1 burn block and 2 timed blocks
   of 512 steps; E/N and the acceptance must land in the band of the
   JAX package's VMC run of the same protocol on a CPU; the S(k) sum
   rules at every step;
V2. the variational example (``examples/vmc_variational.yml``:
   move_spread 0.25, ``est_every`` 8, 64-mode S(k), 32-point OBDM every
   64th step, regular start) without its checkpoints and HDF5 output: 1
   burn block and 1 timed block of 512 steps; the S(k) and OBDM sum
   rules at every measured step;
J. the fused diffusion kernel (K3) against its plain version and the
   DMC step's own diffusion (``dmc.Sampling.diffuse`` on K2's noise: K2,
   torch ops, K1) at 17408 x 128 f32: its noise is K2's bit for bit;
E. each kernel's time against its plain version at the main path's
   shapes, alternating plain, kernel, kernel, plain (K3 also against the
   step's own diffusion), beside its bound: the larger of its flops over
   the FP32 peak and its bytes over the HBM rate, counted from the
   shapes.  K2 and K4 also give their device time (the profiler's kernel
   time), and K2 stands beside ``torch.randn`` (another stream), like for
   like, per call and on the device: the allocating form against
   ``torch.randn(shape, generator=gen)``, the ``out=`` form (scaled by
   sigma, as the DMC step draws it) against ``torch.randn(shape,
   generator=gen, out=buf)``, in turns.

Every kernel's launches are counted from 0 over the runs of D, G1, G2,
G3, V1 and V2, in all and per step of each run; K1 must run on every DMC
step and K1 log on every VMC step.  K3 lies on none of them (the DMC
step keeps its own sequence, as in the JAX package), and its count
there must stay 0.

The second-to-last line is the per-kernel JSON summary and the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the script
exits non-zero and prints no result.  It needs a CUDA device and the
repository's ``phd_qmclib_torch`` package next to it.
"""
import json
import math
import subprocess
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from phd_qmclib_torch import lieb_liniger
from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import _build, histogram, pairwise, prng
from phd_qmclib_torch.samplers import dmc, vmc
from phd_qmclib_torch.stats import reblock

NOP = 128
TARGET_WALKERS = 16384
MAX_WALKERS = 17408
TIME_STEP = 1e-3
NTS = 512
BURN_BLOCKS = 6
TIMED_BLOCKS = 2
#: The stored E/N band of the bench configuration and its physical
#: bracket (ideal band bottom, VMC variational energy): ``bench.py``.
ENERGY_REF, ENERGY_TOL = 8.41614, 0.02
ENERGY_BRACKET = (8.0107, 8.5089)

BENCH_SPEC = dict(lattice_depth=20.0, lattice_ratio=1.0,
                  interaction_strength=1.0, boson_number=NOP,
                  supercell_size=float(NOP), tbf_contact_cutoff=0.4)
DEFECTED_SPEC = dict(BENCH_SPEC, num_defects=8, defect_magnitude=10.0)

#: Kernel-vs-plain tolerances.  f32: per-particle sums of 128 terms in
#: another order plus fma contraction in the kernel (E_L ~ 1e3);
#: f64: the same at f64 round-off.
K1_F32_TOL = dict(energy_rtol=2e-5, drift_rtol=1e-3, drift_atol=1e-4)
K1_F64_RTOL = 1e-10
#: Normals equal to f32 rounding: logf/sqrtf and fma contraction may
#: differ by an ulp or two of |z| <= 6.
K2_TOL = dict(rtol=1e-6, atol=2e-6)
#: Estimator sum rules in f32: the per-walker rows are exact integers
#: (or N^2), but their walker sums pass 2^24 and round, and the pure
#: estimators divide by their contribution counts: 1e-5 relative.  The
#: OBDM at offset 0 is exp(0) per walker only up to the f32 round-off of
#: two pair-log sums of 127 terms each (minimum image before and after
#: the zero shift): 1e-4 relative.
SUM_RULE_RTOL, OBDM_RTOL = 1e-5, 1e-4

#: The VMC configurations: the bench VMC stage (``bench.py:202-211``) and
#: the variational example (``examples/vmc_variational.yml``).
VMC_NOP = 64
VMC_CHAINS = 16384
VMC_SPEC = dict(BENCH_SPEC, boson_number=VMC_NOP,
                supercell_size=float(VMC_NOP))
#: V1's protocol, for which its band was made: the sampler's settings,
#: uniform random starts, burn blocks, timed blocks and their length.
#: E/N has not settled after the burn block (it still drifts by about
#: 0.007 per block), so the band holds for this protocol only.
VMC_BAND_PROTOCOL = dict(move_spread=0.4, ssf_modes=32, start="uniform",
                         burn_blocks=1, timed_blocks=2, steps_per_block=512)
#: V1's band: E/N (mean over the timed blocks, every step and chain)
#: and the acceptance of three VMC runs of the JAX package (f32, XLA) on
#: a CPU with VMC_BAND_PROTOCOL (``tools/jax_vmc_band.py``; 2048, 2048
#: and 4096 chains, seeds 1-3): 8.49395 +- 0.00042 and 0.23790 +-
#: 0.00030, errors from the spread of the independent chains' time
#: averages.  The tolerance is 5 sigma of that error and of this run's
#: own (16,384 chains: 0.0003 and 0.00022).
VMC_ENERGY_REF, VMC_ENERGY_TOL = 8.49395, 0.0026
VMC_ACCEPT_REF, VMC_ACCEPT_TOL = 0.23790, 0.0019
#: K1 log vs plain: log|psi| sums N^2/2 pair logs in f32 in another order
#: (the JAX package's own Pallas-vs-XLA test allows 1e-5); the energy
#: and drift as for the forward variant.
K1_LOG_F32_TOL = dict(K1_F32_TOL, log_psi_rtol=1e-5, log_psi_atol=1e-4)

#: The least time of a kernel (``bound``): published peaks of one H100
#: SXM at its 700 W limit (NVIDIA's data sheet): FP32 outside the tensor
#: cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
#: Flops per unit of work, as the CUDA sources count them (fma = 2, a
#: MUFU op = 1; compares, selects and integer ops not counted, so each
#: bound stays a least time): K1 per unordered pair, forward and log|psi|
#: (``csrc/pair_terms.cuh::walker_terms``; the O(N) one-body terms and
#: reductions left out); one Box-Muller per pair of normals
#: (``csrc/philox.cuh::box_muller``: ~40 flops, 20 per normal; the
#: Philox rounds are integer ops); K4 per element (the exact floor of
#: ``csrc/histogram.cu::FastBin``: the multiply by the reciprocal, the
#: floor, the fma of the remainder and the one correction); K3 per
#: element its move (4) and the Box-Muller of its element's pair, which
#: each thread recomputes (40), per unordered pair K1's.
K1_FLOPS_PER_PAIR, K1_LOG_FLOPS_PER_PAIR = 28, 40
K2_FLOPS_PER_NORMAL = 20
K4_FLOPS_PER_ELEMENT = 5
K3_FLOPS_PER_ELEMENT = 44
F32_BYTES = 4

#: Phase G's estimator loads.
G1_ESTIMATORS = dict(
    density_est_spec=dmc.DensityEstSpec(num_bins=128, as_pure_est=True),
    ssf_est_spec=dmc.SSFEstSpec(num_modes=64, as_pure_est=True))
G2_ESTIMATORS = dict(
    est_every=8,
    density_est_spec=dmc.DensityEstSpec(num_bins=128, as_pure_est=True),
    ssf_est_spec=dmc.SSFEstSpec(num_modes=64, as_pure_est=True,
                                pfw_num_time_steps=512),
    obd_est_spec=dmc.OBDEstSpec(num_pos=32, as_pure_est=True,
                                est_every_mult=8),
    pair_corr_est_spec=dmc.PairCorrEstSpec(num_bins=128, as_pure_est=True,
                                           est_every_mult=8),
    cm_diffusion_est=True, cm_window_blocks=8)
#: The production example whole (``examples/dmc_production.yml``): G2 and
#: its pure ITC estimator, measured every 8 x 32 = 256th step.
G3_ITC = dmc.ITCEstSpec(num_modes=32, num_lags=64, est_every_mult=32,
                        as_pure_est=True)
G3_ESTIMATORS = dict(G2_ESTIMATORS, itc_est_spec=G3_ITC)
#: K4's tiled kernel: the first bin count beyond one warp's shared memory
#: and a power of two well beyond it.
K4_TILED_BINS = (12289, 65536)
#: How many reblocked errors of its own a physics check may lie from its
#: exact value.
PHYSICS_SIGMAS = 5.0


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


#: Each kernel's launch counter: the wrapper and its attribute.
COUNTERS = {"K1": (pairwise.energy_and_drift, "launch_count"),
            "K1 log": (pairwise.energy_and_drift, "log_psi_launch_count"),
            "K2": (prng.normal, "launch_count"),
            "K3": (pairwise.diffuse_energy_drift, "launch_count"),
            "K4": (histogram.walker_histogram, "launch_count")}


def reset_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, attempts: int = 3):
    """Mean device time of ``fn()``'s kernels per call: the profiler's
    kernel time over ``reps`` calls after a warm-up, or None (not
    measured) if the profiler sees no device time in any of
    ``attempts`` sessions (a session now and then records nothing)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for event in prof.key_averages():
            if event.device_type.name == "CUDA":
                total_us += getattr(event, "self_device_time_total",
                                    getattr(event, "self_cuda_time_total",
                                            0.0))
        if total_us > 0:
            return total_us / 1e3 / reps
    return None


def pair_inputs(spec_kwargs, num_walkers, dtype, device, seed=0):
    spec = mrbp.Spec(**spec_kwargs)
    static = spec.static_spec
    pos = np.random.default_rng(seed).uniform(
        0, spec.supercell_size, (num_walkers, spec.boson_number))
    kw = dict(nop=static.boson_number, is_free=static.is_free,
              is_ideal=static.is_ideal, defects_sep=static.defects_sep)
    return (torch.as_tensor(pos, dtype=dtype, device=device),
            pairwise.pack_params(spec.cfc_params, dtype, device), kw)


def check_k1(device) -> float:
    """Phase B; returns the largest f32 abs error at the main path's
    shape."""
    max_err = 0.0
    for label, spec_kwargs, walkers, dtype in (
            ("bench f32", BENCH_SPEC, MAX_WALKERS, torch.float32),
            ("defected f32", DEFECTED_SPEC, MAX_WALKERS, torch.float32),
            ("bench f64", BENCH_SPEC, 256, torch.float64),
            ("defected f64", DEFECTED_SPEC, 256, torch.float64)):
        pos, params, kw = pair_inputs(spec_kwargs, walkers, dtype, device)
        energy, drift = pairwise.energy_and_drift(pos, params, **kw)
        torch.cuda.synchronize()
        energy_p, drift_p = pairwise.energy_and_drift_plain(pos, params,
                                                            **kw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(energy).all()
                     and torch.isfinite(drift).all()),
                f"K1 {label} finite")
        if dtype == torch.float32:
            tol = K1_F32_TOL
            torch.testing.assert_close(energy, energy_p,
                                       rtol=tol["energy_rtol"], atol=0.0)
            torch.testing.assert_close(drift, drift_p,
                                       rtol=tol["drift_rtol"],
                                       atol=tol["drift_atol"])
        else:
            torch.testing.assert_close(energy, energy_p, rtol=K1_F64_RTOL,
                                       atol=K1_F64_RTOL)
            torch.testing.assert_close(drift, drift_p, rtol=K1_F64_RTOL,
                                       atol=K1_F64_RTOL)
        e_err = float((energy - energy_p).abs().max())
        d_err = float((drift - drift_p).abs().max())
        e_rel = float(((energy - energy_p).abs()
                       / energy_p.abs()).max())
        if label == "bench f32":
            max_err = max(e_err, d_err)
        phase("B", check=f"K1 {label}", shape=list(pos.shape),
              energy_max_abs_err=e_err, energy_max_rel_err=e_rel,
              drift_max_abs_err=d_err, ok=True)
    return max_err


def check_k2(device) -> float:
    """Phase C; returns the largest abs error of the normals."""
    key, step = 1, 12345
    shape = (MAX_WALKERS, NOP)
    num_quads = math.prod(shape) // 4
    words = prng.philox_words(key, step, num_quads, device)
    words_p = prng.philox_words_plain(key, step, num_quads, device)
    torch.cuda.synchronize()
    require(torch.equal(words, words_p), "K2 Philox words equal")
    z = prng.normal(key, step, shape, torch.float32, device)
    torch.cuda.synchronize()
    z_p = prng.normal_plain(key, step, shape, torch.float32, device)
    torch.testing.assert_close(z, z_p, **K2_TOL)
    zd = z.double()
    mean, std = float(zd.mean()), float(zd.std())
    centred = (zd - mean) / std
    skew = float((centred ** 3).mean())
    kurt = float((centred ** 4).mean()) - 3.0
    n = z.numel()
    require(abs(mean) < 5 / math.sqrt(n) and abs(std - 1) < 5 / math.sqrt(
        2 * n), "K2 normals: mean 0, std 1")
    err = float((z - z_p).abs().max())
    # The scaled out= form, as the samplers draw: bit for bit scale times
    # the unscaled kernel's output (torch's multiply by the scalar).
    scale = math.sqrt(2 * TIME_STEP)
    for dtype in (torch.float32, torch.float64):
        buf = torch.empty(shape, dtype=dtype, device=device)
        got = prng.normal(key, step, shape, dtype, device, scale=scale,
                          out=buf)
        want = scale * prng.normal(key, step, shape, dtype, device)
        torch.cuda.synchronize()
        require(got is buf and torch.equal(got, want),
                f"K2 scale/out= {dtype} equal to scale * normal")
    # The kernels' Box-Muller against the accurate logf/sqrtf form over
    # every value of each 24-bit uniform.
    mismatches = prng.box_muller_mismatches(device)
    require(mismatches == 0, f"K2 transform bit for bit the accurate "
            f"logf's over all 2^24 uniforms: {mismatches} differ")
    phase("C", check="K2 vs plain", shape=list(shape), words_equal=True,
          max_abs_err=err, mean=mean, std=std, skew=skew,
          excess_kurtosis=kurt, scaled_out_equal=True,
          transform_mismatches_of_2_24=mismatches, ok=True)
    return err


def check_replay(device) -> None:
    """Phase D, first part: the sampler's step on the card (both
    kernels) against the same injected-noise replay on the CPU (plain
    versions), f64, N=16."""
    spec = mrbp.Spec(**dict(BENCH_SPEC, boson_number=16,
                            supercell_size=16.0))
    sampling = dmc.Sampling(spec, time_step=1e-2, max_num_walkers=64,
                            target_num_walkers=48, rng_seed=3)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(48)])
    comb_u = rng.random((10, 64))
    xi = sampling.sigma_spread * rng.standard_normal((10, 64, 16))
    on_cpu = sampling.replay_states(
        sampling.build_state(confs, device="cpu"), comb_u, xi)
    on_card = sampling.replay_states(
        sampling.build_state(confs, device=device), comb_u, xi)
    require(torch.equal(on_card["parent"].cpu(), on_cpu["parent"]),
            "replay branching tables equal")
    errs = {}
    for name in ("pos", "energies", "weights", "ref_energy"):
        torch.testing.assert_close(on_card[name].cpu(), on_cpu[name],
                                   rtol=1e-9, atol=1e-9)
        errs[name] = float((on_card[name].cpu() - on_cpu[name]).abs().max())
    phase("D", check="f64 replay card vs CPU", steps=10, max_abs_err=errs,
          ok=True)


def bench_sampling(**estimators) -> dmc.Sampling:
    return dmc.Sampling(mrbp.Spec(**BENCH_SPEC), time_step=TIME_STEP,
                        max_num_walkers=MAX_WALKERS,
                        target_num_walkers=TARGET_WALKERS, rng_seed=1,
                        **estimators)


def check_energy(props_list, label: str) -> float:
    """E/N of the timed blocks, held to the stored band."""
    e_per_boson = float(np.mean([
        float(p.energy.double().sum() / p.weight.double().sum())
        for p in props_list])) / NOP
    lo, hi = ENERGY_BRACKET
    require(abs(e_per_boson - ENERGY_REF) < ENERGY_TOL
            and lo < e_per_boson < hi,
            f"{label}: E/N {e_per_boson} within {ENERGY_TOL} of "
            f"{ENERGY_REF} and inside {ENERGY_BRACKET}")
    return e_per_boson


def run_dmc(device, card: str):
    """Phase D: the main path at the bench configuration.  Returns the
    launch counts, the last state and the timings."""
    spec = mrbp.Spec(**BENCH_SPEC)
    sampling = bench_sampling()
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(TARGET_WALKERS)]).astype(np.float32)

    reset_counts()
    t_start = time.perf_counter()
    state = sampling.build_state(confs, dtype=np.float32, device=device)
    blocks = sampling.blocks(state, num_time_steps_block=NTS,
                             burn_in_blocks=BURN_BLOCKS)
    for _ in range(BURN_BLOCKS):
        block = next(blocks)
    burn_s = time.perf_counter() - t_start
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    props_list, walker_steps = [], 0
    for _ in range(TIMED_BLOCKS):
        block = next(blocks)  # ends in a fetch of the block's props
        props_list.append(block.iter_props)
        walker_steps += int(block.iter_props.num_walkers.sum())
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()

    steps_run = (BURN_BLOCKS + TIMED_BLOCKS) * NTS
    last = block.last_state
    require(last.pos.shape == (MAX_WALKERS, NOP)
            and bool(torch.isfinite(last.pos).all())
            and bool(torch.isfinite(last.energies).all()),
            "final state finite, of the buffer's shape")
    require(0 < int(last.num_walkers) <= MAX_WALKERS, "walkers alive")
    e_per_boson = check_energy(props_list, "D")
    require(launches["K1"] >= steps_run and launches["K2"] == steps_run,
            f"kernel launches {launches}: K1 on each of {steps_run} steps, "
            f"K2 once per step")
    step_ms = start.elapsed_time(end) / (TIMED_BLOCKS * NTS)
    phase("D", check="DMC bench config", card=card, steps_run=steps_run,
          burn_s=burn_s, timed_wall_s=wall_s,
          walker_steps_per_s=walker_steps / wall_s,
          step_ms_cuda_events=step_ms,
          mean_num_walkers=walker_steps / (TIMED_BLOCKS * NTS),
          energy_per_boson=e_per_boson,
          energy_dev=e_per_boson - ENERGY_REF, launches=launches, ok=True)
    return launches, last, {"walker_steps_per_s": walker_steps / wall_s,
                            "step_ms_cuda_events": step_ms}


def check_k4(device) -> float:
    """Phase F: K4 equals its plain version bit for bit; returns the
    largest abs difference (0)."""
    rng = np.random.default_rng(4)
    cases = []
    for dtype in (torch.float32, torch.float64):
        pos = torch.as_tensor(rng.uniform(0, NOP, (MAX_WALKERS, NOP)),
                              dtype=dtype, device=device)
        cases.append((f"density {dtype}", pos,
                      torch.tensor(1.0, dtype=dtype, device=device), NOP))
    cases.append(("g2 rows f32", pair_distances(device),
                  torch.tensor(NOP / 256, device=device), NOP))
    edges = np.concatenate([np.arange(16.0), [16 - 1e-6, 0.0, 15.9999990,
                                              -0.5, 16.0, 1e30]])
    for dtype in (torch.float32, torch.float64):
        cases.append((f"edges {dtype}",
                      torch.as_tensor(np.tile(edges, (4, 1)), dtype=dtype,
                                      device=device),
                      torch.tensor(1.0, dtype=dtype, device=device), 16))
        bin_size = torch.tensor(K4_EDGE_BIN_SIZE, dtype=dtype, device=device)
        cases.append((f"edges of {K4_EDGE_BIN_SIZE} {dtype}",
                      bin_edge_values(bin_size, NOP), bin_size, NOP))
        # The tiled kernel: random rows past both ends of the bins, and
        # every 16th row of the edges (each row a run of 128 edges).
        for num_bins in K4_TILED_BINS:
            sc = num_bins * K4_EDGE_BIN_SIZE
            cases.append((f"tiled random {dtype}", torch.as_tensor(
                rng.uniform(-0.05 * sc, 1.05 * sc, (2048, NOP)), dtype=dtype,
                device=device), bin_size, num_bins))
            cases.append((f"tiled edges of {K4_EDGE_BIN_SIZE} {dtype}",
                          bin_edge_values(bin_size, num_bins)[::16]
                          .contiguous(), bin_size, num_bins))
    err = 0.0
    for label, pos, bin_size, num_bins in cases:
        count = histogram.walker_histogram.launch_count
        hist = histogram.walker_histogram(pos, bin_size, num_bins)
        torch.cuda.synchronize()
        require(histogram.walker_histogram.launch_count == count + 1,
                f"K4 {label} launched")
        plain = histogram.walker_histogram_plain(pos, bin_size, num_bins)
        equal = torch.equal(hist, plain)
        diff = float((hist - plain).abs().max())
        require(equal, f"K4 {label} equal to its plain version")
        require(bool((hist.sum(-1) == pos.shape[-1]).all()),
                f"K4 {label} counts every element")
        err = max(err, diff)
        phase("F", check=f"K4 {label}", shape=list(pos.shape),
              num_bins=num_bins, equal=equal, max_abs_err=diff, ok=True)
    return err


#: A bin size that is not a power of two, for K4's exact floor: L/256 of
#: a supercell of 127.3.
K4_EDGE_BIN_SIZE = 127.3 / 256


def bin_edge_values(bin_size: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Rows of K4 edge cases for ``bin_size`` (in its dtype, on its
    device): every edge ``k bs`` (k = 0 .. B + 1, multiplied in that
    dtype) and the floats just below and above it, +-0, negatives, NaN,
    +-inf, and values past ``B bs``; 128 per row, the last row padded
    with bin centres."""
    k = torch.arange(num_bins + 2, dtype=bin_size.dtype,
                     device=bin_size.device)
    edges = k * bin_size
    inf = torch.full_like(edges, math.inf)
    special = torch.tensor(
        [0.0, -0.0, -1e-30, -0.5, -1e30, math.nan, math.inf, -math.inf,
         1e30, 3e38], dtype=bin_size.dtype, device=bin_size.device)
    past = (num_bins + torch.arange(1, 9, dtype=bin_size.dtype,
                                    device=bin_size.device)) * bin_size
    vals = torch.cat([edges, torch.nextafter(edges, -inf),
                      torch.nextafter(edges, inf), special, past])
    pad = torch.arange((-vals.numel()) % 128, dtype=bin_size.dtype,
                       device=bin_size.device)
    vals = torch.cat([vals, (pad % num_bins + 0.5) * bin_size])
    return vals.reshape(-1, 128)


def pair_distances(device) -> torch.Tensor:
    """The g2 estimator's K4 input at full width: the (17408, 128, 128)
    minimum-image distances of uniform f32 positions in [0, L)."""
    pos = torch.as_tensor(np.random.default_rng(5).uniform(
        0, NOP, (MAX_WALKERS, NOP)), dtype=torch.float32, device=device)
    d = pos[:, :, None] - pos[:, None, :]
    return (d - NOP * torch.round(d / NOP)).abs()


def check_estimator_replay(device) -> None:
    """Phase G, first part: the estimators on the card (K1, K2, K4)
    against the same injected-noise replay on the CPU, f64, N=16."""
    spec = mrbp.Spec(**dict(BENCH_SPEC, boson_number=16,
                            supercell_size=16.0))
    estimators = dict(G2_ESTIMATORS, est_every=2)
    estimators.update(
        density_est_spec=dmc.DensityEstSpec(num_bins=16),
        ssf_est_spec=dmc.SSFEstSpec(num_modes=8),
        obd_est_spec=dmc.OBDEstSpec(num_pos=5, est_every_mult=2),
        pair_corr_est_spec=dmc.PairCorrEstSpec(num_bins=12,
                                               est_every_mult=2))
    sampling = dmc.Sampling(spec, time_step=1e-2, max_num_walkers=64,
                            target_num_walkers=48, rng_seed=3, **estimators)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(48)])
    comb_u = rng.random((12, 64))
    xi = sampling.sigma_spread * rng.standard_normal((12, 64, 16))
    on_cpu, _, _ = sampling.replay_estimators(
        sampling.build_state(confs, device="cpu"), comb_u, xi)
    on_card, _, _ = sampling.replay_estimators(
        sampling.build_state(confs, device=device), comb_u, xi)
    errs = {}
    for name, rows in on_cpu.items():
        card = on_card[name].cpu()
        if name in ("density", "g2"):
            require(torch.equal(card, rows), f"replay {name} counts equal")
        else:
            torch.testing.assert_close(card, rows, rtol=1e-9, atol=1e-9)
        errs[name] = float((card - rows).abs().max())
    phase("G", check="f64 estimator replay card vs CPU", steps=12,
          max_abs_err=errs, ok=True)


def check_itc_replay(device) -> None:
    """Phase G: the ITC estimator on the card against the same
    injected-noise replay on the CPU, f64, N=16, mixed and pure, cadence
    multiplier 2: rows within 1e-12 of their scale, counts equal."""
    spec = mrbp.Spec(**dict(BENCH_SPEC, boson_number=16,
                            supercell_size=16.0))
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(48)])
    comb_u = rng.random((24, 64))
    for pure in (False, True):
        sampling = dmc.Sampling(
            spec, time_step=1e-2, max_num_walkers=64, target_num_walkers=48,
            rng_seed=3, est_every=2,
            ssf_est_spec=dmc.SSFEstSpec(num_modes=3),
            itc_est_spec=dmc.ITCEstSpec(num_modes=5, num_lags=4,
                                        est_every_mult=2, as_pure_est=pure))
        xi = sampling.sigma_spread * rng.standard_normal((24, 64, 16))
        on_cpu, aux_cpu, state_cpu = sampling.replay_estimators(
            sampling.build_state(confs, device="cpu"), comb_u, xi)
        on_card, aux_card, state_card = sampling.replay_estimators(
            sampling.build_state(confs, device=device), comb_u, xi)
        scale = 16 ** 2 * 48
        errs = {}
        for name in ("itc", "itc_nw"):
            card, rows = on_card[name].cpu(), on_cpu[name]
            require(rows.shape[0] == 6, "6 ITC rows in 24 steps")
            errs[name] = float((card - rows).abs().max()) / scale
            require(errs[name] < 1e-12, f"ITC replay {name} within 1e-12")
        if not pure:
            require(torch.equal(on_card["itc_nw"].cpu(), on_cpu["itc_nw"]),
                    "ITC replay counts equal")
        errs["itc_buf"] = float((state_card.itc_buf.cpu()
                                 - state_cpu.itc_buf).abs().max())
        require(errs["itc_buf"] < 1e-12
                and int(state_card.itc_filled) == int(state_cpu.itc_filled)
                == 4, "ITC replay ring buffer within 1e-12, fill 4")
        for name, acc in aux_cpu.items():
            err = float((aux_card[name].cpu() - acc).abs().max()) / 16 ** 2
            require(err < 1e-12, f"ITC replay {name} within 1e-12")
        phase("G", check="f64 ITC replay card vs CPU",
              estimator="pure" if pure else "mixed", steps=24,
              max_abs_err_over_scale=errs, ok=True)


def check_itc_rows(blocks_done, filled_before: int) -> dict:
    """The ITC rows of consecutive measured blocks whose first row saw
    ``filled_before`` lag rows filled: the k = 0 column is N^2 times the
    counts at every lag, the lags beyond the fill carry zero sums and
    zero counts, and the equal-time count is positive."""
    dev, row_idx = 0.0, filled_before
    for block in blocks_done:
        itc, nw = block.iter_itc.double(), block.iter_itc_nw.double()
        require(bool(torch.isfinite(itc).all() and torch.isfinite(nw).all()),
                "ITC rows finite")
        for sums, counts in zip(itc, nw):
            filled = min(row_idx, G3_ITC.num_lags)
            require(float(counts[0]) > 0, "ITC equal-time count positive")
            require(bool((counts[1:filled + 1] > 0).all()),
                    f"ITC lags up to the fill {filled} counted")
            require(not bool(counts[filled + 1:].any())
                    and not bool(sums[filled + 1:].any()),
                    f"ITC lags beyond the fill {filled} zero")
            want = NOP ** 2 * counts[:filled + 1]
            dev = max(dev, float(((sums[:filled + 1, 0] - want).abs()
                                  / want).max()))
            row_idx += 1
    require(dev < SUM_RULE_RTOL,
            f"ITC k=0 sum rule within {SUM_RULE_RTOL}: {dev}")
    return {"itc_k0": dev, "itc_rows": row_idx - filled_before}


def check_sum_rules(sampling: dmc.Sampling, block) -> dict:
    """Every measured step of a block against its walker count: density
    N nw, S(0) N^2 nw, g2 N(N-1)/2 nw, OBDM(0) nw.  Returns the largest
    relative deviation of each."""
    nw = block.iter_props.num_walkers.double()
    every = sampling.est_every
    mult = {"obd": sampling.obd_est_spec,
            "g2": sampling.pair_corr_est_spec}
    rules = {"density": (lambda x: x.sum(-1), NOP, SUM_RULE_RTOL),
             "ssf": (lambda x: x[:, 0, 0], NOP ** 2, SUM_RULE_RTOL),
             "g2": (lambda x: x.sum(-1), NOP * (NOP - 1) / 2,
                    SUM_RULE_RTOL),
             "obd": (lambda x: x[:, 0], 1, OBDM_RTOL)}
    devs = {}
    for name, (reduce, per_walker, rtol) in rules.items():
        rows = getattr(block, f"iter_{name}")
        if rows is None:
            continue
        period = every * getattr(mult.get(name), "est_every_mult", 1)
        want = per_walker * nw[period - 1::period]
        got = reduce(rows.double())
        require(got.shape == want.shape and bool(torch.isfinite(
            rows).all()), f"{name}: one finite row per measured step")
        dev = float(((got - want).abs() / want).max())
        require(dev < rtol, f"{name} sum rule within {rtol}: {dev}")
        devs[name] = dev
    return devs


def run_estimators(device, card: str, state, label: str, estimators: dict,
                   block_offset: int, baseline: dict) -> dict:
    """Phase G1/G2/G3: 2 timed blocks with estimators from ``state``.
    Returns the launch counts of the run, its per-step ensemble scalars
    and its final state."""
    sampling = bench_sampling(**estimators)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    blocks = sampling.blocks(state, num_time_steps_block=NTS,
                             block_offset=block_offset)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    done, walker_steps = [], 0
    for _ in range(TIMED_BLOCKS):
        block = next(blocks)
        # Only the last block's state is kept: an earlier one would hold
        # its ITC ring buffer alive and count in the peak.
        last = block.last_state
        done.append(block._replace(last_state=None))
        walker_steps += int(block.iter_props.num_walkers.sum())
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    steps_run = TIMED_BLOCKS * NTS
    e_per_boson = check_energy([b.iter_props for b in done], label)
    sum_rules = [check_sum_rules(sampling, b) for b in done]
    hist_steps = sum(
        len(getattr(b, f"iter_{name}"))
        for b in done for name in ("density", "g2")
        if getattr(b, f"iter_{name}") is not None)
    require(launches["K4"] >= hist_steps,
            f"K4 launches {launches['K4']} cover the {hist_steps} density "
            f"and g2 measurements")
    require(launches["K1"] >= steps_run and launches["K2"] == steps_run,
            f"kernel launches {launches}: K1 on each of {steps_run} steps, "
            f"K2 once per step")
    require(bool(torch.isfinite(last.pos).all()), "final state finite")
    if sampling.cm_diffusion_est:
        cmd = torch.cat([b.iter_cmd for b in done])
        require(bool(torch.isfinite(cmd).all() and (cmd[:, 0] > 0).all()),
                "CM diffusion rows finite and positive")
    itc = {}
    if sampling.itc_est_spec is not None:
        itc = check_itc_rows(done, 0)
        itc["itc_filled"] = int(last.itc_filled)
        require(itc["itc_filled"] == itc["itc_rows"]
                == steps_run // sampling._every(sampling.itc_est_spec),
                f"ITC fill counter after {itc['itc_rows']} rows: "
                f"{itc['itc_filled']}")
    step_ms = start.elapsed_time(end) / steps_run
    phase(label, check="DMC with estimators", card=card,
          estimators=sorted(k for k, v in estimators.items()
                            if k.endswith("_spec") and v is not None)
          + (["cm_diffusion"] if sampling.cm_diffusion_est else []),
          est_every=sampling.est_every, steps_run=steps_run,
          timed_wall_s=wall_s, walker_steps_per_s=walker_steps / wall_s,
          step_ms_cuda_events=step_ms,
          estimators_off_D=baseline, peak_device_memory_gb=peak_gb,
          energy_per_boson=e_per_boson,
          energy_dev=e_per_boson - ENERGY_REF,
          measured_rows={name: sum(len(getattr(b, f"iter_{name}"))
                                   for b in done)
                         for name in ("density", "ssf", "obd", "g2", "cmd",
                                      "itc")
                         if getattr(done[0], f"iter_{name}") is not None},
          sum_rule_max_rel_dev={k: max(r[k] for r in sum_rules)
                                for k in sum_rules[0]}, **itc,
          launches=launches, ok=True)
    return {"launches": launches, "props": [b.iter_props for b in done],
            "pos": last.pos, "step_ms": step_ms, "peak_gb": peak_gb}


def check_same_trajectory(with_itc: dict, without: dict) -> None:
    """G3 against G2, from the same state on the same random streams:
    the ITC estimator must leave every per-step ensemble scalar and the
    final positions bit-equal."""
    for a, b in zip(with_itc["props"], without["props"]):
        for name, x, y in zip(a._fields, a, b):
            require(torch.equal(x, y), f"G3 {name} per step equal to G2's")
    require(torch.equal(with_itc["pos"], without["pos"]),
            "G3 final positions equal to G2's")
    phase("G3", check="trajectory bit-equal to G2's",
          steps=sum(len(p.energy) for p in with_itc["props"]), ok=True)


def time_itc_step(device, card: str, state, g2_step_ms: float,
                  g3: dict) -> None:
    """One ITC measuring step at G3's shape, timed on its own (CUDA
    events): the whole step of an ITC-only sampling, which computes its
    amplitudes itself (G3 slices them from the S(k) parts of the step),
    and its items, the ring buffer's gather, the amplitudes, the shift."""
    sampling = bench_sampling(est_every=8, itc_est_spec=G3_ITC)
    dtype = state.pos.dtype
    consts = sampling._consts(dtype, device)
    aux = sampling._fresh_aux(dtype, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    buf = torch.randn(sampling._itc_buf_shape, generator=gen, dtype=dtype,
                      device=device)
    filled = torch.tensor(G3_ITC.num_lags, dtype=torch.int32, device=device)
    full = state._replace(itc_buf=buf, itc_filled=filled)
    parent = torch.randint(0, int(state.num_walkers), (MAX_WALKERS,),
                           generator=gen, device=device).sort().values
    valid = torch.arange(MAX_WALKERS, device=device) < state.num_walkers
    branch = dmc._Branch(parent, state.pos, valid)
    period = sampling._every(G3_ITC)

    def measure():
        return sampling._estimate(consts, aux, None, parent, branch, full,
                                  period - 1)[1]

    require(measure()["itc"].shape == (G3_ITC.num_lags + 1,
                                       G3_ITC.num_modes),
            "the timed step measured the ITC rows")
    funcs = sampling.core_funcs
    reim = funcs.fourier_density_reim_harmonics(G3_ITC.num_modes, state.pos,
                                                consts.cfc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    items = {
        "itc_step_ms": cuda_ms(measure, 10),
        "gather_ms": cuda_ms(lambda: buf[parent], 10),
        "amplitudes_ms": cuda_ms(
            lambda: funcs.fourier_density_reim_harmonics(
                G3_ITC.num_modes, state.pos, consts.cfc), 10),
        "shift_ms": cuda_ms(
            lambda: torch.cat([reim[:, None], buf[:, :-1]], dim=1), 10),
    }
    items["products_and_sums_ms"] = items["itc_step_ms"] - sum(
        items[name] for name in ("gather_ms", "amplitudes_ms", "shift_ms"))
    extra_gb = (torch.cuda.max_memory_allocated(device) - before) / 1e9
    phase("G3", check="one ITC measuring step", card=card,
          shape=list(buf.shape), buffer_gb=buf.numel() * buf.element_size()
          / 1e9, **items, step_extra_peak_memory_gb=extra_gb,
          steps_between=period,
          itc_ms_per_step_amortized=items["itc_step_ms"] / period,
          g3_step_ms_cuda_events=g3["step_ms"],
          g2_step_ms_cuda_events=g2_step_ms,
          g3_peak_device_memory_gb=g3["peak_gb"], ok=True)


def reblocked(series) -> tuple:
    """Mean and reblocked error of a serially correlated series ``(n,
    ...)``, each column on its own, through the port's ``stats.reblock``
    (a short series cannot meet the optimum block size criterion and
    falls back to the largest block size, with a warning that is
    expected here)."""
    series = np.asarray(series, dtype=np.float64)
    flat = series.reshape(series.shape[0], -1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        stats = reblock.OTFSet.from_non_obj_data(flat)
        mean, err = np.asarray(stats.mean), np.asarray(stats.mean_eff_error)
    return mean.reshape(series.shape[1:]), err.reshape(series.shape[1:])


def check_free_gas_itc(device, card: str) -> None:
    """Phase P: the free ideal gas.  The trial function is constant, the
    DMC dynamics is the exact imaginary-time propagator and rho_k |0> an
    exact eigenstate, so F(k, tau) / F(k, 0) = exp(-k^2 tau) exactly, for
    the mixed and the pure estimator alike.  Each block gives one
    normalized F (the mixed sums over its rows, the pure window's last
    row); the mean over the blocks must lie within PHYSICS_SIGMAS
    reblocked errors of the exact decay at every lag and k > 0, and k = 0
    must be 1."""
    nop, lags, modes, walkers = 8, 8, 4, 16384
    nts, burn, num_blocks = 256, 2, 24
    spec = mrbp.Spec(lattice_depth=1e-6, lattice_ratio=1.0,
                     interaction_strength=0.0, boson_number=nop,
                     supercell_size=8.0, tbf_contact_cutoff=0.3)
    rng = np.random.default_rng(2)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(walkers)])
    for pure in (False, True):
        sampling = dmc.Sampling(
            spec, time_step=5e-3, max_num_walkers=walkers + walkers // 16,
            target_num_walkers=walkers, rng_seed=13, est_every=4,
            itc_est_spec=dmc.ITCEstSpec(num_modes=modes, num_lags=lags,
                                        as_pure_est=pure))
        t0 = time.perf_counter()
        blocks = sampling.blocks(
            sampling.build_state(confs, dtype=np.float32, device=device),
            nts, burn_in_blocks=burn)
        for _ in range(burn):
            next(blocks)
        ratios = []
        for _ in range(num_blocks):
            block = next(blocks)
            itc, nw = block.iter_itc.double(), block.iter_itc_nw.double()
            if pure:
                f = itc[-1] / nw[-1, :, None]
            else:
                f = itc.sum(dim=0) / nw.sum(dim=0)[:, None]
            ratios.append((f / f[0]).numpy())
        ratios = np.stack(ratios)  # (blocks, lags + 1, modes)
        exact = np.exp(-sampling.itc_momenta[None, :] ** 2
                       * sampling.itc_lag_times[:, None])
        k0_dev = float(np.abs(ratios[:, :, 0] - 1.0).max())
        require(k0_dev < SUM_RULE_RTOL, f"free gas k=0 ratio 1: {k0_dev}")
        mean, err = reblocked(ratios[:, 1:, 1:])
        dev = np.abs(mean - exact[1:, 1:])
        require(bool((err > 0).all() and (dev < PHYSICS_SIGMAS * err).all()),
                f"free gas F(k, tau)/F(k, 0) = {mean.tolist()} +- "
                f"{err.tolist()} within {PHYSICS_SIGMAS} errors of "
                f"{exact[1:, 1:].tolist()}")
        at = np.unravel_index(np.argmax(dev / err), dev.shape)
        worst, worst_err, worst_dev = (float(x[at])
                                       for x in (dev / err, err, dev))
        phase("P", check="free gas F(k,tau)/F(k,0) = exp(-k^2 tau)",
              card=card, estimator="pure" if pure else "mixed",
              walkers=walkers, blocks=num_blocks, steps_per_block=nts,
              wall_s=time.perf_counter() - t0, k0_max_dev=k0_dev,
              tolerance_sigmas=PHYSICS_SIGMAS, worst_dev_in_sigmas=worst,
              worst_dev=worst_dev, worst_err=worst_err,
              deepest_exact=float(exact[-1, -1]), ok=True)


def check_tonks_girardeau(device, card: str) -> None:
    """Phase P: the Tonks-Girardeau gas (N=5, L=5, gamma=5000).  At
    infinite contact repulsion the gas maps to free fermions, E/N =
    pi^2/3 (1 - 1/N^2), times (1 - 4/gamma) at a large finite coupling;
    the phonon Jastrow family contains that state, so DMC must give the
    analytic value within PHYSICS_SIGMAS of its own reblocked error."""
    nop, gn, walkers = 5, 1e4, 8192
    nts, burn, num_blocks = 256, 8, 32
    spec = mrbp.Spec(lattice_depth=0.0, lattice_ratio=1.0,
                     interaction_strength=gn, boson_number=nop,
                     supercell_size=float(nop), tbf_contact_cutoff=2.0)
    sampling = dmc.Sampling(spec, time_step=4e-5,
                            max_num_walkers=walkers + walkers // 16,
                            target_num_walkers=walkers, rng_seed=6)
    rng = np.random.default_rng(1)
    confs = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR,
                               offset=rng.uniform(0, nop))
        for _ in range(walkers)])
    t0 = time.perf_counter()
    blocks = sampling.blocks(
        sampling.build_state(confs, dtype=np.float64, device=device), nts,
        burn_in_blocks=burn)
    for _ in range(burn):
        next(blocks)
    energy, weight = [], []
    for _ in range(num_blocks):
        props = next(blocks).iter_props
        energy.append(props.energy.double().numpy())
        weight.append(props.weight.double().numpy())
    energy, weight = np.concatenate(energy), np.concatenate(weight)
    # The per-step ensemble means, reblocked over the steps; the ratio of
    # the sums is the estimate (the population varies by a fraction of a
    # percent, so the two agree far inside the error).
    err = float(reblocked(energy / weight / nop)[1])
    e_per_n = float(energy.sum() / weight.sum()) / nop
    gamma = gn / 2
    exact = math.pi ** 2 / 3 * (1 - 1 / nop ** 2) * (1 - 4 / gamma)
    bethe = lieb_liniger.ground_state_energy(gamma) * (1 - 1 / nop ** 2)
    require(err > 0 and abs(e_per_n - exact) < PHYSICS_SIGMAS * err,
            f"Tonks-Girardeau E/N {e_per_n} +- {err} within "
            f"{PHYSICS_SIGMAS} errors of {exact}")
    phase("P", check="Tonks-Girardeau E/N", card=card, walkers=walkers,
          steps=num_blocks * nts, burn_steps=burn * nts,
          wall_s=time.perf_counter() - t0, energy_per_boson=e_per_n,
          reblocked_error=err, exact=exact,
          bethe_ansatz_times_finite_size=bethe, dev=e_per_n - exact,
          dev_in_sigmas=abs(e_per_n - exact) / err,
          tolerance_sigmas=PHYSICS_SIGMAS, ok=True)


def check_k1_log(device) -> float:
    """Phase H; returns the largest abs error at the VMC shape."""
    free = dict(VMC_SPEC, lattice_depth=0.0)
    ideal = dict(VMC_SPEC, interaction_strength=0.0)
    max_err = 0.0
    for label, spec_kwargs, walkers, dtype in (
            ("vmc f32", VMC_SPEC, VMC_CHAINS, torch.float32),
            ("bench f32", BENCH_SPEC, MAX_WALKERS, torch.float32),
            ("defected f32", DEFECTED_SPEC, 4096, torch.float32),
            ("free f32", free, 4096, torch.float32),
            ("ideal f32", ideal, 4096, torch.float32),
            ("vmc f64", VMC_SPEC, 256, torch.float64),
            ("defected f64", DEFECTED_SPEC, 256, torch.float64),
            ("free f64", free, 256, torch.float64),
            ("ideal f64", ideal, 256, torch.float64)):
        pos, params, kw = pair_inputs(spec_kwargs, walkers, dtype, device)
        count = pairwise.energy_and_drift.log_psi_launch_count
        out = pairwise.energy_and_drift(pos, params, with_log_psi=True, **kw)
        torch.cuda.synchronize()
        require(pairwise.energy_and_drift.log_psi_launch_count == count + 1,
                f"K1 log {label} launched")
        plain = pairwise.energy_and_drift_plain(pos, params,
                                                with_log_psi=True, **kw)
        require(all(bool(torch.isfinite(x).all()) for x in out),
                f"K1 log {label} finite")
        if dtype == torch.float32:
            tol = K1_LOG_F32_TOL
            tols = ((tol["log_psi_rtol"], tol["log_psi_atol"]),
                    (tol["energy_rtol"], 0.0),
                    (tol["drift_rtol"], tol["drift_atol"]))
        else:
            tols = ((K1_F64_RTOL, K1_F64_RTOL),) * 3
        for got, want, (rtol, atol) in zip(out, plain, tols):
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        abs_err = [float((a - b).abs().max()) for a, b in zip(out, plain)]
        rel_err = [float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                   for a, b in zip(out[:2], plain[:2])]
        if label == "vmc f32":
            max_err = max(abs_err)
        phase("H", check=f"K1 log {label}", shape=list(pos.shape),
              log_psi_max_rel_err=rel_err[0], energy_max_rel_err=rel_err[1],
              log_psi_max_abs_err=abs_err[0], energy_max_abs_err=abs_err[1],
              drift_max_abs_err=abs_err[2], ok=True)
    return max_err


def check_vmc_replay(device) -> None:
    """Phase I: the Metropolis chains with K1 log (and K2's stream
    replaced by injected Gaussian moves) on the card against the CPU,
    f64, N=16."""
    spec = mrbp.Spec(**dict(DEFECTED_SPEC, boson_number=16,
                            supercell_size=16.0, num_defects=4))
    for gaussian in (False, True):
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
        on_card = sampling.replay_chain(
            sampling.build_state(confs, device=device), moves, accept_u)
        require(torch.equal(on_card[2].cpu(), on_cpu[2]),
                "VMC replay acceptance decisions equal")
        errs = {}
        for name, got, want in zip(("pos", "wf_abs_log"), on_card[:2],
                                   on_cpu[:2]):
            errs[name] = float((got.cpu() - want).abs().max())
            require(errs[name] < 1e-12, f"VMC replay {name} within 1e-12")
        phase("I", check="f64 VMC replay card vs CPU",
              proposals="gaussian" if gaussian else "uniform", steps=10,
              accepted=int(on_cpu[2].sum()), max_abs_err=errs, ok=True)


def vmc_rows_sum_rules(block, chains: int) -> dict:
    """S(0) = N^2 W, Re rho_0 = N W and OBDM(0) = W at every measured
    step; returns the largest relative deviation of each."""
    rules = {"ssf": (lambda x: x[:, 0, 0], VMC_NOP ** 2, SUM_RULE_RTOL),
             "re_rho0": (lambda x: x[:, 0, 1], VMC_NOP, SUM_RULE_RTOL),
             "obd": (lambda x: x[:, 0], 1, OBDM_RTOL)}
    devs = {}
    for name, (reduce, per_chain, rtol) in rules.items():
        rows = getattr(block, "iter_obd" if name == "obd" else "iter_ssf")
        if rows is None:
            continue
        require(bool(torch.isfinite(rows).all()), f"{name} rows finite")
        dev = float(((reduce(rows.double()) - per_chain * chains).abs()
                     / (per_chain * chains)).max())
        require(dev < rtol, f"{name} sum rule within {rtol}: {dev}")
        devs[name] = dev
    return devs


def run_vmc(device, card: str, label: str, sampling: vmc.Sampling,
            confs: np.ndarray, timed_blocks: int) -> dict:
    """Phases V1/V2: 1 burn block and ``timed_blocks`` timed blocks of
    ``NTS`` steps from ``confs``.  Returns E/N, the acceptance, the rate,
    the launch counts and the protocol that was run."""
    chains = sampling.num_walkers
    burn_blocks = 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t_start = time.perf_counter()
    state = sampling.build_state(confs, dtype=torch.float32, device=device)
    blocks = sampling.blocks(NTS, state)
    burn = [next(blocks) for _ in range(burn_blocks)][-1]
    burn_s = time.perf_counter() - t_start
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    done = [next(blocks) for _ in range(timed_blocks)]  # each ends in a fetch
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    steps_run = (burn_blocks + timed_blocks) * NTS
    require(launches["K1 log"] >= steps_run,
            f"{label}: K1 log launches {launches} cover {steps_run} steps")
    e_per_n = float(np.mean([float(b.iter_props.energy.double().mean())
                             for b in done])) / VMC_NOP
    accept = float(np.mean([b.accept_rate for b in done]))
    last = done[-1].last_state
    require(last.pos.shape == (chains, VMC_NOP)
            and bool(torch.isfinite(last.pos).all())
            and bool(torch.isfinite(last.wf_abs_log).all())
            and np.isfinite(e_per_n) and 0 < accept < 1,
            f"{label}: finite chains of the ensemble's shape")
    sum_rules = [vmc_rows_sum_rules(b, chains) for b in done]
    step_ms = start.elapsed_time(end) / (timed_blocks * NTS)
    rate = chains * timed_blocks * NTS / wall_s
    phase(label, check="VMC", card=card, chains=chains,
          est_every=sampling.est_every, steps_run=steps_run, burn_s=burn_s,
          timed_wall_s=wall_s, chain_steps_per_s=rate,
          step_ms_cuda_events=step_ms, peak_device_memory_gb=peak_gb,
          energy_per_boson=e_per_n, accept_rate=accept,
          burn_energy_per_boson=float(burn.iter_props.energy.double().mean())
          / VMC_NOP,
          measured_rows={name: sum(len(getattr(b, f"iter_{name}"))
                                   for b in done)
                         for name in ("ssf", "obd", "g2")
                         if getattr(done[0], f"iter_{name}") is not None},
          sum_rule_max_rel_dev={k: max(r[k] for r in sum_rules)
                                for k in sum_rules[0]},
          launches=launches, ok=True)
    return {"energy_per_boson": e_per_n, "accept_rate": accept,
            "chain_steps_per_s": rate, "launches": launches,
            "steps_run": steps_run,
            "protocol": dict(move_spread=sampling.move_spread,
                             ssf_modes=getattr(sampling.ssf_est_spec,
                                               "num_modes", None),
                             burn_blocks=burn_blocks,
                             timed_blocks=timed_blocks,
                             steps_per_block=NTS)}


def run_vmc_bench(device, card: str):
    """Phase V1; returns the launch counts and the steps run."""
    protocol = VMC_BAND_PROTOCOL
    sampling = vmc.Sampling(
        mrbp.Spec(**VMC_SPEC), move_spread=protocol["move_spread"],
        rng_seed=1, num_walkers=VMC_CHAINS,
        ssf_est_spec=vmc.SSFEstSpec(num_modes=protocol["ssf_modes"]))
    require(protocol["start"] == "uniform", "V1 starts uniform")
    confs = np.random.default_rng(0).uniform(
        0.0, float(VMC_NOP), (VMC_CHAINS, VMC_NOP)).astype(np.float32)
    out = run_vmc(device, card, "V1", sampling, confs, TIMED_BLOCKS)
    require(dict(out["protocol"], start="uniform") == protocol,
            f"V1 ran {out['protocol']}, the band's protocol is {protocol}")
    e_per_n, accept = out["energy_per_boson"], out["accept_rate"]
    require(abs(e_per_n - VMC_ENERGY_REF) < VMC_ENERGY_TOL,
            f"V1: E/N {e_per_n} within {VMC_ENERGY_TOL} of the JAX CPU "
            f"runs' {VMC_ENERGY_REF}")
    require(abs(accept - VMC_ACCEPT_REF) < VMC_ACCEPT_TOL,
            f"V1: acceptance {accept} within {VMC_ACCEPT_TOL} of the JAX "
            f"CPU runs' {VMC_ACCEPT_REF}")
    phase("V1", check="E/N and acceptance band", energy_per_boson=e_per_n,
          energy_ref=VMC_ENERGY_REF, energy_dev=e_per_n - VMC_ENERGY_REF,
          accept_rate=accept, accept_ref=VMC_ACCEPT_REF,
          accept_dev=accept - VMC_ACCEPT_REF, protocol=protocol, ok=True)
    return out["launches"], out["steps_run"]


def run_vmc_example(device, card: str):
    """Phase V2; returns the launch counts and the steps run."""
    spec = mrbp.Spec(**VMC_SPEC)
    sampling = vmc.Sampling(
        spec, move_spread=0.25, rng_seed=7, num_walkers=VMC_CHAINS,
        est_every=8, ssf_est_spec=vmc.SSFEstSpec(num_modes=64),
        obd_est_spec=vmc.OBDEstSpec(num_pos=32, est_every_mult=8))
    conf = spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR)
    out = run_vmc(device, card, "V2", sampling, conf, 1)
    return out["launches"], out["steps_run"]


def diffuse_inputs(device):
    """K3's inputs at the DMC shape: cloned parents with their K1 energy
    and drift, E_ref on the device; and the DMC step's own diffusion of
    the same inputs, ``step(xi=None)``: K2's noise for the same key (or
    the unit normals ``xi``) scaled by sigma, then
    ``dmc.Sampling.diffuse`` (torch move and recast, K1, weight)."""
    pos, params, kw = pair_inputs(BENCH_SPEC, MAX_WALKERS, torch.float32,
                                  device, seed=7)
    energy, drift = pairwise.energy_and_drift(pos, params, **kw)
    sampling = bench_sampling()
    # What the sampler makes once per run: the cast and packed parameters.
    cfc = mrbp.cast_params(sampling.cfc_params, torch.float32, device)
    step_params = pairwise.pack_params(cfc, torch.float32, device)
    args = dict(cpos=pos, cdrift=drift, cenergy=energy, params=params,
                dt=sampling.time_step, sigma=sampling.sigma_spread,
                e_ref=torch.tensor(ENERGY_REF * NOP, device=device),
                rng_seed=1, step=12345)

    def step(xi=None):
        if xi is None:
            xi = prng.normal(args["rng_seed"], args["step"], pos.shape,
                             pos.dtype, device)
        return sampling.diffuse(pos, drift, energy, sampling.sigma_spread * xi,
                                args["e_ref"], cfc, step_params)
    return args, kw, step


def check_k3(device) -> float:
    """Phase J; returns the largest abs error of the energies against
    the plain version on the same moved positions."""
    args, kw, step = diffuse_inputs(device)
    xi = prng.normal_plain(5, 6, args["cpos"].shape, torch.float32, device)
    count = pairwise.diffuse_energy_drift.launch_count
    fused = pairwise.diffuse_energy_drift(**args, **kw)
    injected = pairwise.diffuse_energy_drift(**args, xi=xi, **kw)
    torch.cuda.synchronize()
    require(pairwise.diffuse_energy_drift.launch_count == count + 2,
            "K3 launched")
    stepped = step()
    plain = pairwise.diffuse_energy_drift_plain(**args, **kw)
    injected_step = step(xi)
    injected_plain = pairwise.diffuse_energy_drift_plain(**args, xi=xi, **kw)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(x).all()) for x in fused + injected),
            "K3 outputs finite")
    # The drawn noise is K2's bit for bit: the moved positions equal the
    # DMC step's, whose normals come from the K2 kernel.
    require(torch.equal(fused[0], stepped[0]),
            "K3 noise equal to K2's (moved positions equal the step's)")
    require(torch.equal(injected[0], injected_step[0])
            and torch.equal(injected[0], injected_plain[0]),
            "K3 with injected xi: moved positions equal")
    d = fused[0] - plain[0]
    pos_err = float((d - NOP * torch.round(d / NOP)).abs().max())
    require(pos_err < 1e-4, f"K3 moved positions vs plain: {pos_err}")
    errs = {"npos_vs_plain_normals": pos_err}
    tol = K1_F32_TOL
    for label, got, want in (("step", fused, stepped),
                             ("plain", injected, injected_plain),
                             ("injected step", injected, injected_step)):
        torch.testing.assert_close(got[1], want[1],
                                   rtol=tol["energy_rtol"], atol=0.0)
        torch.testing.assert_close(got[2], want[2], rtol=tol["drift_rtol"],
                                   atol=tol["drift_atol"])
        torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0.0)
        errs[f"nenergy_vs_{label}"] = float((got[1] - want[1]).abs().max())
        errs[f"nweight_vs_{label}"] = float((got[3] - want[3]).abs().max())
    phase("J", check="K3 vs plain and the DMC step's diffusion", shape=list(
        args["cpos"].shape), words_equal_k2=True, max_abs_err=errs, ok=True)
    return errs["nenergy_vs_plain"]


def bound(flops: float, num_bytes: float) -> dict:
    """The least time the card could take: the larger of the flops over
    the FP32 peak and the bytes (each input read once, each output
    written once) over the HBM rate."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = num_bytes / PEAK_HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return {"bound_ms": ops_ms, "bound_by": "operations",
                "bound_resource": "fp32"}
    return {"bound_ms": bytes_ms, "bound_by": "bytes",
            "bound_resource": "hbm"}


def k1_bound(walkers: int, nop: int, log_psi: bool) -> dict:
    """K1's bound: its unordered pairs' flops; positions and parameters
    in, drift, energy (and log|psi|) out."""
    pairs = walkers * nop * (nop - 1) // 2
    flops = pairs * (K1_LOG_FLOPS_PER_PAIR if log_psi else K1_FLOPS_PER_PAIR)
    values = (2 * walkers * nop + (2 if log_psi else 1) * walkers
              + pairwise.PARAMS_SIZE)
    return bound(flops, F32_BYTES * values)


def k4_bound(rows: int, row_len: int, num_bins: int) -> dict:
    """K4's bound: the rows in, the counts out."""
    return bound(rows * row_len * K4_FLOPS_PER_ELEMENT,
                 F32_BYTES * (rows * row_len + rows * num_bins + 1))


def time_kernels(device, card: str) -> dict:
    """Phase E: kernel vs plain at the main path's shapes, in turns, each
    beside its bound; K2 also beside ``torch.randn``."""
    pos, params, kw = pair_inputs(BENCH_SPEC, MAX_WALKERS, torch.float32,
                                  device)
    shape = (MAX_WALKERS, NOP)
    density = torch.as_tensor(np.random.default_rng(6).uniform(
        0, NOP, shape), dtype=torch.float32, device=device)
    distances = pair_distances(device)
    unit, half = (torch.tensor(x, device=device) for x in (1.0, 0.5))
    # The tiled kernel at the density shape and 65,536 bins of L/65536.
    tiled_bins = K4_TILED_BINS[-1]
    fine = torch.tensor(NOP / tiled_bins, device=device)
    vpos, vparams, vkw = pair_inputs(VMC_SPEC, VMC_CHAINS, torch.float32,
                                     device)
    dargs, dkw, dstep = diffuse_inputs(device)
    walkers, numel = MAX_WALKERS, MAX_WALKERS * NOP
    pairs = walkers * NOP * (NOP - 1) // 2
    k3_bound = bound(pairs * K1_FLOPS_PER_PAIR + numel * K3_FLOPS_PER_ELEMENT,
                     F32_BYTES * (4 * numel + 3 * walkers
                                  + pairwise.PARAMS_SIZE + 1))
    cases = {
        "K1": (lambda: pairwise.energy_and_drift_plain(pos, params, **kw),
               lambda: pairwise.energy_and_drift(pos, params, **kw),
               5, 50, k1_bound(walkers, NOP, False)),
        "K2": (lambda: prng.normal_plain(1, 7, shape, torch.float32,
                                         device),
               lambda: prng.normal(1, 7, shape, torch.float32, device),
               20, 500, bound(numel * K2_FLOPS_PER_NORMAL,
                              F32_BYTES * numel)),
        "K4": (lambda: histogram.walker_histogram_plain(density, unit, NOP),
               lambda: histogram.walker_histogram(density, unit, NOP),
               20, 500, k4_bound(walkers, NOP, NOP)),
        "K4 g2": (lambda: histogram.walker_histogram_plain(distances, half,
                                                           NOP),
                  lambda: histogram.walker_histogram(distances, half, NOP),
                  5, 50, k4_bound(numel, NOP, NOP)),
        "K4 tiled": (lambda: histogram.walker_histogram_plain(
                         density, fine, tiled_bins),
                     lambda: histogram.walker_histogram(density, fine,
                                                        tiled_bins),
                     3, 10, k4_bound(walkers, NOP, tiled_bins)),
        "K1 log": (lambda: pairwise.energy_and_drift_plain(
                       vpos, vparams, with_log_psi=True, **vkw),
                   lambda: pairwise.energy_and_drift(
                       vpos, vparams, with_log_psi=True, **vkw), 5, 100,
                   k1_bound(VMC_CHAINS, VMC_NOP, True)),
        "K1 log dmc shape": (lambda: pairwise.energy_and_drift_plain(
                                 pos, params, with_log_psi=True, **kw),
                             lambda: pairwise.energy_and_drift(
                                 pos, params, with_log_psi=True, **kw),
                             5, 50, k1_bound(walkers, NOP, True)),
        "K3": (lambda: pairwise.diffuse_energy_drift_plain(**dargs, **dkw),
               lambda: pairwise.diffuse_energy_drift(**dargs, **dkw),
               5, 50, k3_bound),
        "K3 vs step": (
            dstep, lambda: pairwise.diffuse_energy_drift(**dargs, **dkw),
            50, 50, {}),
    }
    shapes = {"K4 g2": list(distances.shape), "K1 log": list(vpos.shape)}
    times = {}
    for name, (plain, kernel, plain_reps, kernel_reps, least) in \
            cases.items():
        p1 = cuda_ms(plain, plain_reps)
        k1 = cuda_ms(kernel, kernel_reps)
        k2 = cuda_ms(kernel, kernel_reps)
        p2 = cuda_ms(plain, plain_reps)
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                       **least}
        share = ({"bound_share": least["bound_ms"] / times[name]["ms"]}
                 if least else {})
        phase("E", kernel=name, card=card,
              shape=shapes.get(name, list(shape)),
              **{"step_ms" if name == "K3 vs step" else "plain_ms":
                 [p1, p2]}, kernel_ms=[k1, k2],
              speedup=(p1 + p2) / (k1 + k2), **least, **share, ok=True)
    # K2's yardstick: torch.randn draws standard normals of the same shape
    # on a CUDA generator, but from another stream (the generator's own
    # Philox offsets, not (seed, step)): timed, never used by the port.
    # Like for like, in turns: the allocating forms, and the out= forms
    # (K2 scaled by sigma, as the DMC step draws its noise).  Per call
    # first, the device times after: a profiler session slows the host's
    # next launches.
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    noise, buf = (torch.empty(shape, device=device) for _ in range(2))
    sigma = math.sqrt(2 * TIME_STEP)
    forms = {
        "allocating": (
            lambda: prng.normal(1, 7, shape, torch.float32, device),
            lambda: torch.randn(shape, device=device, generator=gen)),
        "out": (lambda: prng.normal(1, 7, shape, torch.float32, device,
                                    scale=sigma, out=noise),
                lambda: torch.randn(shape, generator=gen, out=buf)),
    }
    per_call = {}
    for form, (kernel, library) in forms.items():
        k1 = cuda_ms(kernel, 500)
        l1 = cuda_ms(library, 500)
        l2 = cuda_ms(library, 500)
        k2 = cuda_ms(kernel, 500)
        per_call[form] = [k1, k2], [l1, l2]
    # Device time (the kernels' own time, without the host's launch
    # path) of K2 and K4 at the main path's shapes.
    for name, reps in (("K2", 200), ("K4", 200), ("K4 g2", 20),
                       ("K4 tiled", 5)):
        ms = device_ms(cases[name][1], reps)
        times[name]["device_ms"] = ms
        phase("E", kernel=name, card=card, device_ms=ms,
              bound_ms=times[name]["bound_ms"],
              bound_share_of_device_time=(times[name]["bound_ms"] / ms
                                          if ms else None), ok=True)
    for form, (kernel, library) in forms.items():
        k_ms, l_ms = per_call[form]
        k_dev = device_ms(kernel, 200)
        l_dev = device_ms(library, 200)
        prefix = "out_" if form == "out" else ""
        if form == "out":
            times["K2"].update(out_ms=sum(k_ms) / 2, out_device_ms=k_dev)
        times["K2"].update({f"library_{prefix}ms": sum(l_ms) / 2,
                            f"library_{prefix}device_ms": l_dev})
        phase("E", kernel="K2 vs torch.randn", form=form, card=card,
              shape=list(shape), library_call="torch.randn, another stream",
              kernel_ms=k_ms, library_ms=l_ms, device_ms=k_dev,
              library_device_ms=l_dev,
              per_call_no_slower=sum(k_ms) <= sum(l_ms), ok=True)
    return times


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU "
                           "only")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # A. The card and the kernels' build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    log = _build.build()
    _build.library()
    phase("A", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
          build_s=time.perf_counter() - t0, built=bool(log), ok=True)
    print(log if log else "kernel library up to date", flush=True)

    err_k1 = check_k1(device)  # B
    err_k2 = check_k2(device)  # C
    check_replay(device)  # D
    dmc_launches, state, baseline = run_dmc(device, smi)  # D
    # Each run's launch counts and the steps it ran.
    runs = {"D": (dmc_launches, (BURN_BLOCKS + TIMED_BLOCKS) * NTS)}
    err_k4 = check_k4(device)  # F
    check_estimator_replay(device)  # G
    check_itc_replay(device)  # G
    # G3 is G2 with the ITC estimator: the same start state and the same
    # block offset, so that both consume the same random streams.
    done = {}
    for label, estimators, offset in (
            ("G1", G1_ESTIMATORS, BURN_BLOCKS + TIMED_BLOCKS),
            ("G2", G2_ESTIMATORS, BURN_BLOCKS + 2 * TIMED_BLOCKS),
            ("G3", G3_ESTIMATORS, BURN_BLOCKS + 2 * TIMED_BLOCKS)):
        done[label] = run_estimators(device, smi, state, label, estimators,
                                     offset, baseline)
        runs[label] = (done[label]["launches"], TIMED_BLOCKS * NTS)
    check_same_trajectory(done["G3"], done["G2"])
    time_itc_step(device, smi, state, done["G2"]["step_ms"], done["G3"])
    del done
    check_free_gas_itc(device, smi)  # P
    check_tonks_girardeau(device, smi)  # P
    err_k1_log = check_k1_log(device)  # H
    check_vmc_replay(device)  # I
    runs["V1"] = run_vmc_bench(device, smi)
    runs["V2"] = run_vmc_example(device, smi)
    err_k3 = check_k3(device)  # J
    times = time_kernels(device, smi)  # E

    # The main path's launches: each run of D, G1, G2, G3, V1 and V2
    # counts from 0.  K3 lies on no path (the DMC step keeps its own sequence,
    # as in the JAX package): none of those runs may have launched it.
    launches = {name: sum(counts[name] for counts, _ in runs.values())
                for name in COUNTERS}
    per_step = {name: {label: counts[name] / steps
                       for label, (counts, steps) in runs.items()
                       if counts[name]}
                for name in COUNTERS}
    require(all(launches[name] > 0 for name in ("K1", "K1 log", "K2", "K4")),
            f"every kernel of the main path launched: {launches}")
    require(launches["K3"] == 0, f"K3 off the main path: {launches}")
    require(all(per_step["K1"].get(label, 0) >= 1
                for label in ("D", "G1", "G2", "G3"))
            and all(per_step["K2"].get(label, 0) == 1
                    for label in ("D", "G1", "G2", "G3"))
            and per_step["K4"].get("G3", 0) > 0
            and all(per_step["K1 log"].get(label, 0) >= 1
                    for label in ("V1", "V2")),
            f"K1 on every DMC step (K2 once, K4 on G3's density and g2 "
            f"steps) and K1 log on every VMC step: {per_step}")

    def row(name, key, source, replaces, err, **extra):
        # No single PyTorch call computes K1, K3 or K4: library_ms null.
        # (K4 bins and counts every row on its own; torch.histc and
        # torch.bincount count one flat tensor, so a per-row histogram
        # takes a scatter_add_ of ones into (rows, bins), K4's plain
        # version.)
        return {"name": name, "route": "cuda",
                "source": f"phd_qmclib_torch/csrc/{source}",
                "replaces": f"phd_qmclib_tpu/ops/{replaces}",
                "launches": launches[key],
                "launches_per_step": per_step[key], "max_abs_err": err,
                "library_ms": None, **times[key], **extra}

    log_dmc, g2 = times["K1 log dmc shape"], times["K4 g2"]
    tiled = times["K4 tiled"]
    kernels = [
        row("pair_energy_drift", "K1", "pairwise.cu", "pairwise.py:84",
            err_k1),
        row("pair_logpsi_energy_drift", "K1 log", "pairwise.cu",
            "pairwise.py:84", err_k1_log, dmc_shape_ms=log_dmc["ms"],
            dmc_shape_plain_ms=log_dmc["plain_ms"],
            dmc_shape_bound_ms=log_dmc["bound_ms"]),
        row("philox_normals", "K2", "prng.cu", "prng.py:64", err_k2,
            library_call="torch.randn, another stream"),
        row("walker_histogram", "K4", "histogram.cu", "histogram.py:81",
            err_k4, g2_ms=g2["ms"], g2_plain_ms=g2["plain_ms"],
            g2_bound_ms=g2["bound_ms"], g2_device_ms=g2["device_ms"],
            tiled_bins=K4_TILED_BINS[-1], tiled_ms=tiled["ms"],
            tiled_plain_ms=tiled["plain_ms"],
            tiled_bound_ms=tiled["bound_ms"],
            tiled_device_ms=tiled["device_ms"]),
        row("diffuse_energy_drift", "K3", "diffuse.cu", "pairwise.py:210",
            err_k3, on_main_path=False,
            step_ms=times["K3 vs step"]["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
