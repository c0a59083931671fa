"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the DMC main path of ``phd_qmclib_torch`` at the bench
configuration (v0=20, r=1, gn=1, N=128 bosons, L=128, rm=0.4, dt=1e-3,
16,384 target walkers in a 17,408-slot buffer, f32) through its
hand-written CUDA kernels, without and with the estimators, and the VMC
path at the bench VMC configuration (the same model at N=64, L=64,
16,384 chains) and the variational example, and checks the kernels and
the physics:

A. the card's name and power limit; the kernels' build (``-Xptxas -v``:
   registers, stack and spills of each instantiation of the VJP, K2's
   rows kernel and K3);
B. the pair energy/drift kernel (K1) against its plain torch version,
   f32 at the main path's shape and f64;
C. the Philox normals kernel (K2) against its plain torch version: equal
   integer words, normals equal to f32 rounding, and their moments; its
   scaled ``out=`` form bit for bit ``scale *`` its unscaled output, f32
   and f64; its Box-Muller radius and unit cos/sin bit for bit those of
   the accurate ``logf``/``sqrtf`` form over all 2^24 values of each
   uniform;
D. a small f64 replay on the card against the same replay on the CPU,
   then the DMC run: 6 burn blocks and 2 measured blocks of 512 steps;
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
   lags, every 256th step), 2 blocks of 512 steps each: the E/N band,
   the sum rules at every measured step, and the kernels' launch counts;
   G1's rate, ms per step and peak memory (no benchmark cell runs its
   load).  G3 starts from G2's state on G2's random streams: its
   per-step ensemble scalars and final positions must equal G2's bit for
   bit (the estimator must not touch the dynamics); at every ITC row
   the k = 0 column is N^2 times the counts, lags beyond the fill carry
   zero sums and counts, and the fill counter ends at 4;
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
   every step, uniform random starts): 1 burn block and 2 measured
   blocks of 512 steps; E/N and the acceptance must land in the band of
   the JAX package's VMC run of the same protocol on a CPU; the S(k) sum
   rules at every step;
V2. the variational example (``examples/vmc_variational.yml``:
   move_spread 0.25, ``est_every`` 8, 64-mode S(k), 32-point OBDM every
   64th step, regular start) without its checkpoints and HDF5 output: 1
   burn block and 1 measured block of 512 steps; the S(k) and OBDM sum
   rules at every measured step;
J. the fused diffusion kernel (K3) against its plain version and the
   DMC step's own diffusion (``dmc.Sampling.diffuse`` on K2's noise: K2,
   torch ops, K1) at 17408 x 128 f32: its noise is K2's bit for bit;
E. each kernel's time against its plain version at the main path's
   shapes, alternating plain, kernel, kernel, plain (K3 also against the
   step's own diffusion), beside its bound: the larger of its flops over
   the FP32 peak and its bytes over the HBM rate, counted from the
   shapes (K3 also under the first design's count of its noise).  K2
   and K4 also give their device time (the profiler's kernel time), and
   K2 stands beside ``torch.randn`` (another stream), like for
   like, per call and on the device: the allocating form against
   ``torch.randn(shape, generator=gen)``, the ``out=`` form (scaled by
   sigma, as the DMC step draws it) against ``torch.randn(shape,
   generator=gen, out=buf)``, in turns.
O. the OBDM grid's kernel (``funcs.one_body_density_grid`` on a CUDA
   tensor) against its plain version at the production and variational
   shapes (17408 x 128 and 16384 x 64, 32 offsets over [0, L/2]): in f32
   both against the f64 plain version at the same inputs, the kernel's
   largest gap at most 4 times the plain f32 version's; in f64 within
   1e-12 of the plain version; n1(0) exactly 1; each shape timed against
   the plain version in turns, beside its bound.
K. the S(k) harmonics' kernel (``funcs.fourier_density_parts_harmonics``
   on a CUDA tensor) against its plain recurrence at the sk, variational
   and production shapes (16384 x 64 x 32, 16384 x 64 x 64, 17408 x 128 x
   64; positions in [0, L)): f32 within the bound of the particle sums'
   order (the elements are rounded alike), f64 within 1e-12 of each
   slot's scale, the k = 0 mode exact; the ITC pair bit for bit its slots
   1-2; each shape timed against the plain version in turns (the call
   through the dispatch, launch included, and the kernel's device time),
   beside its bound; and a 4-row table (four supercells at N=64, 64
   modes, 4 x 4,352 walkers), each row bit-equal to its launch alone,
   timed beside the single-row launch at the same width.

R. the same paths through the execution layer (``qmc_exec``), from
   config dicts to an in-memory ``ProcResult`` (a GPU machine need not
   have ``h5py``, ``yaml`` or ``click``: files are the CPU tests' job; the
   dicts are held equal to the shipped examples' ``proc`` stanzas by
   ``tests/test_torch_cli.py``):
   R0, the entry from nothing: ``dmc.Proc.from_config`` at the bench
   configuration, ``ProcInput.from_model_sys_conf_spec(RANDOM)`` (16,384
   configurations), ``exec`` with D's depth; E/N from
   ``result.data.blocks.energy`` within 0.02 of 8.41614;
   R1, the production example through ``Proc.exec``: one block from the
   state G3 starts from, on G3's streams and with G3's sampling (the
   controller factor of ``bench.py``'s sampling, and a CM window of the
   one block): the ``energy``, ``weight``, ``num_walkers``,
   ``ref_energy`` and ``accum_energy`` series and every estimator series
   must equal G3's first block bit for bit (after the same cast to f64),
   the pure ITC window sample G3's last ITC row; the sum rules read from
   ``result.data``;
   R2, the variational example through ``vmc.Proc.exec``: one burn block
   and one block from the example's regular start, series bit-equal to
   V2's block reduced the same way, the acceptance V2's;
   R3, resume on the card: R0's configuration with a pure density over a
   two-block window at a small depth, cut after block 1 by the in-memory
   checkpoint ``exec`` hands to its ``checkpoint_hook``, resumed from it:
   bit-equal to the uninterrupted run.

W. the wavefunction optimization:
   W0, the parameter VJP of K1 log (the optimizer's backward kernel)
   against autograd of the plain version: f64 at 256 walkers on the
   bench, free, ideal and defected models at N = 5, 64 and 128, every slot
   within rtol 1e-9; f32 at 4096 x 128 against the f64 plain version
   (``K1_VJP_F32_TOL``); its time beside K1 log's at 4096 x 128 and
   16384 x 64, alternating plain, kernel, kernel, plain, with its bound;
   W1, the shipped pipeline ``examples/wf_opt_pipeline.yml`` from config
   dicts (``tests/test_torch_wf_opt_cli.py`` holds them equal to the
   file): ``WFOptAppSpec.exec`` (VMC at N=16, 512 chains, then the joint
   gradient optimization), then the DMC ``Proc.exec`` at the optimum, in
   memory: rm* and v0* inside their bounds, the variance at the optimum
   <= the start's, the DMC E/N finite;
   W2, ``benchmarks/wf_opt_compare.py --joint --equil-steps 1024`` in the
   port, f32: VMC at the bench model with rm0 = 0.2, 4,096 chains from a
   crystal start, then DE (its evaluations counted), the gradient
   optimizer and the joint one, each timed, then fresh VMC at the
   initial, the rm-only and the joint trial: DE and grad rm* within 0.01,
   the joint variance <= the rm-only one (its ratio printed beside the
   JAX run's), the rm-only trial's E/N below the initial's by more than 5
   combined errors.
   In W1 and W2 every gradient optimization must launch K1 log once per
   grid point and per evaluation and the VJP kernel once per backward,
   and no plain pair function may run on a CUDA tensor
   (``watch_optimizer``).

S. fused parameter sweeps (``phd_qmclib_torch.parallel``,
   ``qmc_exec.sweep``):
   S0, the row variants of the kernels: K1 forward and log with a 4-row
   parameter table (couplings, cutoffs and supercells differ) at 4 x
   4,352 walkers of N=64, f32 against the plain version at phase B's
   tolerances and f64 within 1e-12 (normwise), each row bit-equal to a
   launch on its rows alone; K2 with four keys and scales, word-equal to
   four single-row launches and to the plain version, also at a row
   length that is not a multiple of 4; K4 with four bin widths at the
   density and g2 shapes, bit-equal to the plain version and to one
   launch per row; the OBDM grid with a 4-row parameter and offset table
   (each row its supercell's grid), each row bit-equal to its launch
   alone, f64 within 1e-12 of the plain version and f32 within 4 times
   the plain f32 version's gap from the f64 one; each timed beside its
   single-row form at the same total width (and K2 beside
   ``torch.randn``);
   S1, ``examples/eos_fused_sweep.yml`` at full width (4 rows x 4,352
   slots, N=64, f32) from config dicts (held equal to the file by
   ``tests/test_torch_cli.py``), cut to 1 burn-in and 2 measured blocks
   of 512 steps, through ``SweepProc.exec`` and, row by row, through
   ``Proc.exec``: each row bit-equal to its standalone run (else the
   first step that parts, and E/N within 5 combined reblocked errors);
   walker-steps/s fused and sequential and their ratio, ms/step (CUDA
   events), a 64-step block of each profiled (device busy share, kernel
   launches per step), peak memory, each row's E/N and
   ``report.summarize``'s; S1b, a density scan at fixed N (the first EOS
   row at L = 64, 60, 56, 52) with the production example's density,
   64-mode pure S(k) and g2, one measured block fused and row by row,
   bit-equal (K4's bin-size groups and the S(k) kernel's table of 2 pi / L
   on the path);
   S2, the variational example's model and estimators as four rows of
   4,096 chains at rm 0.3-0.6 (``VmcSweep``), one burn-in and one
   measured block, each row bit-equal to its standalone ``vmc.Sampling``
   run; chain-steps/s fused and sequential;
   S3, rows that differ in the time step: the bench model at dt 4e-3,
   2e-3, 1e-3 and 5e-4 (a dt -> 0 series), 4,096 target walkers in 4,352
   slots a row, energy only, f32, one burn-in and two measured blocks of
   128 steps through ``ParamSweep``, each row bit-equal to its standalone
   ``Sampling.blocks`` run with the same seed.
M. several ranks, a walker mesh (one process per rank,
   ``parallel.launch``): M0, the bench configuration through
   ``Proc.exec`` with ``num_mesh_devices: 1``, one rank over NCCL (its
   collectives every step), E/N in the band, its ms/step; M1, 4
   gloo ranks on the card (NCCL takes one rank per GPU), 4 x 4,352 slots
   from D's state with density and S(k) and a rebalance at every block:
   E/N in the band, the sum rules at every measured step, a rebalance
   keeping the sorted positions bit-equal; M2, the 2-shard f64
   injected-noise replay on the card against the CPU; M3, a forced shard
   collapse (two of four shards empty) rebalanced and resumed, and its
   checkpoint resumed on 2 ranks; M4, ``fused_sweep_mesh: [2, 2]``, two
   EOS rows on 4 ranks, each bit-equal to its run alone on 2 ranks; M5,
   the variational example on 2 ranks.  Step times over gloo on one card
   measure correctness only.
U. the port against the upstream library's own draws: the serial VMC
   and DMC loops of the library the JAX package was modelled on, replayed
   draw for draw on the host by ``phd_qmclib_torch.reference_replay``
   (``tests/test_reference_replay.py``'s model, N=16: a 1,500-step chain
   of uniform moves, an 800-step chain of Gaussian moves, 400 DMC steps
   at dt 5e-4 with ``ref_compat``), drive ``vmc.Sampling.replay_chain``
   and ``dmc.Sampling.replay_states`` on the card in f64 (K1 log and K1):
   acceptance decisions equal, chain positions bit-exact, log|psi| within
   rtol 1e-12; walker counts and branching tables equal, positions within
   5e-11, walker energies within 1e-9, weights within 1e-10, the ensemble
   energy, E_ref and the accumulated energy within rtol 1e-10; the
   largest deviation of each printed;
N. the native reblocking cascade (``stats.native``: ``g++`` on the
   card's host builds ``phd_qmclib_torch/csrc/reblock.cpp``): available,
   and its tables of a 2^20 x 4 series within rtol 1e-12 of the NumPy
   path's; both paths' host ms, in turns, beside the host's CPU model.

Every kernel's launches are counted from 0 over the runs of D, G1, G2,
G3, V1, V2, R0, R1, R2, W1 (and its DMC stage), W2, S1, S1b, S2, S3, M0,
and M1 and M5 (their rank 0, in this process), in
all and per step of each run; K1 must run on every DMC step and K1 log
on every VMC step, the OBDM kernel on the OBDM steps of G3, R1, V2 and
R2, the S(k) kernel in G1, G2, G3, R1, V1, V2, R2, S2 (whose rows share
one L: one row a launch) and M5 and its table in S1b (four L), a fused
DMC step must launch K1's table and K2's rows once, a fused VMC step K1 log's table, and S2's fused OBDM steps the
OBDM kernel's table.  K3 lies on none of them (the DMC
step keeps its own sequence, as in the JAX package), and its count
there must stay 0.  Beside them the step graphs' captures and replays
(``dmc.step_graph``, ``vmc.step_graph``): the single-row runs on the
card, DMC's D, G1, G2, G3, R0 and R1 and VMC's V1, V2, R2 and W1's VMC
stage, must capture once and replay every step after the first (a
replay counts its K1 or K1 log launch, and in V1 its S(k) launch); the
fused sweeps S1, S1b, S2 and S3 and the meshes M0, M1 and M5 must replay
none.

The second-to-last line is the per-kernel JSON summary and the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the script
exits non-zero and prints no result.  It needs a CUDA device and the
repository's ``phd_qmclib_torch`` package next to it.
"""
import dataclasses
import json
import math
import os
import platform
import re
import shutil
import subprocess
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from phd_qmclib_torch import (lieb_liniger, parallel, reference_replay,
                              wf_opt)
from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import _build, histogram, pairwise, prng, ssf
from phd_qmclib_torch.qmc_exec import (cli_app, dmc as dmc_exec, report,
                                       sweep as sweep_exec, vmc as vmc_exec)
from phd_qmclib_torch.samplers import dmc, vmc
from phd_qmclib_torch.stats import native, reblock
# The peaks, K1's flop counts and the bound arithmetic: the benchmark's
# frozen copy, read also as ``chip_smoke.<name>`` by
# ``tools/kernel_compare.py`` and the tests.
from portbench.yardstick import (F32_BYTES, K1_FLOPS_PER_PAIR,
                                 K1_LOG_FLOPS_PER_PAIR, PEAK_FP32_FLOPS,
                                 PEAK_HBM_BYTES_PER_S, bound, k1_bound)

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

#: Flops per unit of work, counted as ``portbench/yardstick.py`` counts
#: K1's (``K1_FLOPS_PER_PAIR``, ``K1_LOG_FLOPS_PER_PAIR``, per unordered
#: pair in ``csrc/pair_terms.cuh::walker_terms``; fma = 2, a MUFU op = 1;
#: compares, selects and integer ops not counted, so each bound stays a
#: least time): one Box-Muller per pair of normals
#: (``csrc/philox.cuh::box_muller``: ~40 flops, 20 per normal; the
#: Philox rounds are integer ops); K4 per element (the exact floor of
#: ``csrc/histogram.cu::FastBin``: the multiply by the reciprocal, the
#: floor, the fma of the remainder and the one correction).
K2_FLOPS_PER_NORMAL = 20
K4_FLOPS_PER_ELEMENT = 5
#: K1 log's parameter VJP per unordered pair as written
#: (``csrc/pair_terms_grad.cuh::pair_vjp_terms``, counted the same way):
#: 28 common to both branches (the difference, the image, the rational
#: tan 14, the ratio, 1 + v^2, the drift factor, fs v, the argument's
#: weight G 6), then 11 inside the cutoff (the argument's fma, the k2,
#: r_off and am sums) and 7 outside (the argument's multiply, the sums of
#: t, fs v, log t and r G; the sum of G where a pair wraps is not
#: counted, so the bound stays a least time); the O(N) one-body terms,
#: the weights applied after the loop and the reductions left out.  The
#: bound counts each pair by its branch in the run's own positions.  The
#: first design (a ``pair_grad_terms`` with one branch per side of the
#: cutoff) took 57 and 60: 32 common (the sin and cos polynomials 22),
#: then 25 and 28.
K1_VJP_FLOPS_IN_CUT, K1_VJP_FLOPS_OUTSIDE = 39, 35
K1_VJP_FIRST_DESIGN_FLOPS = (57, 60)
#: K3 (``csrc/diffuse.cu``), counted the same way: per element its move
#: (4) and its share of a Box-Muller (20); per unordered pair outside the
#: cutoff the fast body of ``ring_pair`` (the difference 1, the image
#: L - |d| 1, r^2 1, the two polynomials 12, r P, the reciprocal and the
#: ratio 3, the three sums 6: 24), per pair inside it K1's ``pair_terms``
#: (28).  The bound counts each pair by its side of the cutoff in the
#: run's moved positions (a step that the vote sends through K1's body
#: does more work than it needs, so it is not counted).  The first design counted every pair as K1's (28) and 44
#: per element: the move and the whole Box-Muller of the element's pair,
#: which each of its threads recomputed.
K3_FLOPS_IN_CUT, K3_FLOPS_OUTSIDE = K1_FLOPS_PER_PAIR, 24
K3_FLOPS_PER_ELEMENT = 24
K3_FIRST_DESIGN_FLOPS = ((K1_FLOPS_PER_PAIR, K1_FLOPS_PER_PAIR), 44)
#: The OBDM grid (``csrc/obd.cu``) per ordered pair, at an offset or at
#: none, as its header counts a pair outside the cutoff (the difference,
#: L - |d|, the polynomial of sin(pi r / L) in r 12, the log2 and its
#: weighted sum); the bound counts every pair so, inside the cutoff too,
#: and leaves out the one-body terms and the exponential of each item.
OBD_FLOPS_PER_PAIR = 17
#: The production and variational examples' grid: 32 offsets over
#: [0, L/2].
OBD_NUM_POS = 32
#: The OBDM kernel in f64 against the f64 plain version (the same
#: formulas, the pair sums in another order); in f32, its largest gap
#: from the f64 plain version at the same inputs is at most this many
#: times the plain f32 version's own (the MUFU log2 and the sums' order
#: against torch's log and reduction).
OBD_F64_TOL, OBD_F32_GAP_FACTOR = 1e-12, 4
#: The S(k) harmonics (``csrc/ssf.cu``) per particle and mode: the
#: recurrence's two products and two differences, and the two sums.
SSF_FLOPS_PER_ELEMENT = 6
#: Phase K's shapes: the sk, variational and production cells' walkers,
#: particles and modes.
SSF_SHAPES = (("sk", 16384, 64, 32), ("variational", 16384, 64, 64),
              ("production", 17408, 128, 64))
#: The S(k) kernel in f64 against the f64 plain version, relative to each
#: slot's scale (N^2 for |rho_k|^2, N for Re/Im rho_k).
SSF_F64_RTOL = 1e-12

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
#: Phase R's procedure configurations, as config dicts.  BENCH_PROC: the
#: bench configuration at D's depth (``bench.py:99-111``; its sampling's
#: controller factor is the sampler's default, 0.125).  PRODUCTION_PROC and
#: VARIATIONAL_PROC: the ``proc`` stanzas of ``examples/dmc_production.yml``
#: and ``examples/vmc_variational.yml`` without their checkpoint keys (a
#: checkpoint is a file); ``tests/test_torch_cli.py`` holds them equal to
#: the files.
BENCH_PROC = dict(
    model_spec=BENCH_SPEC, time_step=TIME_STEP, max_num_walkers=MAX_WALKERS,
    target_num_walkers=TARGET_WALKERS, num_walkers_control_factor=0.125,
    rng_seed=1, num_blocks=TIMED_BLOCKS, num_time_steps_block=NTS,
    burn_in_blocks=BURN_BLOCKS, dtype="float32")
PRODUCTION_PROC = dict(
    model_spec=BENCH_SPEC, time_step=1e-3, max_num_walkers=17408,
    target_num_walkers=16384, num_blocks=64, num_time_steps_block=512,
    burn_in_blocks=8, rng_seed=1, dtype="float32", est_every=8,
    density_spec=dict(num_bins=128, as_pure_est=True),
    ssf_spec=dict(num_modes=64, as_pure_est=True, pfw_num_time_steps=512),
    obd_spec=dict(num_pos=32, as_pure_est=True, est_every_mult=8),
    pair_corr_spec=dict(num_bins=128, as_pure_est=True, est_every_mult=8),
    cm_diffusion_spec=dict(window_blocks=8),
    itc_spec=dict(num_modes=32, num_lags=64, est_every_mult=32,
                  as_pure_est=True))
VARIATIONAL_PROC = dict(
    model_spec=dict(BENCH_SPEC, boson_number=64, supercell_size=64.0),
    move_spread=0.25, num_walkers=16384, num_blocks=16, num_steps_block=512,
    burn_in_blocks=2, rng_seed=7, dtype="float32", est_every=8,
    ssf_spec=dict(num_modes=64),
    obd_spec=dict(num_pos=32, est_every_mult=8))
#: Phase S1: the ``proc`` stanzas of ``examples/eos_fused_sweep.yml`` (an
#: EOS scan: four couplings, N=64, 4,096 target walkers in 4,352 slots
#: each, f32), as config dicts; ``tests/test_torch_cli.py`` holds them
#: equal to the file.
EOS_NOP, EOS_SLOTS = 64, 4352
EOS_ROW = dict(
    model_spec=dict(lattice_depth=20.0, lattice_ratio=1.0,
                    interaction_strength=0.25, boson_number=EOS_NOP,
                    supercell_size=64.0, tbf_contact_cutoff=0.4),
    time_step=1e-3, max_num_walkers=EOS_SLOTS, target_num_walkers=4096,
    num_blocks=32, num_time_steps_block=512, burn_in_blocks=8,
    rng_seed=11, dtype="float32")
EOS_PROCS = tuple(
    dict(EOS_ROW, model_spec=dict(EOS_ROW["model_spec"],
                                  interaction_strength=gn), rng_seed=seed)
    for gn, seed in ((0.25, 11), (0.5, 12), (1.0, 13), (2.0, 14)))
#: S1's depth: one burn-in block and two measured blocks of 512 steps.
S1_DEPTH = dict(num_blocks=2, burn_in_blocks=1)
#: S1b: the first EOS row at these supercells (a density scan at fixed
#: N), with the production example's density and g2.
S1B_SUPERCELLS = (64.0, 60.0, 56.0, 52.0)
#: S0's four rows at N=64: (coupling, cutoff, supercell), all different
#: but for one supercell.
S0_ROWS = ((0.25, 0.4, 64.0), (0.5, 0.35, 60.0), (1.0, 0.45, 68.0),
           (2.0, 0.3, 64.0))
#: S0: K1's table in f64 against its plain version, normwise.
S0_K1_F64_RTOL = 1e-12
#: Phase S2: the variational example's model and estimators as four rows
#: of 4,096 chains, the trial cutoffs of a variational scan.
S2_RMS = (0.3, 0.4, 0.5, 0.6)
S2_CHAINS = 4096
#: Phase S3: the bench model as four rows that differ in the time step (a
#: dt -> 0 series), 4,096 target walkers in 4,352 slots a row, energy
#: only, one burn-in and two measured blocks of 128 steps.
S3_TIME_STEPS = (4e-3, 2e-3, 1e-3, 5e-4)
S3_WALKERS = dict(max_num_walkers=4352, target_num_walkers=4096)
S3_NTS, S3_BLOCKS = 128, 3
#: Phase U: ``tests/test_reference_replay.py``'s model, its two VMC chains
#: (move spread, seed, steps, Gaussian proposals; the start's seed) and
#: its DMC run (``ref_compat``), replayed by ``reference_replay`` on the
#: host and driven through the port's samplers on the card in f64.
UPSTREAM_MODEL = dict(lattice_depth=12.0, lattice_ratio=1.0,
                      interaction_strength=4.0, boson_number=16,
                      supercell_size=16.0, tbf_contact_cutoff=0.35)
UPSTREAM_CHAINS = (
    ("uniform", dict(move_spread=0.25, rng_seed=991, num_steps=1500,
                     gaussian=False), 3),
    ("gaussian", dict(move_spread=float(np.sqrt(1e-3)), rng_seed=313,
                      num_steps=800, gaussian=True), 6))
UPSTREAM_DMC = dict(time_step=5e-4, max_num_walkers=48,
                    target_num_walkers=32, sampling_seed=7, conf_seed=12,
                    rng_seed=1234, num_steps=400)
#: Its tolerances (``tests/test_reference_replay.py``): log|psi| rtol and
#: atol; DMC positions atol; walker energies rtol and atol; weights rtol
#: and atol; the ensemble energy, E_ref and the accumulated energy rtol.
UPSTREAM_TOL = dict(wf_abs_log=(1e-12, 1e-12), pos=(0.0, 5e-11),
                    energies=(1e-9, 1e-9), weights=(1e-10, 1e-12),
                    energy=(1e-10, 0.0), ref_energy=(1e-10, 0.0),
                    accum_energy=(1e-10, 0.0))
#: Phase N: the native reblocking cascade against the NumPy path on a
#: series of this many samples and columns, tables within rtol 1e-12.
NATIVE_SERIES = (2 ** 20, 4)
NATIVE_RTOL = 1e-12
#: The keys of an example's ``proc`` stanza that phase R sets to its own
#: depth or leaves out.
PROC_DEPTH_KEYS = ("num_blocks", "burn_in_blocks", "block_offset",
                   "checkpoint_file", "checkpoint_every", "checkpoint_light")
#: What R1 sets besides the depth to run G3's sampling: ``bench.py``'s
#: controller factor (a procedure's default is 0.5) and a CM-diffusion
#: window that divides its one block.
R1_SAMPLING_KEYS = ("num_walkers_control_factor", "cm_diffusion_spec")
#: R3's depth: blocks, burn-in blocks, steps per block.
R3_DEPTH = dict(num_blocks=4, burn_in_blocks=1, num_time_steps_block=64)
#: Phase W1, the shipped pipeline ``examples/wf_opt_pipeline.yml``: its
#: wf_opt stanza (VMC at N=16, 512 chains, then the joint gradient
#: optimization over 512 configurations) and its DMC stanza's ``proc``
#: (at the optimum), without the output handler (a file);
#: ``tests/test_torch_wf_opt_cli.py`` holds them equal to the file.
WF_OPT_MODEL = dict(lattice_depth=12.0, lattice_ratio=1,
                    interaction_strength=4.0, boson_number=16,
                    supercell_size=16.0, tbf_contact_cutoff=2.0)
WF_OPT_STANZA = dict(
    proc_type="wf_opt", method="grad", opt_obf_lattice_depth=True,
    num_sys_confs=512,
    proc=dict(model_spec=WF_OPT_MODEL, move_spread=0.25, num_blocks=4,
              num_steps_block=512, burn_in_blocks=2, num_walkers=512,
              rng_seed=101),
    input=dict(type="MODEL_SYS_CONF", dist_type="RANDOM"))
WF_OPT_DMC_PROC = dict(
    model_spec=WF_OPT_MODEL, time_step=2.5e-4, max_num_walkers=544,
    target_num_walkers=512, num_blocks=32, num_time_steps_block=128,
    rng_seed=102, density_spec=dict(num_bins=32, as_pure_est=True))
#: Phase W2, ``benchmarks/wf_opt_compare.py --joint --equil-steps 1024``
#: in the port: the bench model at rm0 = 0.2, 4,096 chains of VMC
#: (move_spread 0.12) from a crystal start, blocks of 1,024 steps.
WF_OPT_AB = dict(rm0=0.2, chains=4096, move_spread=0.12, equil_steps=1024,
                 sampling_seed=11, start_seed=5, fresh_seed=13)
#: The JAX package's run of that protocol (``BASELINE.md:910-932``;
#: physics, not times): rm* by DE and by the gradient, the variances at
#: the rm-only and the joint optimum, and the fresh-VMC E/N (error) at
#: the initial and the rm-only trial.
WF_OPT_AB_JAX = dict(rm_de=0.4604, rm_grad=0.4631, variance_rm_only=27.418,
                     variance_joint=26.073, e_initial=(8.42803, 0.00053),
                     e_rm_only=(8.41897, 0.00040))
#: W2's checks: DE and gradient optima within 0.01 in rm; the rm-only
#: trial's fresh-VMC E/N below the initial trial's by more than 5
#: combined errors.
WF_OPT_RM_TOL, WF_OPT_SIGMAS = 0.01, 5.0
#: W0: the VJP kernel against its plain version.  f64 (every slot):
#: rtol 1e-9 (sums of W N^2/2 terms in another order).  f32, against the
#: f64 plain version at the same (f32) inputs: each slot within 1e-3 of
#: itself plus 1e-5 of the largest slot.  The drift the kernel takes is
#: the f32 forward's, within 1e-3 relative of f64 (K1_F32_TOL), and its
#: share of dE/dp is -2 (s_i F_i + s_j F_j) dldz/dp: 1e-3 bounds the
#: error it carries; the sums over 4096 walkers of terms of both signs
#: cancel to a small slot at times, hence the term in the largest slot.
K1_VJP_F64_RTOL = 1e-9
K1_VJP_F32_TOL = dict(rtol=1e-3, rtol_of_max=1e-5)
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


#: Each kernel's launch counter, and the DMC and VMC step graphs'
#: captures and replays: the function and its attribute.
COUNTERS = {"K1": (pairwise.energy_and_drift, "launch_count"),
            "K1 log": (pairwise.energy_and_drift, "log_psi_launch_count"),
            "K1 vjp": (pairwise.energy_and_drift, "params_vjp_launch_count"),
            "K2": (prng.normal, "launch_count"),
            "K3": (pairwise.diffuse_energy_drift, "launch_count"),
            "K4": (histogram.walker_histogram, "launch_count"),
            "OBDM": (pairwise.obd_grid, "launch_count"),
            # The row variants of a fused sweep.
            "K1 table": (pairwise.energy_and_drift, "table_launch_count"),
            "K1 log table": (pairwise.energy_and_drift,
                             "log_psi_table_launch_count"),
            "K2 rows": (prng.normal_rows, "launch_count"),
            "K4 groups": (histogram.walker_histogram, "group_launch_count"),
            "OBDM table": (pairwise.obd_grid, "table_launch_count"),
            "S(k)": (ssf.ssf_harmonics, "launch_count"),
            "S(k) table": (ssf.ssf_harmonics, "table_launch_count"),
            # The step graphs' (require_graphed).
            "graph captures": (dmc.step_graph, "capture_count"),
            "graph replays": (dmc.step_graph, "replay_count"),
            "VMC graph captures": (vmc.step_graph, "capture_count"),
            "VMC graph replays": (vmc.step_graph, "replay_count")}


def require_graphed(launches: dict, steps_run: int, label: str,
                    sampler: str = "") -> None:
    """One run of one row on the card: one capture, and every step but
    the first replayed (``sampler`` ``"VMC "``: the VMC step graph's)."""
    require(launches[f"{sampler}graph captures"] == 1
            and launches[f"{sampler}graph replays"] == steps_run - 1,
            f"{label}: one {sampler}step graph capture and "
            f"{steps_run - 1} replays in {steps_run} steps: {launches}")


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


def bench_sampling(spec_kwargs=BENCH_SPEC, **estimators) -> dmc.Sampling:
    return dmc.Sampling(mrbp.Spec(**spec_kwargs), time_step=TIME_STEP,
                        max_num_walkers=MAX_WALKERS,
                        target_num_walkers=TARGET_WALKERS, rng_seed=1,
                        **estimators)


def check_energy(props_list, label: str) -> float:
    """E/N of the measured blocks, held to the stored band."""
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
    launch counts and the last state."""
    spec = mrbp.Spec(**BENCH_SPEC)
    sampling = bench_sampling()
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(TARGET_WALKERS)]).astype(np.float32)

    reset_counts()
    state = sampling.build_state(confs, dtype=np.float32, device=device)
    blocks = sampling.blocks(state, num_time_steps_block=NTS,
                             burn_in_blocks=BURN_BLOCKS)
    for _ in range(BURN_BLOCKS):
        block = next(blocks)
    props_list, walker_steps = [], 0
    for _ in range(TIMED_BLOCKS):
        block = next(blocks)
        props_list.append(block.iter_props)
        walker_steps += int(block.iter_props.num_walkers.sum())
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
    require_graphed(launches, steps_run, "D")
    phase("D", check="DMC bench config", card=card, steps_run=steps_run,
          mean_num_walkers=walker_steps / (TIMED_BLOCKS * NTS),
          energy_per_boson=e_per_boson,
          energy_dev=e_per_boson - ENERGY_REF, launches=launches, ok=True)
    return launches, last


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
                   block_offset: int, timed: bool = False) -> dict:
    """Phase G1/G2/G3: 2 blocks with estimators from ``state``, and with
    ``timed`` (G1's load, which no benchmark cell runs) their rate,
    CUDA-event ms per step and peak memory.  Returns the launch counts of
    the run, its per-step ensemble scalars and its final state."""
    sampling = bench_sampling(**estimators)
    reset_counts()
    blocks = sampling.blocks(state, num_time_steps_block=NTS,
                             block_offset=block_offset)
    if timed:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
    done = []
    for _ in range(TIMED_BLOCKS):
        block = next(blocks)
        # Only the last block's state is kept: an earlier one would hold
        # its ITC ring buffer alive.
        last = block.last_state
        done.append(block._replace(last_state=None))
    rate = {}
    if timed:
        end.record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        walker_steps = sum(int(b.iter_props.num_walkers.sum()) for b in done)
        rate = dict(
            timed_wall_s=wall_s, walker_steps_per_s=walker_steps / wall_s,
            step_ms_cuda_events=start.elapsed_time(end) / (TIMED_BLOCKS
                                                           * NTS),
            peak_device_memory_gb=torch.cuda.max_memory_allocated(device)
            / 1e9)
    launches = read_counts()
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
    require_graphed(launches, steps_run, label)
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
    phase(label, check="DMC with estimators", card=card,
          estimators=sorted(k for k, v in estimators.items()
                            if k.endswith("_spec") and v is not None)
          + (["cm_diffusion"] if sampling.cm_diffusion_est else []),
          est_every=sampling.est_every, steps_run=steps_run, **rate,
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
            "pos": last.pos, "blocks": done}


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
    """Phases V1/V2: 1 burn block and ``timed_blocks`` measured blocks
    of ``NTS`` steps from ``confs``.  Returns E/N, the acceptance, the
    launch counts and the protocol that was run."""
    chains = sampling.num_walkers
    burn_blocks = 1
    reset_counts()
    state = sampling.build_state(confs, dtype=torch.float32, device=device)
    blocks = sampling.blocks(NTS, state)
    burn = [next(blocks) for _ in range(burn_blocks)][-1]
    done = [next(blocks) for _ in range(timed_blocks)]
    launches = read_counts()
    steps_run = (burn_blocks + timed_blocks) * NTS
    require(launches["K1 log"] >= steps_run,
            f"{label}: K1 log launches {launches} cover {steps_run} steps")
    require_graphed(launches, steps_run, label, "VMC ")
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
    phase(label, check="VMC", card=card, chains=chains,
          est_every=sampling.est_every, steps_run=steps_run,
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
            "launches": launches, "steps_run": steps_run, "blocks": done,
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
    """Phase V2; returns :func:`run_vmc`'s record, the measured block
    included."""
    spec = mrbp.Spec(**VMC_SPEC)
    sampling = vmc.Sampling(
        spec, move_spread=0.25, rng_seed=7, num_walkers=VMC_CHAINS,
        est_every=8, ssf_est_spec=vmc.SSFEstSpec(num_modes=64),
        obd_est_spec=vmc.OBDEstSpec(num_pos=32, est_every_mult=8))
    conf = spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR)
    out = run_vmc(device, card, "V2", sampling, conf, 1)
    return out


def timed_exec(proc, proc_input, **kwargs):
    """``proc.exec(proc_input)`` between CUDA events: the result, the
    device-clock ms and the host's seconds of the whole call, and the
    launch counts, from 0."""
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    with warnings.catch_warnings():
        # Two blocks are too few for the ITC's deepest lags and for a
        # converged reblocking: both warn, neither matters here.
        warnings.simplefilter("ignore")
        result = proc.exec(proc_input, **kwargs)
    end.record()
    torch.cuda.synchronize()
    return (result, start.elapsed_time(end), time.perf_counter() - t0,
            read_counts())


def f64(tensor) -> np.ndarray:
    """The cast ``Proc.exec`` applies to a block's fetched tensors."""
    return np.asarray(tensor.cpu(), dtype=np.float64)


def require_equal(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    require(got.shape == want.shape and np.array_equal(got, want),
            f"{what}: bit-equal")


def run_proc_bench(device, card: str):
    """Phase R0: the bench configuration from nothing, through the
    execution layer.  Returns the launch counts and the steps run."""
    proc = dmc_exec.Proc.from_config(BENCH_PROC)
    reset_counts()
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device=device)
    build_launches = read_counts()
    result, _, _, launches = timed_exec(proc, proc_input)
    steps_run = (proc.burn_in_blocks + proc.num_blocks) * NTS
    state, blocks = result.state, result.data.blocks
    require(state.pos.device.type == "cuda"
            and state.pos.shape == (MAX_WALKERS, NOP)
            and state.pos.dtype == torch.float32
            and bool(torch.isfinite(state.pos).all()),
            "R0: final state on the card, finite, of the buffer's shape")
    require(result.data.series is None
            and blocks.energy.totals.shape == (proc.num_blocks,),
            "R0: one reduced energy total per block")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 2 blocks: no converged reblocking
        e_per_boson = float(blocks.energy.mean) / NOP
        e_err = float(blocks.energy.mean_error) / NOP
    lo, hi = ENERGY_BRACKET
    require(abs(e_per_boson - ENERGY_REF) < ENERGY_TOL
            and lo < e_per_boson < hi,
            f"R0: E/N {e_per_boson} within {ENERGY_TOL} of {ENERGY_REF}")
    require(launches["K1"] >= steps_run and launches["K2"] == steps_run
            and launches["K3"] == 0,
            f"R0 kernel launches {launches}: K1 on each of {steps_run} "
            f"steps, K2 once per step")
    mean_nw = float(blocks.num_walkers.totals.sum()) / (proc.num_blocks * NTS)
    phase("R0", check="bench configuration through Proc.exec", card=card,
          steps_run=steps_run, start_configurations=TARGET_WALKERS,
          build_state_launches=build_launches, mean_num_walkers=mean_nw,
          energy_per_boson=e_per_boson, energy_err_two_blocks=e_err,
          energy_dev=e_per_boson - ENERGY_REF, launches=launches, ok=True)
    return launches, steps_run


def proc_sum_rules(proc, data) -> dict:
    """PERF.md section 2's estimator sum rules read from a one-block
    ``SamplingData`` with its series: density N nw, S(0) N^2 nw, g2
    N(N-1)/2 nw, OBDM(0) nw at every measured step, and the ITC window
    sample's k = 0 column N^2 times its counts."""
    series = data.series
    nw = series.iter_props.num_walkers[0]
    every = proc.est_every
    rules = {
        "density": (series.density[0].sum(-1), NOP, every, SUM_RULE_RTOL),
        "ssf": (series.ssf[0][:, 0, 0], NOP ** 2, every, SUM_RULE_RTOL),
        "g2": (series.g2[0].sum(-1), NOP * (NOP - 1) / 2,
               every * proc.pair_corr_spec.est_every_mult, SUM_RULE_RTOL),
        "obd": (series.obd[0][:, 0], 1,
                every * proc.obd_spec.est_every_mult, OBDM_RTOL)}
    devs = {}
    for name, (got, per_walker, period, rtol) in rules.items():
        want = per_walker * nw[period - 1::period]
        require(got.shape == want.shape, f"R1 {name}: a row per measured step")
        devs[name] = float((np.abs(got - want) / want).max())
        require(devs[name] < rtol,
                f"R1 {name} sum rule within {rtol}: {devs[name]}")
    itc = data.blocks.itc
    counts = itc.lag_counts[0]
    filled = counts > 0
    want = NOP ** 2 * counts[filled]
    devs["itc_k0"] = float((np.abs(itc.lag_sums[0][filled, 0] - want)
                            / want).max())
    itc_rows = NTS // (every * proc.itc_spec.est_every_mult)
    require(devs["itc_k0"] < SUM_RULE_RTOL and int(filled.sum()) == itc_rows
            and not itc.lag_sums[0][~filled].any(),
            f"R1 ITC: k = 0 column N^2 counts over the {itc_rows} filled "
            f"lags, zero beyond: {devs['itc_k0']}")
    return devs


def run_proc_production(device, card: str, state, g3: dict,
                        block_offset: int):
    """Phase R1: the production example through ``Proc.exec``, one block
    from G3's start on G3's streams, held against G3's first block bit
    for bit.  Returns the launch counts and the steps run."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ITC's lags outrun one block
        proc = dmc_exec.Proc.from_config(PRODUCTION_PROC).evolve(dict(
            num_blocks=1, burn_in_blocks=0, block_offset=block_offset,
            keep_iter_data=True, num_walkers_control_factor=0.125,
            cm_diffusion_spec=dmc_exec.CMDiffusionEstSpec(window_blocks=1)))
    result, _, _, launches = timed_exec(proc, dmc_exec.ProcInput(state))
    want = g3["blocks"][0]
    series, blocks = result.data.series, result.data.blocks
    for name in want.iter_props._fields:
        require_equal(getattr(series.iter_props, name)[0],
                      f64(getattr(want.iter_props, name)), f"R1 {name}")
    for name, rows in (("density", want.iter_density),
                       ("ssf", want.iter_ssf), ("obd", want.iter_obd),
                       ("g2", want.iter_g2), ("cmd", want.iter_cmd)):
        require_equal(getattr(series, name)[0], f64(rows), f"R1 {name} rows")
    # Pure estimators: the window's sample is its last row, weighted by
    # the last step's walker count; the ITC's pair likewise.
    last_nw = f64(want.iter_props.num_walkers)[-1]
    for name, rows in (("density", want.iter_density),
                       ("one_body_dm", want.iter_obd),
                       ("pair_corr", want.iter_g2)):
        require_equal(getattr(blocks, name).totals[0], f64(rows)[-1],
                      f"R1 {name} window sample")
        require_equal(getattr(blocks, name).weight_totals[0], [last_nw],
                      f"R1 {name} window weight")
    require_equal(blocks.ss_factor.fdk_sqr_abs_part.totals[0],
                  f64(want.iter_ssf)[-1, :, 0], "R1 S(k) window sample")
    require_equal(blocks.itc.lag_sums[0], f64(want.iter_itc)[-1],
                  "R1 ITC window sums")
    require_equal(blocks.itc.lag_counts[0], f64(want.iter_itc_nw)[-1],
                  "R1 ITC window counts")
    nw_measured = f64(want.iter_props.num_walkers)[
        proc.est_every - 1::proc.est_every]
    require_equal(blocks.cm_diffusion.w2_series[0],
                  f64(want.iter_cmd)[:, 0] / nw_measured, "R1 CM <W^2>")
    require_equal(blocks.energy.totals,
                  [f64(want.iter_props.energy).sum()], "R1 energy total")
    require(int(result.state.itc_filled) == len(want.iter_itc),
            "R1: the ring buffer holds the block's ITC rows")
    devs = proc_sum_rules(proc, result.data)
    require(launches["K1"] >= NTS and launches["K2"] == NTS
            and launches["K4"] >= NTS // 8 + NTS // 64
            and launches["K3"] == 0,
            f"R1 kernel launches {launches}")
    e_per_boson = float(series.iter_props.energy.sum()
                        / series.iter_props.weight.sum()) / NOP
    phase("R1", check="production example through Proc.exec", card=card,
          steps_run=NTS, block_offset=block_offset,
          series_bit_equal_to_G3_block=0, energy_per_boson=e_per_boson,
          sum_rule_max_rel_dev=devs, launches=launches, ok=True)
    return launches, NTS


def run_proc_vmc_example(device, card: str, v2: dict):
    """Phase R2: the variational example through ``vmc.Proc.exec`` from
    its regular start, held against V2's block bit for bit.  Returns the
    launch counts, the steps run and E/N."""
    proc = vmc_exec.Proc.from_config(VARIATIONAL_PROC).evolve(dict(
        num_blocks=1, burn_in_blocks=1, keep_iter_data=True))
    proc_input = vmc_exec.ProcInput.from_model_sys_conf_spec(
        vmc_exec.ModelSysConfSpec(dist_type="REGULAR"), proc, device=device)
    result, _, _, launches = timed_exec(proc, proc_input)
    steps_run = 2 * NTS
    (want,) = v2["blocks"]
    series = result.data.series
    wf_log, energy, moves = vmc_exec._walker_means(*want.iter_props)
    require_equal(series.iter_props.energy[0], f64(energy), "R2 energy")
    require_equal(series.iter_props.wf_abs_log[0], f64(wf_log),
                  "R2 log|psi|")
    require_equal(series.iter_props.move_stat[0], f64(moves),
                  "R2 acceptance per step")
    require_equal(series.ssf[0], f64(want.iter_ssf) / VMC_CHAINS,
                  "R2 S(k) rows")
    require_equal(series.obd[0], f64(want.iter_obd) / VMC_CHAINS,
                  "R2 OBDM rows")
    require(torch.equal(result.state.pos, want.last_state.pos),
            "R2 final positions equal to V2's")
    accept = float(series.iter_props.move_stat[0].mean())
    require(abs(accept - v2["accept_rate"]) < 1e-6,
            f"R2 acceptance {accept} is V2's {v2['accept_rate']}")
    require(launches["K1 log"] >= steps_run and launches["K3"] == 0,
            f"R2 kernel launches {launches}")
    require_graphed(launches, steps_run, "R2", "VMC ")
    e_per_n = float(result.data.blocks.energy.totals.mean()) / VMC_NOP
    phase("R2", check="variational example through vmc.Proc.exec", card=card,
          steps_run=steps_run, chains=VMC_CHAINS,
          series_bit_equal_to_V2_block=0, energy_per_boson=e_per_n,
          accept_rate=accept, launches=launches, ok=True)
    return launches, steps_run, e_per_n


def check_proc_resume(device, card: str) -> None:
    """Phase R3: a run cut after block 1 by the in-memory checkpoint and
    resumed from it equals the uninterrupted run bit for bit."""
    steps = R3_DEPTH["num_time_steps_block"]
    proc = dmc_exec.Proc.from_config(dict(
        BENCH_PROC, **R3_DEPTH, checkpoint_every=1,
        density_spec=dict(num_bins=128, as_pure_est=True,
                          pfw_num_time_steps=2 * steps)))
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device=device)
    kept = []

    def hook(resume_input):
        if resume_input.resume["blocks_completed"] == 1:
            kept.append(resume_input)

    whole, _, _, _ = timed_exec(proc, proc_input, checkpoint_hook=hook)
    (cut,) = kept
    require(cut.state.pos.device.type == "cuda"
            and cut.resume["aux"]["aux_density"].device.type == "cuda"
            and cut.resume["it_next"] == 2,
            "R3: the checkpoint after block 1 holds the state and the "
            "window's accumulators on the card")
    resumed, _, _, _ = timed_exec(proc, cut)
    for name in ("pos", "energies", "weights", "num_walkers", "ref_energy"):
        require(torch.equal(getattr(resumed.state, name),
                            getattr(whole.state, name)),
                f"R3 final {name} equal to the uninterrupted run's")
    a, b = resumed.data.blocks, whole.data.blocks
    for name in ("energy", "weight", "num_walkers", "density"):
        require_equal(getattr(a, name).totals, getattr(b, name).totals,
                      f"R3 {name} totals")
    require(b.density.totals.shape == (2, 128)
            and abs(float(b.density.totals[0].sum()
                          / b.density.weight_totals[0, 0]) - NOP)
            < NOP * SUM_RULE_RTOL,
            "R3: one density sample per two-block window, summing to N")
    phase("R3", check="resume from the in-memory checkpoint", card=card,
          blocks=R3_DEPTH["num_blocks"], steps_per_block=steps,
          cut_after_block=1, window_blocks=2, bit_equal=True, ok=True)



# -- phase W: the wavefunction optimization ----------------------------------

def vjp_inputs(spec_kwargs, num_walkers, dtype, device, seed=0):
    """K1 log's VJP inputs: positions in [0, L), the packed parameters,
    the forward's drift and seeded normal upstream gradients of log|psi|
    and of the energy; and the kernels' keywords."""
    pos, params, kw = pair_inputs(spec_kwargs, num_walkers, dtype, device,
                                  seed)
    rng = np.random.default_rng(seed + 1)
    g_lp, g_e = (torch.as_tensor(rng.standard_normal(num_walkers),
                                 dtype=dtype, device=device)
                 for _ in range(2))
    _, _, drift = pairwise.energy_and_drift(pos, params, with_log_psi=True,
                                            **kw)
    return (pos, params, drift, g_lp, g_e), kw


def vjp_plain_f64(args, kw, chunk: int = 1024) -> torch.Tensor:
    """The f64 plain VJP at ``args`` (cast up), summed over chunks of
    walkers (the product is a sum over walkers)."""
    pos, params, _, g_lp, g_e = (None if a is None else a.double()
                                 for a in args)
    return sum(pairwise.energy_and_drift_params_vjp_plain(
        pos[k:k + chunk], params, None, g_lp[k:k + chunk],
        g_e[k:k + chunk], **kw) for k in range(0, pos.shape[0], chunk))


def pair_flops(pos, params, flops_per_pair) -> dict:
    """The flops of every unordered pair of each walker of ``pos`` in
    [0, L), ``flops_per_pair`` (inside the cutoff, outside) by its side
    of the cutoff in these positions."""
    walkers, nop = pos.shape
    length = float(params[pairwise.P_L])
    rm = float(params[pairwise.P_RM])
    in_cut = 0
    for chunk in pos.split(1024):
        d = (chunk[:, :, None] - chunk[:, None, :]).abs()
        # The pairs i < j only.
        in_cut += int((torch.minimum(d, length - d) < rm).triu(1).sum())
    pairs = walkers * nop * (nop - 1) // 2
    return dict(flops=(in_cut * flops_per_pair[0]
                       + (pairs - in_cut) * flops_per_pair[1]),
                pairs_in_cutoff=in_cut, pairs=pairs)


def vjp_bound(pos, params, flops_per_pair=(K1_VJP_FLOPS_IN_CUT,
                                            K1_VJP_FLOPS_OUTSIDE)) -> dict:
    """The VJP kernel's bound at ``pos``: its pairs' flops
    (``pair_flops``); positions, drift, the two upstream vectors and the
    parameters in, the 16 sums out."""
    walkers, nop = pos.shape
    counted = pair_flops(pos, params, flops_per_pair)
    values = 2 * walkers * nop + 2 * walkers + 2 * pairwise.PARAMS_SIZE
    return dict(bound(counted.pop("flops"), F32_BYTES * values), **counted)


def check_k1_vjp(device, card: str):
    """Phase W0: the VJP kernel against its plain version (autograd of
    ``energy_and_drift_plain``): f64 at 256 walkers on the bench, free,
    ideal and defected models at N = 5, 64, 128, every slot; f32 at
    4096 x 128 against the f64 plain version; then its time beside K1
    log's at 4096 x 128 and 16384 x 64.  Returns the f32 error and the
    times."""
    for nop in (5, 64, 128):
        base = dict(BENCH_SPEC, boson_number=nop, supercell_size=float(nop))
        for kind, spec_kwargs in (
                ("bench", base), ("free", dict(base, lattice_depth=0.0)),
                ("ideal", dict(base, interaction_strength=0.0)),
                ("defected", dict(base, num_defects=1 if nop == 5 else 8,
                                  defect_magnitude=10.0))):
            args, kw = vjp_inputs(spec_kwargs, 256, torch.float64, device)
            count = pairwise.energy_and_drift.params_vjp_launch_count
            got = pairwise.energy_and_drift_params_vjp(*args, **kw)
            torch.cuda.synchronize()
            require(pairwise.energy_and_drift.params_vjp_launch_count
                    == count + 1, f"K1 vjp {kind} N={nop} launched")
            want = pairwise.energy_and_drift_params_vjp_plain(*args, **kw)
            torch.testing.assert_close(got, want, rtol=K1_VJP_F64_RTOL,
                                       atol=0.0)
            rel = ((got - want).abs() / want.abs().clamp_min(1e-300)).max()
            phase("W0", check=f"K1 vjp f64 {kind} N={nop}", walkers=256,
                  max_rel_err=float(rel), rtol=K1_VJP_F64_RTOL,
                  nonzero_slots=int((want != 0).sum()), ok=True)
    args, kw = vjp_inputs(BENCH_SPEC, 4096, torch.float32, device)
    got = pairwise.energy_and_drift_params_vjp(*args, **kw).double()
    oracle = vjp_plain_f64(args, kw)
    plain = pairwise.energy_and_drift_params_vjp_plain(*args, **kw).double()
    tol = K1_VJP_F32_TOL
    limit = tol["rtol"] * oracle.abs() + tol["rtol_of_max"] * oracle.abs().max()
    err, plain_err = (got - oracle).abs(), (plain - oracle).abs()
    require(bool((err <= limit).all()),
            f"K1 vjp f32 at 4096 x 128 within {tol} of the f64 plain "
            f"version: {(err / limit).max()} of the limit")
    phase("W0", check="K1 vjp f32 vs the f64 plain version",
          shape=list(args[0].shape), tolerance=tol,
          max_share_of_limit=float((err / limit).max()),
          max_abs_err=float(err.max()),
          plain_f32_max_share_of_limit=float((plain_err / limit).max()),
          largest_slot=float(oracle.abs().max()), ok=True)
    del plain, oracle
    times = {}
    for label, spec_kwargs, walkers in (("dmc shape", BENCH_SPEC, 4096),
                                        ("vmc shape", VMC_SPEC, VMC_CHAINS)):
        args, kw = vjp_inputs(spec_kwargs, walkers, torch.float32, device)
        least = vjp_bound(args[0], args[1])

        def plain():
            return pairwise.energy_and_drift_params_vjp_plain(*args, **kw)

        def kernel():
            return pairwise.energy_and_drift_params_vjp(*args, **kw)

        def forward():
            return pairwise.energy_and_drift(args[0], args[1],
                                             with_log_psi=True, **kw)

        p1, k1, f1 = cuda_ms(plain, 3), cuda_ms(kernel, 50), cuda_ms(forward,
                                                                     50)
        f2, k2, p2 = cuda_ms(forward, 50), cuda_ms(kernel, 50), cuda_ms(plain,
                                                                       3)
        # The f64 kernel at the same shape (the f64 plain version is W0's
        # oracle above, not timed).
        args64 = tuple(a.double() for a in args)
        d1, d2 = (cuda_ms(lambda: pairwise.energy_and_drift_params_vjp(
            *args64, **kw), 10) for _ in range(2))
        del args64
        first = vjp_bound(args[0], args[1],
                          K1_VJP_FIRST_DESIGN_FLOPS)["bound_ms"]
        times[label] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                        "forward_ms": (f1 + f2) / 2, "f64_ms": (d1 + d2) / 2,
                        **least}
        phase("W0", kernel="K1 vjp", card=card, shape=list(args[0].shape),
              plain_ms=[p1, p2], kernel_ms=[k1, k2], f64_kernel_ms=[d1, d2],
              k1_log_forward_ms=[f1, f2],
              bound_share=least["bound_ms"] / times[label]["ms"],
              bound_ms_first_design_count=first,
              bound_share_first_design_count=first / times[label]["ms"],
              k1_log_forward_bound_ms=k1_bound(
                  *args[0].shape, True)["bound_ms"], **least, ok=True)
    return float(err.max()), times


class watch_optimizer:
    """Context manager over the W phases' optimizations: for every
    ``GradCSWFOptimizer.exec``, the K1 log and VJP launches inside it and
    its backward calls (``_value_and_grad_fn``, one per L-BFGS-B
    evaluation); and the calls of the plain pair functions on a CUDA
    tensor (there must be none).  The originals are back on exit."""

    def __init__(self):
        self.execs, self.backward_calls, self.plain_on_card = [], 0, 0

    def __enter__(self):
        cls = wf_opt.GradCSWFOptimizer
        self._saved = [(cls, "exec", cls.exec),
                       (cls, "_value_and_grad_fn", cls._value_and_grad_fn)]
        self._saved += [(pairwise, name, getattr(pairwise, name))
                        for name in ("energy_and_drift_plain",
                                     "energy_and_drift_params_vjp_plain")]
        watch = self
        exec_, value_and_grad = cls.exec, cls._value_and_grad_fn

        def counted_exec(opt):
            before = read_counts()
            calls = watch.backward_calls
            out = exec_(opt)
            after = read_counts()
            grid = opt.num_grid * (16 if opt.opt_obf_lattice_depth else 1)
            watch.execs.append(dict(
                grid_points=grid, backward_calls=watch.backward_calls - calls,
                k1_log=after["K1 log"] - before["K1 log"],
                k1_vjp=after["K1 vjp"] - before["K1 vjp"], optimizer=opt))
            return out

        def counted_value_and_grad(opt, x):
            watch.backward_calls += 1
            return value_and_grad(opt, x)

        def refuse_card(fn):
            def wrapped(pos, *args, **kwargs):
                if pos.device.type != "cpu":
                    watch.plain_on_card += 1
                return fn(pos, *args, **kwargs)
            return wrapped

        cls.exec, cls._value_and_grad_fn = counted_exec, \
            counted_value_and_grad
        for _, name, fn in self._saved[2:]:
            setattr(pairwise, name, refuse_card(fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False

    def check(self, label: str) -> list:
        """Each gradient optimization launched K1 log once per grid point
        and per evaluation and the VJP kernel once per backward; no plain
        pair function ran on the card.  Returns the per-exec counts."""
        rows = [{k: v for k, v in e.items() if k != "optimizer"}
                for e in self.execs]
        for e in rows:
            require(e["backward_calls"] > 0
                    and e["k1_vjp"] == e["backward_calls"]
                    and e["k1_log"] == e["grid_points"] + e["backward_calls"],
                    f"{label}: K1 log once per grid point and evaluation, "
                    f"the VJP once per backward: {e}")
        require(self.plain_on_card == 0,
                f"{label}: {self.plain_on_card} plain pair calls on the card")
        return rows


def run_wf_opt_pipeline(device, card: str) -> dict:
    """Phase W1: the shipped pipeline ``examples/wf_opt_pipeline.yml``
    from its config dicts: ``WFOptAppSpec.exec`` (VMC, then the joint
    gradient optimization), then the DMC ``Proc.exec`` at the optimum, in
    memory.  Returns each stage's launch counts and steps."""
    stanza = cli_app.WFOptAppSpec.from_config(WF_OPT_STANZA)
    vmc_proc = stanza.vmc_proc
    reset_counts()
    with watch_optimizer() as watch:
        t0 = time.perf_counter()
        opt_spec = stanza.exec(device=device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = read_counts()
    counts = watch.check("W1")
    (record,) = watch.execs
    opt = record["optimizer"]
    spec = vmc_proc.model_spec
    x_star = [opt_spec.tbf_contact_cutoff, opt_spec.obf_lattice_depth]
    bounds = opt.principal_function_bounds
    require(all(lo <= x <= hi for x, (lo, hi) in zip(x_star, bounds))
            and opt.sys_conf_set.shape == (stanza.num_sys_confs,
                                           spec.boson_number)
            and opt.sys_conf_set.device.type == "cuda",
            f"W1: rm* and v0* {x_star} inside {bounds}, optimized over the "
            f"card's {stanza.num_sys_confs} configurations")
    var_start = opt.principal_function([spec.tbf_contact_cutoff,
                                        spec.lattice_depth])
    var_opt = opt.principal_function(x_star)
    require(var_opt <= var_start,
            f"W1: variance at the optimum {var_opt} <= at the start "
            f"{var_start}")
    vmc_steps = (vmc_proc.burn_in_blocks + vmc_proc.num_blocks) \
        * vmc_proc.num_steps_block
    require(launches["K1 log"] - record["k1_log"] >= vmc_steps,
            f"W1: K1 log on each of the {vmc_steps} VMC steps: {launches}")
    require_graphed(launches, vmc_steps, "W1's VMC stage", "VMC ")

    proc = dmc_exec.Proc.from_config(WF_OPT_DMC_PROC)
    proc = dataclasses.replace(proc, model_spec=proc.model_spec.evolve(
        tbf_contact_cutoff=opt_spec.tbf_contact_cutoff,
        obf_lattice_depth=opt_spec.obf_lattice_depth))
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device=device)
    result, exec_ms, dmc_wall_s, dmc_launches = timed_exec(proc, proc_input)
    dmc_steps = (proc.burn_in_blocks + proc.num_blocks) \
        * proc.num_time_steps_block
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        e_per_n = float(result.data.blocks.energy.mean) / spec.boson_number
        e_err = float(result.data.blocks.energy.mean_error) \
            / spec.boson_number
    require(np.isfinite(e_per_n) and result.state.pos.device.type == "cuda",
            f"W1: DMC E/N {e_per_n} finite, on the card")
    require(dmc_launches["K1"] >= dmc_steps
            and dmc_launches["K2"] == dmc_steps and dmc_launches["K4"] > 0,
            f"W1 DMC launches {dmc_launches} over {dmc_steps} steps")
    phase("W1", check="the shipped pipeline: VMC, joint grad, DMC at the "
          "optimum", card=card, vmc_steps=vmc_steps, chains=vmc_proc.num_walkers,
          wf_opt_wall_s=wall_s, rm_start=spec.tbf_contact_cutoff,
          v0_start=spec.lattice_depth, rm_star=x_star[0], v0_star=x_star[1],
          bounds=bounds, variance_start=var_start, variance_star=var_opt,
          optimizer_counts=counts, launches=launches, dmc_steps=dmc_steps,
          dmc_wall_s=dmc_wall_s, dmc_step_ms_cuda_events=exec_ms / dmc_steps,
          dmc_energy_per_boson=e_per_n, dmc_energy_err=e_err,
          dmc_launches=dmc_launches, ok=True)
    return {"W1": (launches, vmc_steps), "W1 dmc": (dmc_launches, dmc_steps)}


def run_wf_opt_ab(device, card: str):
    """Phase W2: ``benchmarks/wf_opt_compare.py --joint --equil-steps
    1024`` in the port, f32 on the card: VMC from a crystal start, then
    DE (its evaluations counted), the gradient optimizer and the joint one
    on the same configurations, each timed; then fresh VMC at the initial,
    the rm-only and the joint trial.  Returns the launch counts, the VMC
    steps and the optimizations' counts."""
    ab = WF_OPT_AB
    spec = mrbp.Spec(**dict(BENCH_SPEC, tbf_contact_cutoff=ab["rm0"]))
    chains, nts = ab["chains"], ab["equil_steps"]
    rng = np.random.default_rng(ab["start_seed"])
    confs0 = np.stack([
        spec.init_get_sys_conf(dist_type=mrbp.DIST_REGULAR,
                               offset=rng.uniform(0, NOP))
        for _ in range(chains)]).astype(np.float32)

    def vmc_blocks(trial, seed, count):
        sampling = vmc.Sampling(trial, move_spread=ab["move_spread"],
                                rng_seed=seed, num_walkers=chains)
        blocks = sampling.blocks(nts, sampling.build_state(
            confs0, dtype=torch.float32, device=device))
        return [next(blocks) for _ in range(count)]

    reset_counts()
    t0 = time.perf_counter()
    block = vmc_blocks(spec, ab["sampling_seed"], 2)[-1]
    equil_s = time.perf_counter() - t0
    pos_set, lp_set = block.last_state.pos, block.last_state.wf_abs_log
    equil_e = float(block.iter_props.energy[-64:].double().mean()) / NOP

    out = {}
    with watch_optimizer() as watch:
        de = wf_opt.CSWFOptimizer(spec, pos_set, lp_set, device=device)
        evals = [0]
        evaluate = de.principal_function

        def counted(x):
            evals[0] += 1
            return evaluate(x)

        object.__setattr__(de, "principal_function", counted)
        de.principal_function(ab["rm0"])  # warm-up, as the benchmark
        evals[0] = 0
        t0 = time.perf_counter()
        rm_de = de.exec().tbf_contact_cutoff
        out["de"] = dict(rm=rm_de, wall_s=time.perf_counter() - t0,
                         evaluations=evals[0])
        for name, joint in (("grad", False), ("joint", True)):
            opt = wf_opt.GradCSWFOptimizer(spec, pos_set, lp_set,
                                           opt_obf_lattice_depth=joint,
                                           device=device)
            t0 = time.perf_counter()
            got = opt.exec()
            out[name] = dict(rm=got.tbf_contact_cutoff,
                             wall_s=time.perf_counter() - t0, spec=got,
                             optimizer=opt)
    counts = watch.check("W2")
    grad, joint = out["grad"], out["joint"]
    v0_joint = joint["spec"].obf_lattice_depth
    var_de = grad["optimizer"].principal_function(rm_de)
    var_grad = grad["optimizer"].principal_function(grad["rm"])
    var_joint = joint["optimizer"].principal_function([joint["rm"], v0_joint])
    require(abs(rm_de - grad["rm"]) <= WF_OPT_RM_TOL,
            f"W2: DE rm* {rm_de} and grad rm* {grad['rm']} within "
            f"{WF_OPT_RM_TOL}")
    require(var_joint <= var_grad,
            f"W2: joint variance {var_joint} <= rm-only {var_grad}")

    fresh = {}
    for name, trial in (("initial", spec),
                        ("rm_only", spec.evolve(tbf_contact_cutoff=grad["rm"])),
                        ("joint", joint["spec"])):
        measured = vmc_blocks(trial, ab["fresh_seed"], 3)[-1]
        chain_means = (measured.iter_props.energy.double() / NOP).mean(dim=0)
        fresh[name] = dict(
            e_per_n=float(chain_means.mean()),
            err=float(chain_means.std(unbiased=False)) / math.sqrt(chains),
            accept=float(measured.accept_rate))
    torch.cuda.synchronize()
    launches = read_counts()
    gap = fresh["initial"]["e_per_n"] - fresh["rm_only"]["e_per_n"]
    sigma = math.hypot(fresh["initial"]["err"], fresh["rm_only"]["err"])
    require(gap > WF_OPT_SIGMAS * sigma,
            f"W2: fresh-VMC E/N at the rm-only trial below the initial "
            f"trial's by {gap}, more than {WF_OPT_SIGMAS} x {sigma}")
    vmc_steps = (2 + 3 * len(fresh)) * nts
    require(launches["K1 log"] >= vmc_steps,
            f"W2: K1 log on each of the {vmc_steps} VMC steps: {launches}")
    jax = WF_OPT_AB_JAX
    phase("W2", check="DE vs grad vs joint at production scale", card=card,
          chains=chains, nop=NOP, equil_s=equil_s, equil_energy_per_boson=equil_e,
          equil_accept=float(block.accept_rate),
          de=out["de"], grad={k: grad[k] for k in ("rm", "wall_s")},
          joint=dict(rm=joint["rm"], v0=v0_joint, wall_s=joint["wall_s"]),
          optimizer_counts=counts, variance_de=var_de,
          variance_rm_only=var_grad, variance_joint=var_joint,
          variance_ratio=var_joint / var_grad,
          jax_variance_ratio=jax["variance_joint"] / jax["variance_rm_only"],
          jax_rm=dict(de=jax["rm_de"], grad=jax["rm_grad"]),
          fresh_vmc=fresh, rm_only_gain_sigmas=gap / sigma,
          joint_vs_rm_only_gain=(fresh["rm_only"]["e_per_n"]
                                 - fresh["joint"]["e_per_n"]),
          jax_fresh_vmc=dict(initial=jax["e_initial"],
                             rm_only=jax["e_rm_only"]),
          launches=launches, vmc_steps=vmc_steps, ok=True)
    return (launches, vmc_steps), counts


def diffuse_inputs(device, spec_kwargs=BENCH_SPEC, dtype=torch.float32):
    """K3's inputs at MAX_WALKERS walkers of the model ``spec_kwargs``
    (the DMC shape by default): cloned parents with their K1 energy and
    drift, E_ref on the device; and the DMC step's own diffusion of the
    same inputs, ``step(xi=None)``: K2's noise for the same key (or the
    unit normals ``xi``) scaled by sigma, then ``dmc.Sampling.diffuse``
    (torch move and recast, K1, weight)."""
    pos, params, kw = pair_inputs(spec_kwargs, MAX_WALKERS, dtype, device,
                                  seed=7)
    energy, drift = pairwise.energy_and_drift(pos, params, **kw)
    sampling = bench_sampling(spec_kwargs)
    # What the sampler makes once per run: the cast and packed parameters.
    cfc = mrbp.cast_params(sampling.cfc_params, dtype, device)
    step_params = pairwise.pack_params(cfc, dtype, device)
    args = dict(cpos=pos, cdrift=drift, cenergy=energy, params=params,
                dt=sampling.time_step, sigma=sampling.sigma_spread,
                e_ref=torch.tensor(ENERGY_REF * kw["nop"], dtype=dtype,
                                   device=device),
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


# -- phase S: fused parameter sweeps -------------------------------------------

def sweep_rows_specs(nop: int = EOS_NOP):
    """S0's four rows: couplings, cutoffs and supercells that differ."""
    return [mrbp.Spec(**dict(BENCH_SPEC, interaction_strength=gn,
                             tbf_contact_cutoff=rm, boson_number=nop,
                             supercell_size=sc))
            for gn, rm, sc in S0_ROWS]


def table_inputs(dtype, device, per_row, nop=EOS_NOP):
    """Positions of four rows of ``per_row`` walkers and their (4, 16)
    parameter table."""
    specs = sweep_rows_specs(nop)
    rng = np.random.default_rng(8)
    pos = np.concatenate([rng.uniform(0, s.supercell_size, (per_row, nop))
                          for s in specs])
    static = specs[0].static_spec
    kw = dict(nop=nop, is_free=static.is_free, is_ideal=static.is_ideal,
              defects_sep=static.defects_sep)
    table = torch.stack([pairwise.pack_params(s.cfc_params, dtype, device)
                         for s in specs])
    return torch.as_tensor(pos, dtype=dtype, device=device), table, kw


def time_pair(kernel, plain, single, reps=50):
    """In turns: plain, table, single-row, single-row, table, plain."""
    p1 = cuda_ms(plain, 3)
    t1, s1 = cuda_ms(kernel, reps), cuda_ms(single, reps)
    s2, t2 = cuda_ms(single, reps), cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, 3)
    return {"ms": (t1 + t2) / 2, "plain_ms": (p1 + p2) / 2,
            "single_row_ms": (s1 + s2) / 2}


def check_sweep_kernels(device, card: str) -> dict:
    """Phase S0: the row variants of K1 (forward and log), K2, K4 and
    the OBDM grid (:func:`check_obd_rows`) against their plain versions
    and against one launch per row, and timed beside their single-row
    forms at the same total width."""
    rows, per_row = len(S0_ROWS), EOS_SLOTS
    out = {}
    for log_psi in (False, True):
        name = "K1 log table" if log_psi else "K1 table"
        err = 0.0
        for dtype, walkers in ((torch.float32, per_row), (torch.float64, 64)):
            pos, table, kw = table_inputs(dtype, device, walkers)
            kw["with_log_psi"] = log_psi
            got = pairwise.energy_and_drift(pos, table, **kw)
            plain = pairwise.energy_and_drift_plain(pos, table, **kw)
            for r in range(rows):
                part = slice(r * walkers, (r + 1) * walkers)
                one = pairwise.energy_and_drift(pos[part].contiguous(),
                                                table[r].contiguous(), **kw)
                for g, w in zip(got, one):
                    require(torch.equal(g[part], w),
                            f"S0 {name} {dtype} row {r} bit-equal to its "
                            f"single-row launch")
            torch.cuda.synchronize()
            if dtype == torch.float64:
                for g, p in zip(got, plain):
                    rel = float((g - p).abs().max() / p.abs().max())
                    require(rel <= S0_K1_F64_RTOL, f"S0 {name} f64 within "
                            f"{S0_K1_F64_RTOL} of plain (normwise): {rel}")
            else:
                tol = K1_LOG_F32_TOL if log_psi else K1_F32_TOL
                if log_psi:
                    torch.testing.assert_close(
                        got[0], plain[0], rtol=tol["log_psi_rtol"],
                        atol=tol["log_psi_atol"])
                torch.testing.assert_close(got[-2], plain[-2],
                                           rtol=tol["energy_rtol"], atol=0.0)
                torch.testing.assert_close(got[-1], plain[-1],
                                           rtol=tol["drift_rtol"],
                                           atol=tol["drift_atol"])
                err = max(float((g - p).abs().max())
                          for g, p in zip(got, plain))
                single = pos.clone()
                times = time_pair(
                    lambda: pairwise.energy_and_drift(pos, table, **kw),
                    lambda: pairwise.energy_and_drift_plain(pos, table, **kw),
                    lambda: pairwise.energy_and_drift(single, table[0]
                                                      .contiguous(), **kw))
        out[name] = {**times, "max_abs_err": err,
                     **k1_bound(rows * per_row, EOS_NOP, log_psi)}
        phase("S0", check=f"{name} vs plain and single-row launches",
              card=card, shape=[rows, per_row, EOS_NOP], f64_rtol=
              S0_K1_F64_RTOL, **out[name], ok=True)

    # K2: four keys and scales, one launch; word for word the single-row
    # launches and the plain version, also at a row length that is not a
    # multiple of 4.
    keys = [int(proc["rng_seed"]) for proc in EOS_PROCS]
    scales = [math.sqrt(2 * dt) for dt in (1e-3, 2e-3, 1e-3, 5e-4)]
    err = 0.0
    for shape in ((per_row, EOS_NOP), (33, 7)):
        for dtype in (torch.float32, torch.float64):
            sc = torch.tensor(scales, dtype=dtype, device=device)
            buf = torch.empty((rows,) + shape, dtype=dtype, device=device)
            got = prng.normal_rows(prng.key_table(keys, device), 77, sc, buf)
            plain = prng.normal_rows_plain(
                prng.key_table(keys, "cpu"), 77, sc.cpu(),
                torch.empty(buf.shape, dtype=dtype))
            for r in range(rows):
                one = prng.normal(keys[r], 77, shape, dtype, device,
                                  scale=float(sc[r]))
                require(torch.equal(got[r], one), f"S0 K2 rows {shape} "
                        f"{dtype} row {r} word-equal to its launch")
            torch.testing.assert_close(got.cpu(), plain, **K2_TOL)
            err = max(err, float((got.cpu() - plain).abs().max()))
    keys_t = prng.key_table(keys, device)
    sc = torch.tensor(scales, device=device)
    buf = torch.empty((rows, per_row, EOS_NOP), device=device)
    flat = torch.empty((rows * per_row, EOS_NOP), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    numel = buf.numel()
    p1 = cuda_ms(lambda: prng.normal_rows_plain(
        keys_t.cpu(), 5, sc.cpu(), torch.empty(buf.shape)), 2)
    k1, s1 = (cuda_ms(lambda: prng.normal_rows(keys_t, 5, sc, buf), 500),
              cuda_ms(lambda: prng.normal(1, 5, flat.shape, scale=0.04,
                                          out=flat, device=device), 500))
    l1 = cuda_ms(lambda: torch.randn(flat.shape, generator=gen, out=flat),
                 500)
    l2 = cuda_ms(lambda: torch.randn(flat.shape, generator=gen, out=flat),
                 500)
    s2, k2 = (cuda_ms(lambda: prng.normal(1, 5, flat.shape, scale=0.04,
                                          out=flat, device=device), 500),
              cuda_ms(lambda: prng.normal_rows(keys_t, 5, sc, buf), 500))
    p2 = cuda_ms(lambda: prng.normal_rows_plain(
        keys_t.cpu(), 5, sc.cpu(), torch.empty(buf.shape)), 2)
    out["K2 rows"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                      "single_row_ms": (s1 + s2) / 2,
                      "library_ms": (l1 + l2) / 2,
                      "library_device_ms": device_ms(
                          lambda: torch.randn(flat.shape, generator=gen,
                                              out=flat), 200),
                      "device_ms": device_ms(
                          lambda: prng.normal_rows(keys_t, 5, sc, buf), 200),
                      "single_row_device_ms": device_ms(
                          lambda: prng.normal(1, 5, flat.shape, scale=0.04,
                                              out=flat, device=device), 200),
                      "max_abs_err": err,
                      **bound(numel * K2_FLOPS_PER_NORMAL,
                              F32_BYTES * numel + 12 * rows)}
    phase("S0", check="K2 rows vs plain and single-row launches", card=card,
          shape=list(buf.shape), **out["K2 rows"],
          library_call="torch.randn, another stream", ok=True)

    # K4: four bin widths (the rows' supercells), one launch, at the
    # density and the g2 shapes; bit-equal to the plain version and to
    # one launch per row.
    sizes = [spec.supercell_size for spec in sweep_rows_specs()]
    rng = np.random.default_rng(9)
    cases = {}
    for label, dtype in (("density f32", torch.float32),
                         ("density f64", torch.float64),
                         ("g2 f32", torch.float32)):
        if label.startswith("g2"):
            pos = torch.as_tensor(rng.uniform(0, max(sizes) / 2,
                                              (rows, 1088, EOS_NOP, EOS_NOP)),
                                  dtype=dtype, device=device)
            widths = torch.tensor([0.5 * s / 128 for s in sizes],
                                  dtype=dtype, device=device)
        else:
            pos = torch.as_tensor(rng.uniform(0, max(sizes),
                                              (rows, per_row, EOS_NOP)),
                                  dtype=dtype, device=device)
            widths = torch.tensor([s / 128 for s in sizes], dtype=dtype,
                                  device=device)
        table = widths.view((rows,) + (1,) * (pos.dim() - 1)).contiguous()
        got = histogram.walker_histogram(pos, table, 128)
        for r in range(rows):
            require(torch.equal(got[r], histogram.walker_histogram(
                pos[r], widths[r], 128)),
                f"S0 K4 {label} row {r} bit-equal to its launch")
        require(torch.equal(got, histogram.walker_histogram_plain(
            pos, table, 128)), f"S0 K4 {label} bit-equal to plain")
        cases[label] = (pos, table, widths)
    pos, table, widths = cases["density f32"]
    flat_pos = pos.reshape(-1, EOS_NOP).clone()
    times = time_pair(
        lambda: histogram.walker_histogram(pos, table, 128),
        lambda: histogram.walker_histogram_plain(pos, table, 128),
        lambda: histogram.walker_histogram(flat_pos, widths[0], 128), 500)
    out["K4 groups"] = {**times, "max_abs_err": 0.0,
                        "device_ms": device_ms(
                            lambda: histogram.walker_histogram(pos, table,
                                                               128), 200),
                        "single_row_device_ms": device_ms(
                            lambda: histogram.walker_histogram(
                                flat_pos, widths[0], 128), 200),
                        **k4_bound(rows * per_row, EOS_NOP, 128)}
    gpos, gtable, gwidths = cases["g2 f32"]
    gflat = gpos.reshape(-1, EOS_NOP).clone()
    g2 = time_pair(
        lambda: histogram.walker_histogram(gpos, gtable, 128),
        lambda: histogram.walker_histogram_plain(gpos, gtable, 128),
        lambda: histogram.walker_histogram(gflat, gwidths[0], 128), 20)
    out["K4 groups"].update(
        g2_ms=g2["ms"], g2_plain_ms=g2["plain_ms"],
        g2_single_row_ms=g2["single_row_ms"],
        g2_bound_ms=k4_bound(gflat.shape[0], EOS_NOP, 128)["bound_ms"])
    phase("S0", check="K4 groups vs plain and single-group launches",
          card=card, shape=list(pos.shape), g2_shape=list(gpos.shape),
          **out["K4 groups"], ok=True)
    out["OBDM table"] = check_obd_rows(device, card)
    return out


def check_obd_rows(device, card: str) -> dict:
    """Phase S0's OBDM grid: four parameter rows and each row's own grid
    over [0, L/2] in one launch, each row bit-equal to its launch alone;
    f64 within 1e-12 of the plain version, f32 within 4 times the plain
    f32 version's gap from the f64 one; timed beside the single-row
    launch at the same total width."""
    rows, per_row = len(S0_ROWS), EOS_SLOTS
    specs = sweep_rows_specs()
    funcs = mrbp.core_funcs(specs[0])
    grids = np.stack([np.linspace(0.0, 0.5 * spec.supercell_size,
                                  OBD_NUM_POS) for spec in specs], axis=1)
    for dtype, walkers in ((torch.float64, 64), (torch.float32, per_row)):
        pos, table, _ = table_inputs(dtype, device, walkers)
        pos = pos.view(rows, walkers, EOS_NOP)
        szs = torch.as_tensor(grids, dtype=dtype,
                              device=device)[..., None, None]
        cfc = dmc._rows_cfc(specs, dtype, device)
        alone = [mrbp.cast_params(spec.cfc_params, dtype, device)
                 for spec in specs]
        got = funcs.one_body_density_grid(szs, pos, cfc, table)
        for r in range(rows):
            one = funcs.one_body_density_grid(
                szs[:, r, 0, 0].contiguous(), pos[r], alone[r],
                table[r].contiguous())
            require(torch.equal(got[r], one), f"S0 OBDM table {dtype} row "
                    f"{r} bit-equal to its single-row launch")
        want = obd_oracle(funcs, szs, pos, cfc)
        gap = float((got.double() - want).abs().max())
        if dtype == torch.float64:
            require(gap <= OBD_F64_TOL, f"S0 OBDM table f64 within "
                    f"{OBD_F64_TOL} of plain: {gap}")
            continue
        plain = funcs.one_body_density_grid_plain(szs, pos, cfc)
        plain_gap = float((plain.double() - want).abs().max())
        require(gap <= OBD_F32_GAP_FACTOR * plain_gap,
                f"S0 OBDM table f32: the kernel's gap from the f64 plain "
                f"version at most {OBD_F32_GAP_FACTOR} times the plain f32 "
                f"version's: {gap} against {plain_gap}")
        del plain, want
        flat = pos.reshape(-1, EOS_NOP).clone()
        first = szs[:, 0, 0, 0].contiguous()
        times = time_pair(
            lambda: funcs.one_body_density_grid(szs, pos, cfc, table),
            lambda: funcs.one_body_density_grid_plain(szs, pos, cfc),
            lambda: funcs.one_body_density_grid(first, flat, alone[0],
                                                table[0].contiguous()))
    out = {**times, "max_abs_err": gap, "plain_max_abs_err": plain_gap,
           **obd_bound(rows * per_row, EOS_NOP, OBD_NUM_POS, rows)}
    phase("S0", check="OBDM table vs plain and single-row launches",
          card=card, shape=[rows, per_row, EOS_NOP, OBD_NUM_POS],
          f64_tol=OBD_F64_TOL, **out, ok=True)
    return out


def eos_procs(**depth):
    """The EOS example's procedures at ``depth``."""
    return tuple(dmc_exec.Proc.from_config(dict(proc, **depth))
                 for proc in EOS_PROCS)


def profile_steps(blocks, steps: int) -> dict:
    """One warm-up block, one profiled block, two timed blocks of
    ``steps`` steps: device ms and kernel launches per step, unprofiled
    host ms per step, the device's busy share (device over the faster
    unprofiled block) and the kernels that take the most device time."""
    next(blocks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        next(blocks)
        torch.cuda.synchronize()
    kernels = []
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total",
                     getattr(event, "self_cuda_time_total", 0.0))
        if us > 0 and event.device_type.name == "CUDA":
            kernels.append((us, event.count, event.key[:60]))
    kernels.sort(reverse=True)
    dev_us = sum(us for us, _, _ in kernels)
    launches = sum(count for _, count, _ in kernels)
    host = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next(blocks)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / steps)
    dev_ms = dev_us / 1e3 / steps
    return {"device_ms_per_step": dev_ms, "launches_per_step":
            launches / steps, "host_ms_per_step": host,
            "busy_share": dev_ms / min(host) if dev_ms else None,
            "top_kernels_ms_per_step": [
                [key, us / 1e3 / steps, count / steps]
                for us, count, key in kernels[:6]]}


def run_eos_sweep(device, card: str) -> dict:
    """Phase S1: the EOS example at full width through ``SweepProc.exec``
    and, row by row, ``Proc.exec``; S1b: a density scan at fixed N with
    the production example's density, S(k) and g2 (K4's bin-size groups,
    the S(k) kernel's table)."""
    procs = eos_procs(**S1_DEPTH)
    nts = procs[0].num_time_steps_block
    steps = (procs[0].burn_in_blocks + procs[0].num_blocks) * nts
    inputs = [dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), p, device=device)
        for p in procs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    sweep_proc = sweep_exec.SweepProc(procs)
    fused, fused_ms, fused_s, fused_counts = timed_exec(sweep_proc, inputs)
    fused_peak = torch.cuda.max_memory_allocated(device) / 1e9
    alone, alone_ms, alone_s = [], 0.0, 0.0
    alone_counts = {}
    for proc, pin in zip(procs, inputs):
        result, ms, wall, counts = timed_exec(
            proc, dmc_exec.ProcInput(pin.state))
        alone.append(result)
        alone_ms, alone_s = alone_ms + ms, alone_s + wall
        alone_counts = {k: alone_counts.get(k, 0) + v
                        for k, v in counts.items()}
    require(fused_counts["K1 table"] == steps and fused_counts["K2 rows"]
            == steps and fused_counts["K1"] == 0 and fused_counts["K2"] == 0,
            f"S1: one K1 table and one K2 rows launch per fused step, no "
            f"single-row launch: {fused_counts}")
    rows_report, equal_rows = [], []
    for r, (f, a) in enumerate(zip(fused, alone)):
        fb, ab = f.data.blocks, a.data.blocks
        equal = all(np.array_equal(getattr(fb, name).totals,
                                   getattr(ab, name).totals)
                    for name in ("energy", "weight", "num_walkers"))
        equal = equal and torch.equal(f.state.pos, a.state.pos)
        equal_rows.append(equal)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            summary = report.summarize(f, "dmc")
            e, e_err = float(fb.energy.mean), float(fb.energy.mean_error)
            a_e, a_err = float(ab.energy.mean), float(ab.energy.mean_error)
        nop = procs[r].model_spec.boson_number
        sigmas = abs(e - a_e) / math.hypot(e_err, a_err) if e != a_e else 0.0
        require(np.isfinite(e) and (equal or sigmas < PHYSICS_SIGMAS),
                f"S1 row {r}: bit-equal to its standalone run, or E/N "
                f"within {PHYSICS_SIGMAS} combined sigma ({sigmas})")
        rows_report.append(dict(
            interaction_strength=procs[r].model_spec.interaction_strength,
            energy_per_boson=e / nop, energy_err=e_err / nop,
            report_energy_per_particle=summary.get("energy_per_particle"),
            report_energy_per_particle_err=summary.get(
                "energy_per_particle_err"),
            bit_equal_to_standalone=equal, combined_sigmas=sigmas))
    parting = None
    if not all(equal_rows):
        parting = first_parting(procs, inputs, nts)
    walker_steps = sum(float(f.data.blocks.num_walkers.totals.sum())
                       / (f.proc.num_blocks * nts) * steps for f in fused)
    # Launches and the device's busy share, a 64-step block fused and of
    # row 0 alone, from the runs' final states.
    sweep = sweep_proc.sweep
    state = dmc.State(*(None if fields[0] is None else torch.stack(fields)
                        for fields in zip(*(f.state for f in fused))))
    prof_fused = profile_steps(sweep.blocks(state, 64), 64)
    prof_alone = profile_steps(procs[0].sampling.blocks(alone[0].state, 64),
                               64)
    phase("S1", check="the EOS example fused and row by row", card=card,
          rows=len(procs), slots_per_row=EOS_SLOTS, steps_run=steps,
          fused_wall_s=fused_s, sequential_wall_s=alone_s,
          fused_walker_steps_per_s=walker_steps / fused_s,
          sequential_walker_steps_per_s=walker_steps / alone_s,
          fused_over_sequential=alone_s / fused_s,
          fused_ms_per_step_cuda_events=fused_ms / steps,
          sequential_ms_per_row_step_cuda_events=alone_ms / (len(procs)
                                                             * steps),
          fused_profile=prof_fused, standalone_profile=prof_alone,
          peak_device_memory_gb=fused_peak, launches=fused_counts,
          sequential_launches=alone_counts, rows_detail=rows_report,
          first_parting=parting, ok=True)
    runs = {"S1": (fused_counts, steps)}
    runs["S1b"] = run_density_scan(device, card)
    return runs


def first_parting(procs, inputs, nts: int) -> list:
    """Per row, the first block and step whose per-step energy differs
    between the fused run and the standalone one (sampler level, the
    same streams), or None."""
    samplings = [p.sampling for p in procs]
    sweep = sweep_exec.SweepProc(procs).sweep
    state = dmc.State(*(None if fields[0] is None else torch.stack(fields)
                        for fields in zip(*(pi.state for pi in inputs))))
    burn = procs[0].burn_in_blocks
    fused = sweep.blocks(state, nts, burn)
    blocks = [next(fused) for _ in range(burn + procs[0].num_blocks)]
    out = []
    for r, (s, pin) in enumerate(zip(samplings, inputs)):
        it, found = s.blocks(pin.state, nts, burn), None
        for b, fb in enumerate(blocks):
            energy = next(it).iter_props.energy
            diff = (fb.iter_props.energy[:, r] != energy).nonzero()
            if len(diff):
                found = {"block": b, "step": int(diff[0])}
                break
        out.append(found)
    return out


def run_density_scan(device, card: str):
    """Phase S1b: the first EOS row at four supercells (a density scan at
    fixed N), with the production example's density, S(k) and g2, one
    measured block fused and row by row: bit-equal rows, K4's groups and
    the S(k) kernel's table launched."""
    base = dict(EOS_PROCS[0], est_every=8, num_blocks=1, burn_in_blocks=0,
                density_spec=dict(num_bins=128, as_pure_est=True),
                ssf_spec=dict(num_modes=64, as_pure_est=True),
                pair_corr_spec=dict(num_bins=128, as_pure_est=True,
                                    est_every_mult=8))
    samplings = [dmc_exec.Proc.from_config(dict(base, rng_seed=21 + r,
                 model_spec=dict(base["model_spec"], supercell_size=sc)))
                 .sampling for r, sc in enumerate(S1B_SUPERCELLS)]
    nts = base["num_time_steps_block"]
    rng = np.random.default_rng(2)
    confs = [rng.uniform(0, s.model_spec.supercell_size,
                         (s.target_num_walkers, EOS_NOP)) for s in samplings]
    sweep = parallel.ParamSweep(tuple(samplings))
    state = sweep.build_states(confs, dtype=np.float32, device=device)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fused = next(sweep.blocks(state, nts))
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    counts = read_counts()
    require(counts["K4 groups"] > 0 and counts["K4"] == 0
            and counts["S(k) table"] > 0 and counts["S(k)"] == 0,
            f"S1b: K4's bin-size groups and the S(k) kernel's table "
            f"launched: {counts}")
    alone_s = 0.0
    for r, s in enumerate(samplings):
        t0 = time.perf_counter()
        one = next(s.blocks(s.build_state(confs[r], dtype=np.float32,
                                          device=device), nts))
        torch.cuda.synchronize()
        alone_s += time.perf_counter() - t0
        for name in ("energy", "num_walkers"):
            require_equal(getattr(fused.iter_props, name)[:, r],
                          getattr(one.iter_props, name),
                          f"S1b row {r} {name}")
        for name in ("iter_density", "iter_ssf", "iter_g2"):
            require_equal(getattr(fused, name)[r], getattr(one, name),
                          f"S1b row {r} {name}")
        for name in ("iter_density", "iter_g2"):
            total = getattr(one, name).sum(-1)
            require(bool(torch.all(total > 0)), f"S1b {name} counts")
    phase("S1b", check="density scan at fixed N, density, S(k) and g2 fused",
          card=card, supercells=list(S1B_SUPERCELLS), steps_run=nts,
          fused_wall_s=fused_s, sequential_wall_s=alone_s,
          rows_bit_equal=True, launches=counts, ok=True)
    return counts, nts


def run_vmc_sweep(device, card: str):
    """Phase S2: the variational example's model and estimators as four
    rows of 4,096 chains at rm 0.3-0.6, fused and row by row: each row
    bit-equal to its standalone run; chain-steps/s both ways."""
    spec = dict(VARIATIONAL_PROC["model_spec"])
    samplings = tuple(vmc.Sampling(
        mrbp.Spec(**dict(spec, tbf_contact_cutoff=rm)), move_spread=0.25,
        rng_seed=7 + r, num_walkers=S2_CHAINS, est_every=8,
        ssf_est_spec=vmc.SSFEstSpec(num_modes=64),
        obd_est_spec=vmc.OBDEstSpec(num_pos=32, est_every_mult=8))
        for r, rm in enumerate(S2_RMS))
    conf = samplings[0].model_spec.init_get_sys_conf(
        dist_type=mrbp.DIST_REGULAR)
    sweep = parallel.VmcSweep(samplings)
    # The states are built first (one K1 log launch a row): the runs'
    # launches and times are the blocks'.
    state = sweep.build_states([conf] * len(samplings),
                               dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    blocks = sweep.blocks(NTS, state)
    fused = [next(blocks) for _ in range(2)]
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    steps = 2 * NTS
    require(counts["K1 log table"] >= steps and counts["K1 log"] == 0,
            f"S2: K1 log's table on every fused step: {counts}")
    alone_s, rows_report = 0.0, []
    for r, s in enumerate(samplings):
        row_state = s.build_state(conf, dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = s.blocks(NTS, row_state)
        alone = [next(it) for _ in range(2)]
        torch.cuda.synchronize()
        alone_s += time.perf_counter() - t0
        for b, (f, a) in enumerate(zip(fused, alone)):
            for name in a.iter_props._fields:
                require_equal(getattr(f.iter_props, name)[r].cpu(),
                              getattr(a.iter_props, name).cpu(),
                              f"S2 row {r} block {b} {name}")
            for name in ("iter_ssf", "iter_obd"):
                require_equal(getattr(f, name)[r].cpu(),
                              getattr(a, name).cpu(),
                              f"S2 row {r} block {b} {name}")
            require(f.accept_rate[r] == a.accept_rate,
                    f"S2 row {r} acceptance")
        rows_report.append(dict(
            rm=S2_RMS[r], energy_per_boson=float(
                alone[-1].iter_props.energy.double().mean()) / VMC_NOP,
            accept_rate=alone[-1].accept_rate))
    chain_steps = len(samplings) * S2_CHAINS * steps
    phase("S2", check="VMC sweep fused and row by row", card=card,
          rows=len(samplings), chains_per_row=S2_CHAINS, steps_run=steps,
          fused_wall_s=fused_s, sequential_wall_s=alone_s,
          fused_chain_steps_per_s=chain_steps / fused_s,
          sequential_chain_steps_per_s=chain_steps / alone_s,
          fused_over_sequential=alone_s / fused_s,
          peak_device_memory_gb=peak, rows_detail=rows_report,
          rows_bit_equal=True, launches=counts, ok=True)
    return counts, steps


# -- phase M: several ranks, a walker mesh -------------------------------------

def card_mesh(device, ranks: int, rows: int = 1):
    """Phase M's mesh on the one card: ``ranks`` gloo ranks on
    ``device`` (NCCL takes one rank per GPU; M0 runs NCCL at one
    rank)."""
    return parallel.make_walker_mesh(devices=[device] * ranks,
                                     backend="gloo", rows=rows)


#: M1: the bench model on 4 ranks of 4,352 slots from D's (equilibrated)
#: state, density and S(k) every 8th step, a rebalance at every block.
M1_PROC = dict(BENCH_PROC, num_mesh_devices=4, rebalance_every=1,
               burn_in_blocks=0, num_blocks=2, keep_iter_data=True,
               est_every=8, density_spec=dict(num_bins=128, as_pure_est=False),
               ssf_spec=dict(num_modes=64, as_pure_est=False))
#: M3: the bench model on 4 ranks of 512 slots, a pure density window of
#: two blocks, cut after block 2 and resumed on 2 ranks.
M3_PROC = dict(BENCH_PROC, max_num_walkers=2048, target_num_walkers=1536,
               num_mesh_devices=4, num_blocks=4, burn_in_blocks=1,
               num_time_steps_block=64, checkpoint_every=1, est_every=8,
               density_spec=dict(num_bins=128, as_pure_est=True,
                                 pfw_num_time_steps=128))
#: M5: the variational example's blocks on 2 ranks, in steps.
M5_STEPS = 512
#: M4: two EOS rows on a 2 x 2 mesh, and each on 2 ranks alone.
M4_DEPTH = dict(num_blocks=2, burn_in_blocks=1, num_time_steps_block=128)


def mesh_sum_rules(label: str, data, every: int) -> dict:
    """Density N nw and S(0) N^2 nw at every measured step of every
    block (a run with its series)."""
    series = data.series
    devs = {}
    for name, rows, per_walker in (
            ("density", series.density.sum(-1), NOP),
            ("ssf", series.ssf[..., 0, 0], NOP ** 2)):
        want = per_walker * series.iter_props.num_walkers[:, every - 1::every]
        require(rows.shape == want.shape,
                f"{label} {name}: a row per measured step")
        devs[name] = float((np.abs(rows - want) / want).max())
        require(devs[name] < SUM_RULE_RTOL,
                f"{label} {name} sum rule within {SUM_RULE_RTOL}: "
                f"{devs[name]}")
    return devs


def energy_per_boson(label: str, blocks) -> float:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # two blocks: no converged reblocking
        e_per_boson = float(blocks.energy.mean) / NOP
    lo, hi = ENERGY_BRACKET
    require(abs(e_per_boson - ENERGY_REF) < ENERGY_TOL
            and lo < e_per_boson < hi,
            f"{label}: E/N {e_per_boson} within {ENERGY_TOL} of "
            f"{ENERGY_REF}")
    return e_per_boson


def steady_step_ms(mesh, sampling, state, burn: int, timed: int) -> float:
    """CUDA-event ms per step of ``timed`` blocks of ``sampling`` from
    ``state`` after ``burn`` blocks, on the rank ``mesh`` (``None``: one
    device, unsharded)."""
    if mesh is not None:
        sampling = dataclasses.replace(sampling, mesh=mesh)
    blocks = sampling.blocks(state, NTS, block_offset=BURN_BLOCKS)
    for _ in range(burn):
        next(blocks)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        next(blocks)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (timed * NTS)


def run_mesh_bench(device, card: str, state):
    """Phase M0: the bench configuration through ``Proc.exec`` with
    ``num_mesh_devices: 1``, one rank over NCCL on the card (its
    collectives every step); then the steady step of the same sampling
    from D's last state, unsharded and on the NCCL rank, in turns.
    Returns the launch counts and the steps run."""
    proc = dmc_exec.Proc.from_config(dict(BENCH_PROC, num_mesh_devices=1))
    spec = proc.mesh_spec(device)
    require(spec.backend == "nccl" and spec.devices == (str(device),),
            f"M0 mesh {spec}: one rank over NCCL on {device}")
    proc_input = dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device=device)
    result, exec_ms, wall_s, launches = timed_exec(proc, proc_input)
    steps_run = (proc.burn_in_blocks + proc.num_blocks) * NTS
    require(tuple(result.state.num_walkers.shape) == (1,)
            and result.state.pos.device.type == "cuda",
            "M0: the global state, one shard, on the card")
    e_per_boson = energy_per_boson("M0", result.data.blocks)
    require(launches["K1"] >= steps_run and launches["K2"] == steps_run,
            f"M0 kernel launches {launches}")
    # The steady step: 1 + 2 blocks each, unsharded and NCCL in turns.
    steady = {"unsharded": [], "nccl": []}
    for kind in ("unsharded", "nccl", "nccl", "unsharded"):
        if kind == "nccl":
            steady[kind].append(parallel.launch(
                steady_step_ms, spec, proc.sampling, state, 1, 2))
        else:
            steady[kind].append(steady_step_ms(None, proc.sampling, state,
                                               1, 2))
    phase("M0", check="bench configuration, num_mesh_devices 1 over NCCL",
          card=card, backend=spec.backend, steps_run=steps_run,
          exec_wall_s=wall_s, step_ms_cuda_events=exec_ms / steps_run,
          steady_step_ms_cuda_events=steady,
          launches_per_step={k: v / steps_run for k, v in launches.items()
                             if v},
          energy_per_boson=e_per_boson, energy_dev=e_per_boson - ENERGY_REF,
          launches=launches, ok=True)
    return launches, steps_run


def run_mesh_estimators(device, card: str, state, block_offset: int):
    """Phase M1: 4 gloo ranks on the card, 4 x 4,352 slots at the bench
    model from D's last state (re-laid out onto 4 shards), density and
    S(k), a rebalance at every block.  Returns the launch counts of rank
    0 and the steps run."""
    proc = dmc_exec.Proc.from_config(dict(M1_PROC, block_offset=block_offset))
    mesh = card_mesh(device, 4)
    result, exec_ms, wall_s, launches = timed_exec(
        proc, dmc_exec.ProcInput(state), mesh=mesh)
    steps_run = (proc.burn_in_blocks + proc.num_blocks) * NTS
    last = result.state
    require(tuple(last.num_walkers.shape) == (4,)
            and bool(torch.isfinite(last.pos).all()),
            "M1: the global state of 4 shards, finite")
    devs = mesh_sum_rules("M1", result.data, proc.est_every)
    e_per_boson = energy_per_boson("M1", result.data.blocks)
    # A rebalance moves walkers, never changes one.
    sampling = proc.sampling
    dealt = sampling.rebalance(last)
    counts = dealt.num_walkers.tolist()
    require(max(counts) - min(counts) <= 1
            and torch.equal(dealt.pos[~dealt.masks].flatten().sort().values,
                            last.pos[~last.masks].flatten().sort().values),
            "M1: a rebalance deals the walkers evenly and keeps their "
            "sorted positions bit-equal")
    require(launches["K1"] >= steps_run and launches["K2"] == steps_run
            and launches["K4"] > 0,
            f"M1 rank 0's kernel launches {launches}")
    nw = result.data.series.iter_props.num_walkers
    phase("M1", check="4 gloo ranks on one card: density, S(k), rebalance",
          card=card, backend="gloo", ranks=4,
          slots_per_rank=proc.max_num_walkers // 4,
          steps_run=steps_run, exec_wall_s=wall_s,
          step_ms_cuda_events_gloo=exec_ms / steps_run,
          mean_num_walkers=float(nw.mean()),
          walker_steps_per_s_gloo=float(nw.sum()) / wall_s,
          sum_rule_max_rel_dev=devs, final_shard_counts=last.num_walkers
          .tolist(), energy_per_boson=e_per_boson,
          energy_dev=e_per_boson - ENERGY_REF, rank0_launches=launches,
          ok=True)
    return launches, steps_run


def mesh_replay(mesh, sampling, confs, comb_u, xi):
    """Rank function of phase M2: the 2-shard injected-noise replay on
    the rank's card and on the CPU, f64; the global positions of both."""
    out = []
    for where in (mesh, dataclasses.replace(mesh, device=torch.device("cpu"))):
        run = dataclasses.replace(sampling, mesh=where)
        state = run.build_state(confs, device=where.device)
        replay = run.replay_states(state, comb_u, xi)
        out.append({name: torch.stack([where.cat(x) for x in replay[name]])
                    .cpu() for name in ("pos", "energies", "weights")}
                   | {name: replay[name].cpu() for name in
                      ("num_walkers", "ref_energy")})
    return out


def check_mesh_replay(device) -> None:
    """Phase M2: the sharded step of 2 gloo ranks on the card against the
    same ranks on the CPU, f64, injected draws, as phase D does."""
    spec = mrbp.Spec(**dict(BENCH_SPEC, boson_number=16,
                            supercell_size=16.0))
    sampling = dmc.Sampling(spec, time_step=1e-2, max_num_walkers=64,
                            target_num_walkers=48, rng_seed=3)
    rng = np.random.default_rng(0)
    confs = np.stack([spec.init_get_sys_conf(rng=rng) for _ in range(48)])
    comb_u = rng.random((10, 64))
    xi = sampling.sigma_spread * rng.standard_normal((10, 64, 16))
    on_card, on_cpu = parallel.launch(mesh_replay, card_mesh(device, 2),
                                      sampling, confs, comb_u, xi)
    require(torch.equal(on_card["num_walkers"], on_cpu["num_walkers"]),
            "M2: the walker counts equal")
    errs = {}
    for name in ("pos", "energies", "weights", "ref_energy"):
        torch.testing.assert_close(on_card[name], on_cpu[name], rtol=1e-9,
                                   atol=1e-9)
        errs[name] = float((on_card[name] - on_cpu[name]).abs().max())
    phase("M2", check="f64 2-shard replay card vs CPU", ranks=2, steps=10,
          max_abs_err=errs, ok=True)


def check_mesh_collapse(device, card: str) -> None:
    """Phase M3: all walkers packed into two of four shards; the first
    block collapses, the run rebalances and goes on; its in-memory
    checkpoint after block 2 resumes on 2 ranks."""
    proc = dmc_exec.Proc.from_config(M3_PROC)
    sampling = proc.sampling
    rng = np.random.default_rng(3)
    spec = proc.model_spec
    shard = proc.max_num_walkers // 4
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(2 * shard)])
    # The first half of the slots valid: shards 0 and 1 full, 2 and 3
    # empty.
    packed = sampling.build_state(confs, dtype=np.float32, device=device,
                                  num_shards=1)
    start_counts = [shard, shard, 0, 0]
    state = packed._replace(num_walkers=torch.tensor(start_counts,
                                                     device=device))
    kept = []

    def hook(resume_input):
        if resume_input.resume["blocks_completed"] == 2:
            kept.append(resume_input)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = proc.exec(dmc_exec.ProcInput(state), checkpoint_hook=hook,
                           mesh=card_mesh(device, 4))
    counts = result.state.num_walkers.tolist()
    blocks = result.data.blocks
    require(min(counts) > 0 and np.isfinite(blocks.energy.mean),
            f"M3: every shard populated after the collapse: {counts}")
    require(blocks.density.totals.shape[0] < 2,
            "M3: the interrupted window contributed no sample")
    (cut,) = kept
    require(tuple(cut.state.num_walkers.shape) == (4,)
            and cut.resume["it_offset"] > proc.block_offset,
            "M3: the checkpoint after block 2 holds the global state and "
            "the restarted stream")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        resumed = proc.evolve({"num_mesh_devices": 2}).exec(
            cut, mesh=card_mesh(device, 2))
    rcounts = resumed.state.num_walkers.tolist()
    require(len(rcounts) == 2 and min(rcounts) > 0
            and np.isfinite(resumed.data.blocks.energy.mean),
            f"M3: resumed on 2 ranks: {rcounts}")
    phase("M3", check="forced shard collapse, then a 4 -> 2 resume",
          card=card, start_counts=start_counts, final_counts=counts,
          resumed_counts=rcounts,
          energy_per_boson=float(blocks.energy.mean) / NOP,
          resumed_energy_per_boson=float(resumed.data.blocks.energy.mean)
          / NOP, ok=True)


def mesh_rows_alone(mesh, procs, host_inputs):
    """Rank function of phase M4: each row's procedure alone on this
    2-rank mesh, one after the other."""
    from phd_qmclib_torch.qmc_exec import sharded
    sharded.silence(mesh)
    results = [proc._exec(sharded.from_host(host, mesh.device), mesh=mesh)
               for proc, host in zip(procs, host_inputs)]
    return results if mesh.rank == 0 else None


def check_mesh_sweep(device, card: str) -> None:
    """Phase M4: two EOS rows on a 2 x 2 mesh of gloo ranks on the card
    (``SweepProc`` with a mesh: ``fused_sweep_mesh: [2, 2]``), each row
    bit-equal to its run alone on 2 ranks."""
    from phd_qmclib_torch.qmc_exec import sharded
    procs = tuple(dmc_exec.Proc.from_config(dict(row, **M4_DEPTH))
                  for row in EOS_PROCS[:2])
    inputs = [dmc_exec.ProcInput.from_model_sys_conf_spec(
        dmc_exec.ModelSysConfSpec(dist_type="RANDOM"), proc, device=device)
        for proc in procs]
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fused = sweep_exec.SweepProc(procs, mesh=card_mesh(device, 4, 2)) \
            .exec(inputs)
    fused_s = time.perf_counter() - t0
    # Alone: the same start as the sweep lays it out over 2 shards.
    alone_inputs = [sharded.to_host(dmc_exec.ProcInput(
        proc.sampling.build_state(
            pi.state.pos[~pi.state.masks].cpu().numpy(), dtype=np.float32,
            device=device, num_shards=2)))
        for proc, pi in zip(procs, inputs)]
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        alone = parallel.launch(mesh_rows_alone, card_mesh(device, 2), procs,
                                alone_inputs)
    alone_s = time.perf_counter() - t0
    energies = []
    for r, (a, b) in enumerate(zip(fused, alone)):
        for name in ("energy", "weight", "num_walkers"):
            require_equal(getattr(a.data.blocks, name).totals,
                          getattr(b.data.blocks, name).totals,
                          f"M4 row {r} {name} totals")
        require(torch.equal(a.state.pos, b.state.pos)
                and torch.equal(a.state.num_walkers, b.state.num_walkers),
                f"M4 row {r}: final state bit-equal to its run alone")
        energies.append(float(a.data.blocks.energy.mean) / EOS_NOP)
    phase("M4", check="fused_sweep_mesh [2, 2], rows vs alone on 2 ranks",
          card=card, backend="gloo", rows=2, ranks_per_row=2,
          steps_per_row=3 * M4_DEPTH["num_time_steps_block"],
          fused_wall_s_gloo=fused_s,
          alone_wall_s_gloo=alone_s, rows_bit_equal=True,
          energy_per_boson=energies, ok=True)


def run_mesh_vmc(device, card: str, r2_energy: float):
    """Phase M5: the variational example on 2 gloo ranks on the card, 1
    burn-in and 1 measured block of ``M5_STEPS``.  Returns rank 0's
    launch counts and the steps run."""
    proc = vmc_exec.Proc.from_config(VARIATIONAL_PROC).evolve(dict(
        num_blocks=1, burn_in_blocks=1, num_steps_block=M5_STEPS,
        keep_iter_data=True, num_mesh_devices=2))
    proc_input = vmc_exec.ProcInput.from_model_sys_conf_spec(
        vmc_exec.ModelSysConfSpec(dist_type="REGULAR"), proc, device=device)
    result, exec_ms, wall_s, launches = timed_exec(
        proc, proc_input, mesh=card_mesh(device, 2))
    steps_run = 2 * M5_STEPS
    series = result.data.series
    e_per_n = float(result.data.blocks.energy.totals.mean()) / VMC_NOP
    accept = float(series.iter_props.move_stat[0].mean())
    s0 = series.ssf[0][:, 0, 0]
    require(result.state.pos.shape == (VMC_CHAINS, VMC_NOP)
            and np.allclose(s0, VMC_NOP ** 2, rtol=SUM_RULE_RTOL)
            and np.allclose(series.obd[0][:, 0], 1.0, rtol=OBDM_RTOL)
            and 0.0 < accept < 1.0 and abs(e_per_n - r2_energy) < 0.02,
            f"M5: all chains back, S(0) = N^2 and OBDM(0) = 1 per chain, "
            f"E/N {e_per_n} near R2's {r2_energy}")
    require(launches["K1 log"] >= steps_run,
            f"M5 rank 0's kernel launches {launches}")
    phase("M5", check="variational example on 2 gloo ranks", card=card,
          backend="gloo", ranks=2, chains=VMC_CHAINS, steps_run=steps_run,
          exec_wall_s=wall_s, step_ms_cuda_events_gloo=exec_ms / steps_run,
          energy_per_boson=e_per_n, R2_energy_per_boson=r2_energy,
          accept_rate=accept, rank0_launches=launches, ok=True)
    return launches, steps_run


# -- phases U, N and S3: the upstream library's draws, the native
# reblocking cascade, rows that differ in dt ---------------------------------

def over_tolerance(got, want, rtol: float, atol: float) -> tuple:
    """The largest deviation of ``got`` from ``want`` and whether every
    element lies within ``atol + rtol |want|`` (numpy's ``allclose``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    dev = np.abs(got - want)
    return float(dev.max()), bool(np.all(dev <= atol + rtol * np.abs(want)))


def check_upstream_replay(device, card: str) -> None:
    """Phase U: the port's samplers on the card, f64 (K1 log and K1),
    driven with the upstream library's draws as ``reference_replay``
    replays them on the host, held to ``tests/test_reference_replay.py``'s
    tolerances: equal acceptance decisions, bit-exact chain positions and
    log|psi| within 1e-12; equal walker counts and branching tables and
    the DMC trajectory at f64 round-off."""
    spec = mrbp.Spec(**UPSTREAM_MODEL)
    nop, sc = spec.boson_number, float(spec.supercell_size)
    for name, kw, start_seed in UPSTREAM_CHAINS:
        ini = np.sort(np.random.default_rng(start_seed).uniform(0, sc,
                                                                 size=nop))
        t0 = time.perf_counter()
        ref = reference_replay.vmc_replay(spec, ini_pos=ini, **kw)
        host_s = time.perf_counter() - t0
        sampling = vmc.Sampling(spec, move_spread=kw["move_spread"],
                                rng_seed=kw["rng_seed"], num_walkers=1,
                                gaussian=kw["gaussian"])
        state = sampling.build_state(ini, dtype=torch.float64, device=device)
        reset_counts()
        pos, wf, accepted = sampling.replay_chain(state, ref.moves_u,
                                                  ref.accept_u)
        counts = read_counts()
        pos, wf, accepted = (x[:, 0].cpu().numpy() for x in
                             (pos, wf, accepted))
        mismatches = int((accepted != ref.accepted).sum())
        pos_err = float(np.abs(pos - ref.pos[1:]).max())
        wf_err, wf_ok = over_tolerance(wf, ref.wf_abs_log[1:],
                                       *UPSTREAM_TOL["wf_abs_log"])
        require(counts["K1 log"] >= kw["num_steps"],
                f"U {name}: K1 log on every step of the card's chain: "
                f"{counts}")
        require(mismatches == 0, f"U {name}: acceptance decisions equal to "
                f"the upstream chain's ({mismatches} differ)")
        require(np.array_equal(pos, ref.pos[1:]),
                f"U {name}: positions bit-exact (largest deviation "
                f"{pos_err})")
        require(wf_ok, f"U {name}: log|psi| within rtol 1e-12 "
                f"(largest deviation {wf_err})")
        phase("U", check="VMC chain on the card vs the upstream draws",
              card=card, proposals=name, steps=kw["num_steps"],
              accept_rate=float(ref.accepted.mean()),
              acceptance_mismatches=mismatches, max_abs_err={
                  "pos": pos_err, "wf_abs_log": wf_err},
              upstream_replay_host_s=host_s, launches=counts, ok=True)

    d = UPSTREAM_DMC
    sampling = dmc.Sampling(
        spec, time_step=d["time_step"], max_num_walkers=d["max_num_walkers"],
        target_num_walkers=d["target_num_walkers"],
        rng_seed=d["sampling_seed"], ref_compat=True)
    rng = np.random.default_rng(d["conf_seed"])
    confs = np.stack([spec.init_get_sys_conf(rng=rng)
                      for _ in range(d["target_num_walkers"])])
    state = sampling.build_state(confs, device=device)
    t0 = time.perf_counter()
    ref = reference_replay.dmc_replay(
        spec, time_step=d["time_step"], rng_seed=d["rng_seed"],
        ini_pos=f64(state.pos), ini_drift=f64(state.drift),
        ini_energies=f64(state.energies), ini_weights=f64(state.weights),
        ini_num_walkers=int(state.num_walkers.sum()),
        ini_ref_energy=float(state.ref_energy),
        max_num_walkers=d["max_num_walkers"],
        target_num_walkers=d["target_num_walkers"],
        nwc_factor=float(sampling.num_walkers_control_factor),
        num_steps=d["num_steps"])
    host_s = time.perf_counter() - t0
    reset_counts()
    out = sampling.replay_states(state, ref.comb_u, ref.diffusion_noise)
    counts = read_counts()
    out = {key: value.cpu().numpy() for key, value in out.items()}
    require(counts["K1"] >= d["num_steps"],
            f"U DMC: K1 on every step on the card: {counts}")
    require(np.array_equal(out["num_walkers"], ref.num_walkers),
            "U DMC: walker counts equal to the upstream run's")
    live = (np.arange(d["max_num_walkers"])[None, :]
            < ref.num_walkers[:, None])
    require(np.array_equal(np.where(live, out["parent"], 0),
                           np.where(live, ref.cloning_refs, 0)),
            "U DMC: branching tables equal to the upstream run's")
    require(ref.num_walkers.min() != ref.num_walkers.max(),
            "U DMC: the population fluctuates")
    errs, misses = {}, []
    for key, want in (("pos", ref.next_pos), ("energies", ref.next_energies),
                      ("weights", ref.next_weights), ("energy", ref.energy),
                      ("ref_energy", ref.ref_energy),
                      ("accum_energy", ref.accum_energy)):
        got = out[key]
        if want.ndim > 1:  # the live slots only
            mask = live if want.ndim == 2 else live[:, :, None]
            got, want = np.where(mask, got, 0.0), np.where(mask, want, 0.0)
        errs[key], ok = over_tolerance(got, want, *UPSTREAM_TOL[key])
        if not ok:
            misses.append(key)
    require(not misses, f"U DMC: {misses} outside the tolerances "
            f"{UPSTREAM_TOL} (largest deviations {errs})")
    phase("U", check="DMC on the card vs the upstream draws, ref_compat",
          card=card, steps=d["num_steps"],
          walkers=[int(ref.num_walkers.min()), int(ref.num_walkers.max())],
          max_abs_err=errs, tolerances=UPSTREAM_TOL,
          upstream_replay_host_s=host_s, launches=counts, ok=True)


def host_cpu_model() -> str:
    """The host CPU's model name as ``lscpu`` (else ``/proc/cpuinfo``)
    reports it, its architecture and its core count."""
    name = None
    if shutil.which("lscpu"):
        for line in subprocess.run(["lscpu"], capture_output=True,
                                   text=True).stdout.splitlines():
            if line.startswith("Model name:"):
                name = line.split(":", 1)[1].strip()
                break
    if name is None:
        with open("/proc/cpuinfo") as fp:
            name = next((line.split(":", 1)[1].strip() for line in fp
                         if line.startswith("model name")), "not reported")
    return f"{name} ({platform.machine()}, {os.cpu_count()} cores)"


def reblock_table(data: np.ndarray, native_on: bool) -> tuple:
    """``reblock.on_the_fly_obj_create(data)`` with the native cascade
    switched on or off, and its host ms."""
    saved = os.environ.get("PHD_QMCLIB_TORCH_NATIVE")
    os.environ["PHD_QMCLIB_TORCH_NATIVE"] = "1" if native_on else "0"
    try:
        t0 = time.perf_counter()
        table = reblock.on_the_fly_obj_create(data)
        return table, (time.perf_counter() - t0) * 1e3
    finally:
        if saved is None:
            del os.environ["PHD_QMCLIB_TORCH_NATIVE"]
        else:
            os.environ["PHD_QMCLIB_TORCH_NATIVE"] = saved


def check_native_reblock(card: str) -> None:
    """Phase N: the native reblocking cascade builds on the card's host
    (``g++``), and its tables of a 2^20 x 4 series lie within rtol 1e-12
    of the NumPy path's; both paths timed in turns (NumPy, native,
    native, NumPy)."""
    cxx = shutil.which("g++")
    require(cxx is not None, "N: no g++ on the card's host, so the native "
            "reblocking cascade cannot build")
    t0 = time.perf_counter()
    available = native.native_available()
    build_s = time.perf_counter() - t0
    require(available, "N: the native reblocking cascade is available")
    data = np.random.default_rng(20).normal(size=NATIVE_SERIES) + 1.5
    times = {True: [], False: []}
    tables = {}
    for native_on in (False, True, True, False):
        tables[native_on], ms = reblock_table(data, native_on)
        times[native_on].append(ms)
    got, want = tables[True], tables[False]
    for field in (reblock.BLOCK_SIZE_FIELD, reblock.NUM_BLOCKS_FIELD):
        require_equal(got[field], want[field], f"N {field}")
    devs = {}
    for field in (reblock.MEANS_FIELD, reblock.MEANS_SQR_FIELD):
        rel = np.abs(got[field] - want[field]) / np.abs(want[field])
        devs[field] = float(rel.max())
        require(devs[field] < NATIVE_RTOL,
                f"N {field}: native within rtol {NATIVE_RTOL} of NumPy "
                f"({devs[field]})")
    phase("N", check="native reblocking cascade vs the NumPy path",
          card=card, host_cpu=host_cpu_model(), compiler=cxx,
          series=list(NATIVE_SERIES), build_and_load_s=build_s,
          native_ms=times[True], numpy_ms=times[False],
          max_rel_dev=devs, ok=True)


def check_energy_finite(blocks, label: str) -> float:
    """E/N of the blocks' weighted per-step energies (a short run from a
    random start: no band), which must be finite."""
    e_per_boson = float(np.mean([
        float(b.iter_props.energy.double().sum()
              / b.iter_props.weight.double().sum()) for b in blocks])) / NOP
    require(math.isfinite(e_per_boson), f"{label}: E/N finite")
    return e_per_boson


def run_dt_sweep(device, card: str):
    """Phase S3: the bench model as four fused rows that differ in the
    time step, each bit-equal to its standalone ``Sampling.blocks`` run
    with the same seed.  Returns the fused run's launch counts and
    steps."""
    spec = mrbp.Spec(**BENCH_SPEC)
    samplings = tuple(dmc.Sampling(spec, time_step=dt, rng_seed=41 + r,
                                   **S3_WALKERS)
                      for r, dt in enumerate(S3_TIME_STEPS))
    rng = np.random.default_rng(3)
    confs = [rng.uniform(0, float(spec.supercell_size),
                         (S3_WALKERS["target_num_walkers"], NOP))
             for _ in samplings]
    sweep = parallel.ParamSweep(samplings)
    state = sweep.build_states(confs, dtype=np.float32, device=device)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    blocks = sweep.blocks(state, S3_NTS, burn_in_blocks=1)
    fused = [next(blocks) for _ in range(S3_BLOCKS)]
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    counts = read_counts()
    steps = S3_BLOCKS * S3_NTS
    require(counts["K1 table"] == steps and counts["K2 rows"] == steps
            and counts["K1"] == 0 and counts["K2"] == 0,
            f"S3: one K1 table and one K2 rows launch per fused step: "
            f"{counts}")
    alone_s, rows_report = 0.0, []
    for r, s in enumerate(samplings):
        row_state = s.build_state(confs[r], dtype=np.float32, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = s.blocks(row_state, S3_NTS, burn_in_blocks=1)
        alone = [next(it) for _ in range(S3_BLOCKS)]
        torch.cuda.synchronize()
        alone_s += time.perf_counter() - t0
        for b, (f, a) in enumerate(zip(fused, alone)):
            for name in ("energy", "weight", "num_walkers", "ref_energy",
                         "accum_energy"):
                require_equal(getattr(f.iter_props, name)[:, r].cpu(),
                              getattr(a.iter_props, name).cpu(),
                              f"S3 row {r} block {b} {name}")
        require(torch.equal(fused[-1].last_state.pos[r],
                            alone[-1].last_state.pos),
                f"S3 row {r}: final positions bit-equal")
        e_per_n = check_energy_finite(alone[1:], f"S3 row {r}")
        rows_report.append(dict(time_step=S3_TIME_STEPS[r],
                                energy_per_boson=e_per_n))
    phase("S3", check="rows that differ in dt, fused and row by row",
          card=card, rows=len(samplings), steps_run=steps,
          walkers_per_row=S3_WALKERS, fused_wall_s=fused_s,
          sequential_wall_s=alone_s, fused_over_sequential=alone_s / fused_s,
          rows_bit_equal=True, rows_detail=rows_report, launches=counts,
          ok=True)
    return counts, steps


def k3_bound(npos, params, flops_per_pair=(K3_FLOPS_IN_CUT,
                                           K3_FLOPS_OUTSIDE),
             per_element: int = K3_FLOPS_PER_ELEMENT) -> dict:
    """K3's bound at the moved positions ``npos``: its pairs' flops
    (``pair_flops``) and ``per_element`` flops per element; positions,
    drift and the normals' key in, parameters, energies and E_ref, moved
    positions, drift, energy and weight out."""
    walkers, nop = npos.shape
    numel = walkers * nop
    counted = pair_flops(npos, params, flops_per_pair)
    return dict(bound(counted.pop("flops") + numel * per_element,
                      F32_BYTES * (4 * numel + 3 * walkers
                                   + pairwise.PARAMS_SIZE + 1)), **counted)


def k4_bound(rows: int, row_len: int, num_bins: int) -> dict:
    """K4's bound: the rows in, the counts out."""
    return bound(rows * row_len * K4_FLOPS_PER_ELEMENT,
                 F32_BYTES * (rows * row_len + rows * num_bins + 1))


def obd_bound(walkers: int, nop: int, num_pos: int, rows: int = 1) -> dict:
    """The OBDM kernel's bound: every ordered pair at each offset and at
    none; positions and each row's offsets and parameters in, the grid
    out."""
    pairs = walkers * nop * (nop - 1) * (num_pos + 1)
    values = (walkers * nop + rows * (num_pos + pairwise.PARAMS_SIZE)
              + walkers * num_pos)
    return dict(bound(pairs * OBD_FLOPS_PER_PAIR, F32_BYTES * values),
                pairs=pairs)


def obd_oracle(funcs, szs, pos, cfc, chunk: int = 1024) -> torch.Tensor:
    """The plain version in f64 at the inputs' own values, ``chunk``
    walkers at a time along the walker axis (each walker's grid is its
    own): the f64 (W, N, N) passes would not fit at once."""
    cfc64 = mrbp.cast_params(cfc, torch.float64, pos.device)
    return torch.cat([
        funcs.one_body_density_grid_plain(
            szs.double(), pos[..., a:a + chunk, :].double(), cfc64)
        for a in range(0, pos.shape[-2], chunk)], dim=-2)


#: What the OBDM kernel stands for in the JAX package.
OBD_REPLACES = ("phd_qmclib_tpu/models/jastrow.py:375 (XLA's "
                "one_body_density_grid; no pallas_call)")


def check_obd(device, card: str) -> tuple:
    """Phase O: the OBDM grid's kernel against its plain version at the
    production and variational shapes.  Returns the f32 kernel's largest
    gap from the f64 plain version at the production shape and the times
    by shape."""
    err, times = None, {}
    for label, spec_kwargs, walkers in (
            ("production", BENCH_SPEC, MAX_WALKERS),
            ("variational", VMC_SPEC, VMC_CHAINS)):
        spec = mrbp.Spec(**spec_kwargs)
        nop, length = spec.boson_number, float(spec.supercell_size)
        funcs = mrbp.core_funcs(spec)
        pos = torch.as_tensor(np.random.default_rng(nop).uniform(
            0, length, (walkers, nop)), dtype=torch.float32, device=device)
        offsets = torch.as_tensor(np.linspace(0.0, 0.5 * length,
                                              OBD_NUM_POS),
                                  dtype=torch.float32, device=device)
        cfc = mrbp.cast_params(spec.cfc_params, torch.float32, device)
        want = obd_oracle(funcs, offsets, pos, cfc)
        got64 = funcs.one_body_density_grid(
            offsets.double(), pos.double(),
            mrbp.cast_params(cfc, torch.float64, device))
        f64_err = float((got64 - want).abs().max())
        require(f64_err <= OBD_F64_TOL, f"O {label}: the f64 kernel within "
                f"{OBD_F64_TOL} of the plain version: {f64_err}")
        del got64
        outs = {}

        def kernel():
            outs["kernel"] = funcs.one_body_density_grid(offsets, pos, cfc)

        def plain():
            outs["plain"] = funcs.one_body_density_grid_plain(offsets, pos,
                                                              cfc)

        p1 = cuda_ms(plain, 1)
        k1 = cuda_ms(kernel, 20)
        k2 = cuda_ms(kernel, 20)
        p2 = cuda_ms(plain, 1)
        gap, plain_gap = (float((outs[k].double() - want).abs().max())
                          for k in ("kernel", "plain"))
        require(gap <= OBD_F32_GAP_FACTOR * plain_gap,
                f"O {label}: the f32 kernel's gap from the f64 plain version "
                f"at most {OBD_F32_GAP_FACTOR} times the plain f32 "
                f"version's: {gap} against {plain_gap}")
        require(bool((outs["kernel"][:, 0] == 1).all()),
                f"O {label}: n1(0) exactly 1 on every walker")
        least = obd_bound(walkers, nop, OBD_NUM_POS)
        times[label] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                        "device_ms": device_ms(kernel, 20),
                        "max_abs_err": gap, "plain_max_abs_err": plain_gap,
                        "f64_max_abs_err": f64_err, **least}
        if err is None:
            err = gap
        phase("O", kernel="OBDM", card=card, label=label,
              shape=[walkers, nop, OBD_NUM_POS], plain_ms_turns=[p1, p2],
              kernel_ms_turns=[k1, k2], speedup=(p1 + p2) / (k1 + k2),
              bound_share=least["bound_ms"] / times[label]["ms"],
              **times[label], ok=True)
        del outs, want
    return err, times


def ssf_bound(walkers: int, nop: int, num_modes: int, rows: int = 1) -> dict:
    """The S(k) kernel's bound: ``SSF_FLOPS_PER_ELEMENT`` per particle
    and mode; positions and each row's k_1 in, the triples out."""
    values = walkers * nop + rows + 3 * walkers * num_modes
    return bound(walkers * nop * num_modes * SSF_FLOPS_PER_ELEMENT,
                 F32_BYTES * values)


def ssf_reorder_gaps(got, want, nop: int) -> dict:
    """How far the f32 kernel's parts lie from the plain f32 version's,
    as a share of the bound of two orders of the same particle sums: each
    within gamma_{N-1} sum_i |x_i| of the exact sum, every element within
    1.01 of 0; |rho|^2 through the squares and three roundings a side.
    At most 1 where only the order differs."""
    u = 2.0 ** -24
    gamma = (nop - 1) * u / (1 - (nop - 1) * u)
    d = 2 * gamma * 1.01 * nop
    re, im = want[..., 1].abs(), want[..., 2].abs()
    d0 = 2 * (re + im) * d + 2 * d * d + 6 * u * (re ** 2 + im ** 2 + 4 * d)
    gap = (got.double() - want.double()).abs()
    return {"max_abs_err": float(gap.max()),
            "share_of_reorder_bound": max(float((gap[..., 0] / d0).max()),
                                          float(gap[..., 1:].max()) / d)}


def ssf_f64_gap(got, want, nop: int) -> float:
    """The f64 kernel's largest gap from the f64 plain version, relative
    to each slot's scale (N^2, N)."""
    gap = (got - want).abs()
    return max(float(gap[..., 0].max()) / nop ** 2,
               float(gap[..., 1:].max()) / nop)


#: What the S(k) kernel stands for in the JAX package.
SSF_REPLACES = ("phd_qmclib_tpu/models/jastrow.py:464 (the XLA scan "
                "_fourier_harmonics_scan; no pallas_call)")


def check_ssf(device, card: str) -> tuple:
    """Phase K: the S(k) kernel against its plain recurrence at the sk,
    variational and production shapes, and its 4-row table.  Returns the
    f32 kernel's largest gap from the plain f32 version at the production
    shape, the times by shape and the table's row."""
    err, times = None, {}
    for label, walkers, nop, num_modes in SSF_SHAPES:
        spec = mrbp.Spec(**dict(BENCH_SPEC, boson_number=nop,
                                supercell_size=float(nop)))
        funcs = mrbp.core_funcs(spec)
        rng = np.random.default_rng(nop + num_modes)
        pos = torch.as_tensor(rng.uniform(0, float(nop), (walkers, nop)),
                              dtype=torch.float32, device=device)
        cfc = mrbp.cast_params(spec.cfc_params, torch.float32, device)
        cfc64 = mrbp.cast_params(cfc, torch.float64, device)
        got64 = funcs.fourier_density_parts_harmonics(num_modes,
                                                      pos.double(), cfc64)
        want64 = funcs.fourier_density_parts_harmonics_plain(
            num_modes, pos.double(), cfc64)
        f64_err = ssf_f64_gap(got64, want64, nop)
        require(f64_err <= SSF_F64_RTOL, f"K {label}: the f64 kernel "
                f"within {SSF_F64_RTOL} of each slot's scale: {f64_err}")
        del got64, want64
        outs = {}

        def kernel():
            outs["kernel"] = funcs.fourier_density_parts_harmonics(
                num_modes, pos, cfc)

        def plain():
            outs["plain"] = funcs.fourier_density_parts_harmonics_plain(
                num_modes, pos, cfc)

        lengths = cfc.model_params.supercell_size.reshape(1)

        def alone():
            ssf.ssf_harmonics(pos, lengths, num_modes=num_modes)

        p1 = cuda_ms(plain, 5)
        c1 = cuda_ms(kernel, 200)
        c2 = cuda_ms(kernel, 200)
        p2 = cuda_ms(plain, 5)
        gaps = ssf_reorder_gaps(outs["kernel"], outs["plain"], nop)
        require(gaps["share_of_reorder_bound"] <= 1.0,
                f"K {label}: the f32 kernel within the bound of the sums' "
                f"order of the plain f32 version: {gaps}")
        require(torch.equal(outs["kernel"][:, 0], outs["plain"][:, 0]),
                f"K {label}: the k = 0 mode exact")
        pair = funcs.fourier_density_reim_harmonics(num_modes, pos, cfc)
        require(torch.equal(pair, outs["kernel"][..., 1:3]),
                f"K {label}: the ITC pair bit for bit the parts' slots 1-2")
        least = ssf_bound(walkers, nop, num_modes)
        kernel_alone_ms = cuda_ms(alone, 200)
        dev_ms = device_ms(alone, 200)
        times[label] = {"ms": (c1 + c2) / 2, "plain_ms": (p1 + p2) / 2,
                        "kernel_alone_ms": kernel_alone_ms,
                        "device_ms": dev_ms, **gaps,
                        "f64_max_rel_err": f64_err, **least}
        if label == "production":
            err = gaps["max_abs_err"]
        phase("K", kernel="S(k)", card=card, label=label,
              shape=[walkers, nop, num_modes], plain_ms_turns=[p1, p2],
              call_ms_turns=[c1, c2], speedup=(p1 + p2) / (c1 + c2),
              bound_share=least["bound_ms"] / times[label]["ms"],
              bound_share_of_device_time=(least["bound_ms"] / dev_ms
                                          if dev_ms else None),
              **times[label], ok=True)
        del outs, pair
    return err, times, check_ssf_rows(device, card)


def check_ssf_rows(device, card: str) -> dict:
    """Phase K's table: four supercells at N=64 (a density scan), 64
    modes, 4 x 4,352 walkers in one launch: each row bit-equal to its
    launch alone, f64 within 1e-12 of the plain version, f32 within the
    bound of the sums' order; timed beside the single-row launch at the
    same total width."""
    rows, per_row, num_modes = 4, EOS_SLOTS, 64
    specs = [mrbp.Spec(**dict(BENCH_SPEC, boson_number=EOS_NOP,
                              supercell_size=sc)) for sc in S1B_SUPERCELLS]
    funcs = mrbp.core_funcs(specs[0])
    rng = np.random.default_rng(9)
    out = {}
    for dtype in (torch.float64, torch.float32):
        pos = torch.as_tensor(np.stack([
            rng.uniform(0, s.supercell_size, (per_row, EOS_NOP))
            for s in specs]), dtype=dtype, device=device)
        cfc = dmc._rows_cfc(specs, dtype, device)
        got = funcs.fourier_density_parts_harmonics(num_modes, pos, cfc)
        for r, spec in enumerate(specs):
            one = funcs.fourier_density_parts_harmonics(
                num_modes, pos[r], mrbp.cast_params(spec.cfc_params, dtype,
                                                    device))
            require(torch.equal(got[r], one), f"K table {dtype} row {r} "
                    f"bit-equal to its launch alone")
        want = funcs.fourier_density_parts_harmonics_plain(num_modes, pos,
                                                           cfc)
        if dtype == torch.float64:
            gap = ssf_f64_gap(got, want, EOS_NOP)
            require(gap <= SSF_F64_RTOL, f"K table f64 within "
                    f"{SSF_F64_RTOL} of the plain version: {gap}")
            continue
        gaps = ssf_reorder_gaps(got, want, EOS_NOP)
        require(gaps["share_of_reorder_bound"] <= 1.0,
                f"K table f32 within the bound of the sums' order: {gaps}")
        single = pos.reshape(1, rows * per_row, EOS_NOP)
        one_cfc = mrbp.cast_params(specs[0].cfc_params, dtype, device)
        times = time_pair(
            lambda: funcs.fourier_density_parts_harmonics(num_modes, pos,
                                                          cfc),
            lambda: funcs.fourier_density_parts_harmonics_plain(
                num_modes, pos, cfc),
            lambda: funcs.fourier_density_parts_harmonics(
                num_modes, single, one_cfc))
        out = {**times, **gaps,
               **ssf_bound(rows * per_row, EOS_NOP, num_modes, rows)}
    phase("K", check="S(k) table vs plain and single-row launches",
          card=card, shape=[rows, per_row, EOS_NOP, num_modes],
          f64_rtol=SSF_F64_RTOL, **out, ok=True)
    return out


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
    dpos = pairwise.diffuse_energy_drift_plain(**dargs, **dkw)[0]
    walkers, numel = MAX_WALKERS, MAX_WALKERS * NOP
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
               5, 50, k3_bound(dpos, dargs["params"])),
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
    # K3's bound under the first design's count, beside the recount's.
    first = k3_bound(dpos, dargs["params"], *K3_FIRST_DESIGN_FLOPS)
    phase("E", kernel="K3", card=card, bound_ms=times["K3"]["bound_ms"],
          bound_share=times["K3"]["bound_ms"] / times["K3"]["ms"],
          bound_ms_first_design_count=first["bound_ms"],
          bound_share_first_design_count=first["bound_ms"]
          / times["K3"]["ms"], ok=True)
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


def ptxas_report(log: str, kernels) -> list:
    """Registers, stack frame and spills of each instantiation of the
    kernels named in ``kernels``, from the build's ``-Xptxas -v`` report
    (empty when the library was up to date): its name, dtype and, for a
    kernel templated on its block size, the block size."""
    entries, mangled, own = [], None, False
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        props = re.search(r"Function properties for (\S+)", line)
        if entry:
            mangled = entry[1]
            name = next((k for k in kernels if k in mangled), None)
            kind = re.search(r"kernelI([fd])(?:Li(\d+)E)?", mangled)
            entries.append(None if name is None or kind is None else {
                "instantiation": name, "dtype": "f32" if kind[1] == "f"
                else "f64", "block_size": None if kind[2] is None
                else int(kind[2])})
        elif props:
            own = props[1] == mangled  # not a device function's
        elif entries and entries[-1] is not None:
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
            if frame and own:
                entries[-1].update(stack_bytes=int(frame[1]),
                                   spill_store_bytes=int(frame[2]),
                                   spill_load_bytes=int(frame[3]))
            used = re.search(r"Used (\d+) registers", line)
            if used:
                entries[-1]["registers"] = int(used[1])
    return [e for e in entries if e is not None]


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
    for entry in ptxas_report(log, ("pair_logpsi_params_vjp_kernel",
                                    "philox_normals_rows_kernel",
                                    "diffuse_kernel")):
        phase("A", **entry, ok=True)

    err_k1 = check_k1(device)  # B
    err_k2 = check_k2(device)  # C
    check_replay(device)  # D
    dmc_launches, state = run_dmc(device, smi)  # D
    # Each run's launch counts and the steps it ran.
    runs = {"D": (dmc_launches, (BURN_BLOCKS + TIMED_BLOCKS) * NTS),
            "R0": run_proc_bench(device, smi)}
    check_proc_resume(device, smi)  # R3
    err_k4 = check_k4(device)  # F
    sweep_times = check_sweep_kernels(device, smi)  # S0
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
                                     offset, timed=label == "G1")
        runs[label] = (done[label]["launches"], TIMED_BLOCKS * NTS)
    check_same_trajectory(done["G3"], done["G2"])
    runs["R1"] = run_proc_production(device, smi, state, done["G3"],
                                     BURN_BLOCKS + 2 * TIMED_BLOCKS)
    del done
    check_free_gas_itc(device, smi)  # P
    check_tonks_girardeau(device, smi)  # P
    err_k1_log = check_k1_log(device)  # H
    check_vmc_replay(device)  # I
    runs["V1"] = run_vmc_bench(device, smi)
    v2 = run_vmc_example(device, smi)
    runs["V2"] = (v2["launches"], v2["steps_run"])
    *runs["R2"], r2_energy = run_proc_vmc_example(device, smi, v2)
    del v2
    err_vjp, vjp_times = check_k1_vjp(device, smi)  # W0
    runs.update(run_wf_opt_pipeline(device, smi))  # W1
    runs["W2"], w2_counts = run_wf_opt_ab(device, smi)
    runs.update(run_eos_sweep(device, smi))  # S1, S1b
    runs["S2"] = run_vmc_sweep(device, smi)
    # M: several ranks.  M0 over NCCL at one rank; M1-M5 S gloo ranks on
    # the card (rank 0's launches, in this process, counted).
    runs["M0"] = run_mesh_bench(device, smi, state)
    runs["M1"] = run_mesh_estimators(device, smi, state,
                                     BURN_BLOCKS + 3 * TIMED_BLOCKS)
    check_mesh_replay(device)  # M2
    check_mesh_collapse(device, smi)  # M3
    check_mesh_sweep(device, smi)  # M4
    runs["M5"] = run_mesh_vmc(device, smi, r2_energy)
    check_upstream_replay(device, smi)  # U
    check_native_reblock(smi)  # N
    runs["S3"] = run_dt_sweep(device, smi)
    err_k3 = check_k3(device)  # J
    times = time_kernels(device, smi)  # E
    err_obd, obd_times = check_obd(device, smi)  # O
    err_ssf, ssf_times, ssf_table = check_ssf(device, smi)  # K

    # The main path's launches: each run of D, G1, G2, G3, V1, V2 and, through
    # the execution layer, R0, R1 and R2 counts from 0.  K3 lies on no path (the DMC step keeps its own sequence,
    # as in the JAX package): none of those runs may have launched it.
    launches = {name: sum(counts[name] for counts, _ in runs.values())
                for name in COUNTERS}
    per_step = {name: {label: counts[name] / steps
                       for label, (counts, steps) in runs.items()
                       if counts[name]}
                for name in COUNTERS}
    require(all(launches[name] > 0
                for name in ("K1", "K1 log", "K1 vjp", "K2", "K4", "OBDM",
                             "K1 table", "K1 log table", "K2 rows",
                             "K4 groups", "OBDM table", "S(k)",
                             "S(k) table")),
            f"every kernel of the main path launched: {launches}")
    require(per_step["K1 table"].get("S1") == 1
            and per_step["K2 rows"].get("S1") == 1
            and per_step["K1 log table"].get("S2", 0) >= 1
            and per_step["OBDM table"].get("S2", 0) > 0,
            f"a fused DMC step launches K1's table and K2's rows once, a "
            f"fused VMC step K1 log's table, S2's OBDM steps the OBDM "
            f"kernel's table: {per_step}")
    require(launches["K3"] == 0, f"K3 off the main path: {launches}")
    require(all(per_step["S(k)"].get(label, 0) > 0
                for label in ("G1", "G2", "G3", "R1", "V1", "V2", "R2",
                              "S2", "M5"))
            and per_step["S(k) table"].get("S1b", 0) > 0,
            f"the S(k) kernel on every run that measures S(k) (its table "
            f"on S1b's rows of four supercells): {per_step}")
    # The runs of one row on the card replay their steps from graphs;
    # the fused sweeps and the meshes step eagerly.
    require(all(runs[label][0]["graph captures"] == 1
                for label in ("D", "G1", "G2", "G3", "R0", "R1"))
            and all(runs[label][0]["VMC graph captures"] == 1
                    for label in ("V1", "V2", "R2", "W1"))
            and all(runs[label][0][f"{sampler}graph replays"] == 0
                    for label in ("S1", "S1b", "S2", "S3", "M0", "M1", "M5")
                    for sampler in ("", "VMC ")),
            "a step graph in every single-row DMC and VMC run, none in the "
            "sweeps' and meshes': " + str({
                label: {name: counts[name] for name in
                        ("graph captures", "graph replays",
                         "VMC graph captures", "VMC graph replays")}
                for label, (counts, _) in runs.items()}))
    dmc_runs = ("D", "G1", "G2", "G3", "R0", "R1", "W1 dmc", "M0", "M1")
    require(all(per_step["K1"].get(label, 0) >= 1 for label in dmc_runs)
            and all(per_step["K2"].get(label, 0) == 1 for label in dmc_runs)
            and all(per_step["K4"].get(label, 0) > 0
                    for label in ("G3", "R1"))
            and all(per_step["OBDM"].get(label, 0) > 0
                    for label in ("G3", "R1", "V2", "R2"))
            and all(per_step["K1 log"].get(label, 0) >= 1
                    for label in ("V1", "V2", "R2", "W1", "W2", "M5")),
            f"K1 on every DMC step (K2 once, K4 on G3's and R1's density "
            f"and g2 steps, the OBDM kernel on the OBDM steps of G3, R1, "
            f"V2 and R2) and K1 log on every VMC step: {per_step}")

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

    times["K1 vjp"] = vjp_times["dmc shape"]
    times["OBDM"] = obd_times["production"]
    times["S(k)"] = ssf_times["production"]
    times["S(k) table"] = ssf_table
    obd_vmc = obd_times["variational"]
    times.update(sweep_times)
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
        # The row variants of a fused sweep (S0's times at S1's width,
        # 4 x 4352 walkers, beside the single-row launch at the same
        # total width).
        dict(row("pair_energy_drift_table", "K1 table", "pairwise.cu",
                 "pairwise.py:84", sweep_times["K1 table"]["max_abs_err"]),
             variant_of="pair_energy_drift"),
        dict(row("pair_logpsi_energy_drift_table", "K1 log table",
                 "pairwise.cu", "pairwise.py:84",
                 sweep_times["K1 log table"]["max_abs_err"]),
             variant_of="pair_logpsi_energy_drift"),
        dict(row("philox_normals_rows", "K2 rows", "prng.cu", "prng.py:64",
                 sweep_times["K2 rows"]["max_abs_err"]),
             variant_of="philox_normals",
             library_call="torch.randn, another stream"),
        dict(row("walker_histogram_groups", "K4 groups", "histogram.cu",
                 "histogram.py:81", 0.0), variant_of="walker_histogram"),
        # No pallas_call: it stands for XLA's autodiff of the JAX
        # package's log_psi_and_energy, which GradCSWFOptimizer
        # differentiates.  No single PyTorch call computes it.
        dict(row("pair_logpsi_params_vjp", "K1 vjp", "pairwise.cu",
                 "pairwise.py:84", err_vjp),
             replaces="phd_qmclib_tpu/models/jastrow.py:238 (XLA autodiff "
                      "of log_psi_and_energy; no pallas_call)",
             body="phd_qmclib_torch/csrc/pair_terms_grad.cuh",
             vmc_shape_ms=vjp_times["vmc shape"]["ms"],
             vmc_shape_plain_ms=vjp_times["vmc shape"]["plain_ms"],
             vmc_shape_bound_ms=vjp_times["vmc shape"]["bound_ms"],
             vmc_shape_forward_ms=vjp_times["vmc shape"]["forward_ms"],
             vmc_shape_f64_ms=vjp_times["vmc shape"]["f64_ms"],
             launches_per_optimization=w2_counts),
        # No pallas_call either: the JAX package leaves the grid to XLA.
        dict(row("obd_grid", "OBDM", "obd.cu", "", err_obd,
                 variational_ms=obd_vmc["ms"],
                 variational_plain_ms=obd_vmc["plain_ms"],
                 variational_device_ms=obd_vmc["device_ms"],
                 variational_bound_ms=obd_vmc["bound_ms"],
                 variational_max_abs_err=obd_vmc["max_abs_err"]),
             replaces=OBD_REPLACES),
        dict(row("obd_grid_table", "OBDM table", "obd.cu", "",
                 sweep_times["OBDM table"]["max_abs_err"]),
             variant_of="obd_grid", replaces=OBD_REPLACES),
        # Nor for S(k): the JAX package's harmonics are an XLA scan.
        # Times at the production shape, the cells' others beside them.
        dict(row("ssf_harmonics", "S(k)", "ssf.cu", "", err_ssf,
                 **{f"{label}_{key}": ssf_times[label][key]
                    for label in ("sk", "variational")
                    for key in ("ms", "plain_ms", "device_ms", "bound_ms",
                                "max_abs_err")}),
             replaces=SSF_REPLACES),
        dict(row("ssf_harmonics_table", "S(k) table", "ssf.cu", "",
                 times["S(k) table"]["max_abs_err"]),
             variant_of="ssf_harmonics", replaces=SSF_REPLACES),
    ]
    print(smi, flush=True)  # again, next to the result lines
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
