// Fused Bijl-Jastrow local energy, drift and (optionally) log|psi| for
// the mrbp model.
//
// Replaces the Pallas TPU kernel phd_qmclib_tpu/ops/pairwise.py::_kernel
// (wrapper energy_and_drift_pallas), both of its variants, as one
// template with a compile-time flag kLogPsi:
//   * forward (with_log_psi=False, the DMC step): E_L (W,) and the drift
//     (W, N);
//   * log (with_log_psi=True, the VMC step): log|psi| (W,) as well.
// For every walker it computes the one-body Kronig-Penney terms (orbital
// log-derivative, kinetic, barrier/defect potential, and with kLogPsi
// log|f1|) and the O(N^2) minimum-image phonon pair block, one
// branch-selected tan/cot per unordered pair (and one log with kLogPsi).
// The walker's body lives in pair_terms.cuh, which the fused diffusion
// kernel (diffuse.cu) shares.
//
// What bounds it on the H100: FP32 instruction issue.  The only memory
// traffic is N positions in and N + 1 (N + 2 with kLogPsi) values out per
// walker: 17.8 MB at 17408 x 128 against 141.5 M unordered pairs.
// Counted in float as written (pair_terms.cuh; fma = 2, rcp and lg2 = 1),
// an unordered pair costs 28 flops, 40 with kLogPsi: ~220 flops per byte,
// ten times the card's 20 (67 TFLOP/s over 3.35 TB/s).  The real limit is
// instruction issue: the f32 pair loop's SASS holds 44 instructions per
// unordered pair (49.5 with kLogPsi; compares, selects, one LDS.128, one
// STS.64, the barrier and the ring index besides the arithmetic), and an
// issue slot retires at most one FMA, so the flops fill at most a third
// of the slots.  The first design (one thread per particle over all
// j != i) evaluated every pair twice, with an IEEE divide, a rintf on the
// conversion pipe and, with kLogPsi, an accurate logf per ordered pair:
// ~84 instructions per unordered pair in f32, ~154 with kLogPsi.
//
// What the design does about it: one CTA per walker, one thread per
// particle, the walker's positions in shared memory.  Each unordered pair
// is evaluated once on a half ring (walker_terms): the odd drift term goes
// to i and, negated, to j, the even kinetic term to both, the j side
// through a shared-memory slot per particle, a barrier per step.  The
// minimum image is two compares and a select (positions in [0, L)), the
// tan/cot ratio one MUFU reciprocal, the pair log one MUFU log2; log|f2|
// needs no j side, as only its walker sum is wanted.  The energy and
// log|psi| terms are reduced in one pass (block_sums).  No pair value
// ever leaves the registers.  Any N up to 1024, float and double; the
// free-gas and ideal-gas branches are uniform flags read once per thread.
//
// Accuracy: built without --use_fast_math: the one-body tanf/tanhf/cosf/
// coshf/logf are the accurate ones.  The approximate reciprocal and log2
// stay well inside the kernel-vs-plain tolerances of chip_smoke.py and
// tests/test_torch_cuda_kernels.py; double keeps the IEEE divide, sincos
// and log, and is the oracle of the schedule.  E_L sums per-particle terms
// (kin_i - drift_i^2 + pot_i) before the block reduction, the order of
// the Pallas kernel and of the plain torch version: the kinetic and
// drift^2 sums are each large against E_L and cancel.
#include <cuda_runtime.h>

#include "pair_terms.cuh"

namespace {

using qmc::kMaxThreads;

template <typename T, bool kLogPsi>
__global__ void __launch_bounds__(kMaxThreads)
pair_energy_drift_kernel(const T* __restrict__ pos,
                         const T* __restrict__ params,
                         T* __restrict__ energy, T* __restrict__ drift,
                         T* __restrict__ log_psi, int nop, int is_free,
                         int is_ideal, int defects_sep) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const qmc::WalkerSmem<T> smem(smem_raw);

  const size_t walker = blockIdx.x;
  const int i = threadIdx.x;
  const T zi = i < nop ? pos[walker * nop + i] : T(0);
  smem.slots[i] = {qmc::into_supercell(zi, params[qmc::P_L]), T(0), T(0),
                   T(0)};
  __syncthreads();

  T drift_i, term, log_i;
  qmc::walker_terms<T, kLogPsi>(smem.slots, nop, zi, params, is_free,
                                is_ideal, defects_sep, &drift_i, &term,
                                &log_i);
  if (i < nop) drift[walker * nop + i] = drift_i;

  // One reduction pass for the energy and, with kLogPsi, log|psi|.
  if constexpr (kLogPsi) {
    T sums[2] = {term, log_i};
    qmc::block_sums(sums, smem.warp_sums);
    if (i == 0) {
      energy[walker] = sums[0];
      log_psi[walker] = sums[1];
    }
  } else {
    T sums[1] = {term};
    qmc::block_sums(sums, smem.warp_sums);
    if (i == 0) energy[walker] = sums[0];
  }
}

template <typename T, bool kLogPsi>
int launch(const void* pos, const void* params, void* log_psi, void* energy,
           void* drift, int num_walkers, int nop, int is_free, int is_ideal,
           int defects_sep, void* stream) {
  if (num_walkers <= 0 || nop <= 0 || nop > kMaxThreads ||
      defects_sep < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((nop + 31) / 32) * 32;
  pair_energy_drift_kernel<T, kLogPsi>
      <<<num_walkers, threads, qmc::WalkerSmem<T>::bytes(threads),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pos), static_cast<const T*>(params),
          static_cast<T*>(energy), static_cast<T*>(drift),
          static_cast<T*>(log_psi), nop, is_free, is_ideal, defects_sep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_pair_energy_drift_f32(const void* pos, const void* params,
                                         void* energy, void* drift,
                                         int num_walkers, int nop,
                                         int is_free, int is_ideal,
                                         int defects_sep, void* stream) {
  return launch<float, false>(pos, params, nullptr, energy, drift,
                              num_walkers, nop, is_free, is_ideal,
                              defects_sep, stream);
}

extern "C" int qmc_pair_energy_drift_f64(const void* pos, const void* params,
                                         void* energy, void* drift,
                                         int num_walkers, int nop,
                                         int is_free, int is_ideal,
                                         int defects_sep, void* stream) {
  return launch<double, false>(pos, params, nullptr, energy, drift,
                               num_walkers, nop, is_free, is_ideal,
                               defects_sep, stream);
}

extern "C" int qmc_pair_logpsi_energy_drift_f32(
    const void* pos, const void* params, void* log_psi, void* energy,
    void* drift, int num_walkers, int nop, int is_free, int is_ideal,
    int defects_sep, void* stream) {
  return launch<float, true>(pos, params, log_psi, energy, drift,
                             num_walkers, nop, is_free, is_ideal,
                             defects_sep, stream);
}

extern "C" int qmc_pair_logpsi_energy_drift_f64(
    const void* pos, const void* params, void* log_psi, void* energy,
    void* drift, int num_walkers, int nop, int is_free, int is_ideal,
    int defects_sep, void* stream) {
  return launch<double, true>(pos, params, log_psi, energy, drift,
                              num_walkers, nop, is_free, is_ideal,
                              defects_sep, stream);
}
