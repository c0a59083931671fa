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
// branch-selected tan/cot per pair (and one log per pair with kLogPsi).
// The per-particle body lives in pair_terms.cuh, which the fused
// diffusion kernel (diffuse.cu) shares.
//
// What bounds it on the H100: FP32 ALU and divide throughput.  Each
// ordered pair costs about 40 flops (minimum image, the rational tan
// x P(x^2)/Q(x^2), one IEEE divide, the kinetic and drift terms) and
// the only memory traffic is N positions in and N + 1 values out per
// walker, so at N = 128 the kernel does ~5,000 flops per byte.
//
// What the design does about it: one CTA per walker, the walker's N
// positions in shared memory (every thread reads the same z_j at the
// same time: a broadcast, no bank conflicts), one thread per particle
// i looping over j with the drift and kinetic sums in registers, and a
// block reduction of the per-particle energy terms (a second one for
// the per-particle log|psi| shares, in the Pallas order).  No pair value
// ever leaves the registers.  Any N up to 1024 (one thread per
// particle), float and double; the free-gas and ideal-gas branches are
// compile-time-uniform flags read once per thread.
//
// The log variant adds per pair the sin/cos polynomials (in place of the
// rational tan) and one logf: about 1.5 times the forward variant's work.
//
// Accuracy: built without --use_fast_math, so tanf/tanhf/rintf/logf and
// the divide are the accurate ones, as in the JAX f32 path.  rint rounds
// half to even like jnp.round.  E_L sums per-particle terms
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* warp_sums = reinterpret_cast<T*>(smem_raw);  // 32 entries
  T* log_sums = warp_sums + 32;                   // 32 entries
  T* zs = log_sums + 32;                          // nop positions

  const size_t walker = blockIdx.x;
  const T* zw = pos + walker * nop;
  for (int k = threadIdx.x; k < nop; k += blockDim.x) zs[k] = zw[k];
  __syncthreads();

  const int i = threadIdx.x;
  T term = 0, log_i = 0;
  if (i < nop) {
    T drift_i;
    qmc::particle_terms<T, kLogPsi>(zs, nop, i, params, is_free, is_ideal,
                                    defects_sep, &drift_i, &term, &log_i);
    drift[walker * nop + i] = drift_i;
  }

  const T total = qmc::block_sum(term, warp_sums);
  if (threadIdx.x == 0) energy[walker] = total;
  if (kLogPsi) {
    const T log_total = qmc::block_sum(log_i, log_sums);
    if (threadIdx.x == 0) log_psi[walker] = log_total;
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
  const size_t smem = (64 + static_cast<size_t>(nop)) * sizeof(T);
  pair_energy_drift_kernel<T, kLogPsi>
      <<<num_walkers, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
