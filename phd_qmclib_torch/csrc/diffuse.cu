// Fused DMC diffusion step: noise, drift move, recast, local energy and
// drift of the moved walker, and the branching weight, in one pass.
//
// Replaces the Pallas TPU kernel phd_qmclib_tpu/ops/pairwise.py::
// _diffuse_kernel (wrapper diffuse_energy_drift_pallas).  For walker w and
// particle i, with the cloned parents (cpos, cdrift, cenergy):
//   xi_wi  = the Philox normal of element w N + i for (seed, step), or
//            the injected xi when one is given;
//   z'_wi  = recast(cpos_wi + 2 cdrift_wi dt + sigma xi_wi) into [0, L);
//   E'_w, F'_wi = K1 (forward) at z'_w;
//   weight_w = exp(-dt ((E'_w + cenergy_w) / 2 - E_ref)).
// The TPU kernel draws its noise from the chip's hardware generator and
// recasts with z - L floor(z / L); this one draws the normals kernel's
// stream (philox.cuh: the same words and normals as prng.cu) and recasts
// with the floor modulo of torch.remainder, as the torch step does.
//
// What bounds it on the H100: K1's pair terms (FP32 instruction issue,
// see pairwise.cu); the noise costs one Philox call and one Box-Muller
// per particle, and the memory traffic is 3 N + 1 values in and 2 N + 2
// out per walker.
//
// What the design does about it: one CTA per walker as in K1, one thread
// per particle.  Each thread draws its own normal, recomputing the whole
// Philox quad of its element (four neighbouring elements share a quad,
// also across walkers when N is not a multiple of 4), moves and recasts
// its particle straight into shared memory, and then runs K1's body
// (pair_terms.cuh: each unordered pair once) on the moved walker; thread 0
// forms the weight after the energy reduction.  No intermediate touches
// device memory.
//
// The move, the recast and the weight are written with round-to-nearest
// intrinsics (no fma contraction) in the torch step's order,
// ((cpos + (2 cdrift) dt) + sigma xi), so that with the same xi the moved
// positions equal the DMC step's (samplers/dmc.py, Sampling.diffuse) on
// the card bit for bit.
// E_ref is a 0-d device tensor read through a pointer: no host sync.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_terms.cuh"
#include "philox.cuh"

namespace {

using qmc::kMaxThreads;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }

// torch.remainder(z, L): the floor modulo from fmod.
template <typename T>
__device__ __forceinline__ T floor_mod(T z, T L) {
  T m = qmc::d_fmod(z, L);
  if (m != T(0) && ((L < T(0)) != (m < T(0)))) m += L;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
diffuse_kernel(const T* __restrict__ cpos, const T* __restrict__ cdrift,
               const T* __restrict__ cenergy, const T* __restrict__ params,
               const T* __restrict__ xi, const T* __restrict__ e_ref, T dt,
               T sigma, uint32_t k0, uint32_t k1, uint32_t s0, uint32_t s1,
               T* __restrict__ npos, T* __restrict__ nenergy,
               T* __restrict__ ndrift, T* __restrict__ nweight, int nop,
               int is_free, int is_ideal, int defects_sep) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const qmc::WalkerSmem<T> smem(smem_raw);  // positions: the moved ones

  const size_t walker = blockIdx.x;
  const int i = threadIdx.x;
  const size_t e = walker * nop + i;
  T z = 0;
  if (i < nop) {
    const T noise = xi != nullptr
                        ? xi[e]
                        : static_cast<T>(qmc::philox_normal(e, k0, k1, s0, s1));
    const T moved = add_rn(add_rn(cpos[e], mul_rn(mul_rn(T(2), cdrift[e]), dt)),
                           mul_rn(sigma, noise));
    z = add_rn(T(0), floor_mod(moved, params[qmc::P_L]));
    npos[e] = z;
  }
  smem.slots[i] = {z, T(0), T(0), T(0)};
  __syncthreads();

  T drift_i, sums[1];
  qmc::walker_terms<T, false>(smem.slots, nop, z, params, is_free,
                              is_ideal, defects_sep, &drift_i, &sums[0],
                              nullptr);
  if (i < nop) ndrift[e] = drift_i;
  qmc::block_sums(sums, smem.warp_sums);
  const T energy = sums[0];
  if (threadIdx.x == 0) {
    nenergy[walker] = energy;
    const T mean = mul_rn(T(0.5), add_rn(energy, cenergy[walker]));
    nweight[walker] = d_exp(mul_rn(-dt, sub_rn(mean, e_ref[0])));
  }
}

template <typename T>
int launch(const void* cpos, const void* cdrift, const void* cenergy,
           const void* params, const void* xi, const void* e_ref, double dt,
           double sigma, unsigned long long key, unsigned long long step,
           void* npos, void* nenergy, void* ndrift, void* nweight,
           int num_walkers, int nop, int is_free, int is_ideal,
           int defects_sep, void* stream) {
  if (num_walkers <= 0 || nop <= 0 || nop > kMaxThreads ||
      defects_sep < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((nop + 31) / 32) * 32;
  diffuse_kernel<T>
      <<<num_walkers, threads, qmc::WalkerSmem<T>::bytes(threads),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(cpos), static_cast<const T*>(cdrift),
          static_cast<const T*>(cenergy), static_cast<const T*>(params),
          static_cast<const T*>(xi), static_cast<const T*>(e_ref),
          static_cast<T>(dt), static_cast<T>(sigma),
          static_cast<uint32_t>(key), static_cast<uint32_t>(key >> 32),
          static_cast<uint32_t>(step), static_cast<uint32_t>(step >> 32),
          static_cast<T*>(npos), static_cast<T*>(nenergy),
          static_cast<T*>(ndrift), static_cast<T*>(nweight), nop, is_free,
          is_ideal, defects_sep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_diffuse_energy_drift_f32(
    const void* cpos, const void* cdrift, const void* cenergy,
    const void* params, const void* xi, const void* e_ref, double dt,
    double sigma, unsigned long long key, unsigned long long step,
    void* npos, void* nenergy, void* ndrift, void* nweight, int num_walkers,
    int nop, int is_free, int is_ideal, int defects_sep, void* stream) {
  return launch<float>(cpos, cdrift, cenergy, params, xi, e_ref, dt, sigma,
                       key, step, npos, nenergy, ndrift, nweight, num_walkers,
                       nop, is_free, is_ideal, defects_sep, stream);
}

extern "C" int qmc_diffuse_energy_drift_f64(
    const void* cpos, const void* cdrift, const void* cenergy,
    const void* params, const void* xi, const void* e_ref, double dt,
    double sigma, unsigned long long key, unsigned long long step,
    void* npos, void* nenergy, void* ndrift, void* nweight, int num_walkers,
    int nop, int is_free, int is_ideal, int defects_sep, void* stream) {
  return launch<double>(cpos, cdrift, cenergy, params, xi, e_ref, dt, sigma,
                        key, step, npos, nenergy, ndrift, nweight, num_walkers,
                        nop, is_free, is_ideal, defects_sep, stream);
}
