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
// What bounds it on the H100: FP32 instruction issue in the pair loop, as
// for K1 (pairwise.cu).  The noise is one Philox quad and two Box-Mullers
// per four elements, and the memory traffic is 3 N + 1 values in and
// 2 N + 2 out per walker (~45 MB at 17408 x 128, ~13 us at HBM rate),
// so the tensor cores, TMA and asynchronous copies have nothing to take.
//
// What held the first design back (K1's former body, reached from here;
// its SASS): 44 instructions a pair, of them both cutoff branches'
// selects on every pair, a ring index with a wrap test, a read-modify-write
// of the partner's 16-byte shared-memory slot and a block barrier per ring
// step (63 a walker at N = 128); and the noise drawn once per element,
// each thread running the whole Philox quad of its element and both
// Box-Muller paths (the warp diverges on e & 3).
//
// What this design does about it: one CTA per walker, one thread per
// particle, and K1's body (pair_terms.cuh::walker_terms) at the moved
// positions: the pair loop first written here for this kernel, which K1
// and K1 log now share (the positions twice over in shared memory, a
// warp vote per step with a select-free fast body outside the cutoff, the
// kinetic terms on the taker's side, the drift's j sides in 4 rings and a
// barrier every 4 steps; pair_terms.cuh says more).  Besides:
//   * the noise once per quad: thread t of the walker draws the t-th
//     Philox quad covering its elements and both Box-Mullers of it into
//     shared memory (quads that straddle two walkers are drawn by both);
//     the key schedule is a kernel parameter, read from the constant bank;
//   * instantiations by block size (128, 256, 1024 threads), launch
//     bounds of 64 registers (float uses ~40, double 64), and the rings
//     by block size (ring_buffers).
// The pair positions are into_supercell of the moved ones and the one-body
// terms take the moved positions, as K1 at the moved walker does: with
// the same loop the energy and drift are K1's there.
// What was tried and dropped for the pair loop: pair_terms.cuh.
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

// The kernel's shared memory: walker_terms's (qmc::WalkerSmem, one sum),
// then a normal per thread.
template <typename T>
size_t diffuse_smem_bytes(int buffers, int nop, int threads) {
  return qmc::WalkerSmem<T, 1>::bytes(buffers, nop) +
         static_cast<size_t>(threads) * sizeof(float);
}

// CTAs of kThreads that the launch bounds keep resident on an SM: 64
// registers a thread, float and double.
constexpr int diffuse_min_ctas(int threads) { return 1024 / threads; }

// One CTA per walker, thread i < nop is particle i; kThreads is the block
// size's bound (128, 256 or 1024), blockDim.x = nop rounded up to a warp.
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, diffuse_min_ctas(kThreads))
diffuse_kernel(const T* __restrict__ cpos, const T* __restrict__ cdrift,
               const T* __restrict__ cenergy, const T* __restrict__ params,
               const T* __restrict__ xi, const T* __restrict__ e_ref, T dt,
               T sigma, const qmc::PhiloxKeys keys, uint32_t s0, uint32_t s1,
               T* __restrict__ npos, T* __restrict__ nenergy,
               T* __restrict__ ndrift, T* __restrict__ nweight, int nop,
               int is_free, int is_ideal, int defects_sep) {
  constexpr int kBuffers = qmc::ring_buffers<T>(kThreads);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const qmc::WalkerSmem<T, 1> smem(smem_raw, kBuffers, qmc::ring_len(nop));
  float* const noise = reinterpret_cast<float*>(smem.end());

  const size_t walker = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < nop;
  const size_t base = walker * nop;
  // The box length read once for every thread, before the move: read
  // only inside the move's branch, it was loaded a second time for
  // walker_terms's wrap, and the kernel was 1.4-1.7% slower at
  // 17408 x 128.
  const T length = params[qmc::P_L];

  if (xi == nullptr) {
    // Thread t draws quad base / 4 + t; the walker's elements start at
    // element off of the first quad.
    const int off = static_cast<int>(base & 3);
    if (i < (off + nop + 3) >> 2) {
      const unsigned long long q = (base >> 2) + i;
      const uint4 w = qmc::philox4x32_10(static_cast<uint32_t>(q),
                                         static_cast<uint32_t>(q >> 32), s0,
                                         s1, keys);
      float z[4];
      qmc::box_muller(w.x, w.y, &z[0], &z[1]);
      qmc::box_muller(w.z, w.w, &z[2], &z[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int local = 4 * i + k - off;
        if (local >= 0 && local < nop) noise[local] = z[k];
      }
    }
    __syncthreads();
  }

  T z_move = 0;
  if (active) {
    const size_t e = base + i;
    const T n = xi != nullptr ? xi[e] : static_cast<T>(noise[i]);
    const T moved = add_rn(add_rn(cpos[e], mul_rn(mul_rn(T(2), cdrift[e]), dt)),
                           mul_rn(sigma, n));
    z_move = add_rn(T(0), floor_mod(moved, length));
    npos[e] = z_move;
  }

  // K1 at the moved walker: the pair loop on z_move wrapped into [0, L),
  // the one-body terms at z_move.
  T drift_i, term, unused;
  qmc::walker_terms<T, false, kBuffers, 1>(smem, nop, z_move, params, is_free,
                                        is_ideal, defects_sep, &drift_i,
                                        &term, &unused);
  if (active) ndrift[base + i] = drift_i;
  T sums[1] = {term};
  qmc::block_sums(sums, smem.warp_sums);
  if (threadIdx.x == 0) {
    const T energy = sums[0];
    nenergy[walker] = energy;
    const T mean = mul_rn(T(0.5), add_rn(energy, cenergy[walker]));
    nweight[walker] = d_exp(mul_rn(-dt, sub_rn(mean, e_ref[0])));
  }
}

template <typename T, int kThreads>
void launch_diffuse(const void* cpos, const void* cdrift, const void* cenergy,
                    const void* params, const void* xi, const void* e_ref,
                    double dt, double sigma, const qmc::PhiloxKeys& keys,
                    unsigned long long step, void* npos, void* nenergy,
                    void* ndrift, void* nweight, int num_walkers, int nop,
                    int is_free, int is_ideal, int defects_sep, int threads,
                    cudaStream_t stream) {
  diffuse_kernel<T, kThreads><<<
      num_walkers, threads,
      diffuse_smem_bytes<T>(qmc::ring_buffers<T>(kThreads), nop, threads),
      stream>>>(
          static_cast<const T*>(cpos), static_cast<const T*>(cdrift),
          static_cast<const T*>(cenergy), static_cast<const T*>(params),
          static_cast<const T*>(xi), static_cast<const T*>(e_ref),
          static_cast<T>(dt), static_cast<T>(sigma), keys,
          static_cast<uint32_t>(step), static_cast<uint32_t>(step >> 32),
          static_cast<T*>(npos), static_cast<T*>(nenergy),
          static_cast<T*>(ndrift), static_cast<T*>(nweight), nop, is_free,
          is_ideal, defects_sep);
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
  const qmc::PhiloxKeys keys(static_cast<uint32_t>(key),
                             static_cast<uint32_t>(key >> 32));
  // The instantiation by block size: the registers a small block can have.
  auto* run = threads <= 128   ? launch_diffuse<T, 128>
              : threads <= 256 ? launch_diffuse<T, 256>
                               : launch_diffuse<T, kMaxThreads>;
  run(cpos, cdrift, cenergy, params, xi, e_ref, dt, sigma, keys, step,
         npos, nenergy, ndrift, nweight, num_walkers, nop, is_free, is_ideal,
         defects_sep, threads, static_cast<cudaStream_t>(stream));
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
