// Fused Bijl-Jastrow local energy and drift for the mrbp model.
//
// Replaces the Pallas TPU kernel phd_qmclib_tpu/ops/pairwise.py::_kernel
// (wrapper energy_and_drift_pallas, forward variant without log|psi|).
// For every walker it computes the one-body Kronig-Penney terms (orbital
// log-derivative, kinetic, barrier/defect potential) and the O(N^2)
// minimum-image phonon pair block, one branch-selected tan/cot per pair,
// and returns E_L (W,) and the drift (W, N).
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
// block reduction of the per-particle energy terms.  No pair value
// ever leaves the registers.  Any N up to 1024 (one thread per
// particle), float and double; the free-gas and ideal-gas branches are
// compile-time-uniform flags read once per thread.
//
// Accuracy: built without --use_fast_math, so tanf/tanhf/rintf and the
// divide are the accurate ones, as in the JAX f32 path.  rint rounds
// half to even like jnp.round.  E_L sums per-particle terms
// (kin_i - drift_i^2 + pot_i) before the block reduction, the order of
// the Pallas kernel and of the plain torch version: the kinetic and
// drift^2 sums are each large against E_L and cancel.
#include <cuda_runtime.h>
#include <math.h>

namespace {

enum {
  P_V0, P_E0, P_K1, P_KP1, P_ZA, P_ZB, P_L, P_RM, P_K2, P_BETA, P_ROFF,
  P_AM, P_V0D, P_V0M
};

constexpr int kMaxThreads = 1024;
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ float d_rint(float x) { return rintf(x); }
__device__ __forceinline__ double d_rint(double x) { return rint(x); }
__device__ __forceinline__ float d_floor(float x) { return floorf(x); }
__device__ __forceinline__ double d_floor(double x) { return floor(x); }
__device__ __forceinline__ float d_fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_fabs(double x) { return fabs(x); }
__device__ __forceinline__ float d_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double d_fmod(double x, double y) { return fmod(x, y); }
__device__ __forceinline__ float d_tan(float x) { return tanf(x); }
__device__ __forceinline__ double d_tan(double x) { return tan(x); }
__device__ __forceinline__ float d_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double d_tanh(double x) { return tanh(x); }

// (s, c) with tan(x) = s / c on (-pi/2, pi/2].  float: the order-13
// continued-fraction rational x P(x^2) / Q(x^2) of ops/trig.py
// (TAN_P_COEFFS, TAN_Q_COEFFS); double: the library sin and cos.
__device__ __forceinline__ void tan_ratio(float x, float* s, float* c) {
  const float z2 = x * x;
  float p = -7.4000074000074000e-06f;
  p = p * z2 + 2.7972027972027972e-03f;
  p = p * z2 + -0.12820512820512820f;
  p = p * z2 + 1.0f;
  float q = -2.0720020720020720e-04f;
  q = q * z2 + 2.3310023310023310e-02f;
  q = q * z2 + -0.46153846153846154f;
  q = q * z2 + 1.0f;
  *s = x * p;
  *c = q;
}
__device__ __forceinline__ void tan_ratio(double x, double* s, double* c) {
  sincos(x, s, c);
}

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  T total = 0;
  if (warp == 0) {
    const int num_warps = blockDim.x >> 5;
    total = lane < num_warps ? warp_sums[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_down_sync(0xffffffffu, total, off);
    }
  }
  return total;  // valid in thread 0
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pair_energy_drift_kernel(const T* __restrict__ pos,
                         const T* __restrict__ params,
                         T* __restrict__ energy, T* __restrict__ drift,
                         int nop, int is_free, int is_ideal,
                         int defects_sep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* warp_sums = reinterpret_cast<T*>(smem_raw);  // 32 entries
  T* zs = warp_sums + 32;                         // nop positions

  const size_t walker = blockIdx.x;
  const T* zw = pos + walker * nop;
  for (int k = threadIdx.x; k < nop; k += blockDim.x) zs[k] = zw[k];
  __syncthreads();

  const int i = threadIdx.x;
  T term = 0;
  if (i < nop) {
    const T zi = zs[i];
    T drift_i = 0, kin_i = 0, pot_i = 0;

    if (!is_free) {
      const T v0 = params[P_V0], e0 = params[P_E0];
      const T k1 = params[P_K1], kp1 = params[P_KP1];
      const T z_a = params[P_ZA], z_b = params[P_ZB];
      const T n_cell = d_floor(zi);
      const T z_cell = zi - n_cell;
      const bool in_barrier = z_a < z_cell;
      const T ob_ldz =
          in_barrier ? kp1 * d_tanh(kp1 * (z_cell - T(1) + T(0.5) * z_b))
                     : -k1 * d_tan(k1 * (z_cell - T(0.5) * z_a));
      const T ob_d2 = in_barrier ? v0 - e0 : -e0;
      T barrier_v = params[P_V0D];
      if (defects_sep != 1 && d_fmod(n_cell, T(defects_sep)) != T(0)) {
        barrier_v = params[P_V0M];
      }
      pot_i = in_barrier ? barrier_v : T(0);
      drift_i = ob_ldz;
      kin_i = -ob_d2 + ob_ldz * ob_ldz;
    }

    if (!is_ideal) {
      const T L = params[P_L], inv_l = T(1) / L, rm = params[P_RM];
      const T k2 = params[P_K2], beta = params[P_BETA];
      const T r_off = params[P_ROFF];
      const T pref = T(kPi) / L;
      const T in_b = -k2 * r_off;
      const T out_ldz = pref * beta, out_kin = pref * pref * beta;
      const T in_kin = k2 * k2;
      T drift_pair = 0, kin_pair = 0;
      for (int j = 0; j < nop; ++j) {
        if (j == i) continue;
        T d = zi - zs[j];
        d = d - L * d_rint(d * inv_l);
        const T r = d_fabs(d);
        const bool in_cut = r < rm;
        const T arg = in_cut ? k2 * r + in_b : pref * r;
        T s, c;
        tan_ratio(arg, &s, &c);
        // tan inside the cutoff, cot outside: one divide per pair.
        const T v = (in_cut ? s : c) / (in_cut ? c : s);
        const T ldz = (in_cut ? -k2 : out_ldz) * v;
        kin_pair += (in_cut ? in_kin : out_kin) * (T(1) + v * v);
        drift_pair += d >= T(0) ? ldz : -ldz;
      }
      drift_i += drift_pair;
      kin_i += kin_pair;
    }

    drift[walker * nop + i] = drift_i;
    term = kin_i - drift_i * drift_i + pot_i;
  }

  const T total = block_sum(term, warp_sums);
  if (threadIdx.x == 0) energy[walker] = total;
}

template <typename T>
int launch(const void* pos, const void* params, void* energy, void* drift,
           int num_walkers, int nop, int is_free, int is_ideal,
           int defects_sep, void* stream) {
  if (num_walkers <= 0 || nop <= 0 || nop > kMaxThreads ||
      defects_sep < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((nop + 31) / 32) * 32;
  const size_t smem = (32 + static_cast<size_t>(nop)) * sizeof(T);
  pair_energy_drift_kernel<T>
      <<<num_walkers, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pos), static_cast<const T*>(params),
          static_cast<T*>(energy), static_cast<T*>(drift), nop, is_free,
          is_ideal, defects_sep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_pair_energy_drift_f32(const void* pos, const void* params,
                                         void* energy, void* drift,
                                         int num_walkers, int nop,
                                         int is_free, int is_ideal,
                                         int defects_sep, void* stream) {
  return launch<float>(pos, params, energy, drift, num_walkers, nop,
                       is_free, is_ideal, defects_sep, stream);
}

extern "C" int qmc_pair_energy_drift_f64(const void* pos, const void* params,
                                         void* energy, void* drift,
                                         int num_walkers, int nop,
                                         int is_free, int is_ideal,
                                         int defects_sep, void* stream) {
  return launch<double>(pos, params, energy, drift, num_walkers, nop,
                        is_free, is_ideal, defects_sep, stream);
}
