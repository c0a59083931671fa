// The per-particle body of the fused Bijl-Jastrow local energy, drift and
// log|psi| (K1), shared by the pair kernel (pairwise.cu) and the fused
// diffusion kernel (diffuse.cu).
//
// For particle i of a walker whose positions zs[0..nop) sit in shared
// memory, particle_terms computes the one-body Kronig-Penney terms and
// loops over the O(N) minimum-image pairs (i, j), j != i, with one
// branch-selected trig evaluation, one divide and (with kLogPsi) one log
// per pair.  It returns the particle's drift F_i, its energy term
// kin_i - F_i^2 + pot_i, and with kLogPsi its log|psi| share
// log|f1(z_i)| + 1/2 sum_j log|f2(r_ij)|; the caller reduces the terms
// over the particles.
//
// The pair kinetic term is C (1 + v^2) in both variants, with v the tan
// inside the contact cutoff and the cot outside, so the forward and the
// log variant give the same E_L (in f64 bit for bit).  float evaluates
// (s, c) with the rational tan of ops/trig.py (forward: only the ratio is
// needed) or the sin/cos polynomials (log: the factors are needed too);
// double the library sincos.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "trig.cuh"

namespace qmc {

// Slots of ops/pairwise.py::pack_params.
enum {
  P_V0, P_E0, P_K1, P_KP1, P_ZA, P_ZB, P_L, P_RM, P_K2, P_BETA, P_ROFF,
  P_AM, P_V0D, P_V0M, P_CF
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
__device__ __forceinline__ float d_cos(float x) { return cosf(x); }
__device__ __forceinline__ double d_cos(double x) { return cos(x); }
__device__ __forceinline__ float d_cosh(float x) { return coshf(x); }
__device__ __forceinline__ double d_cosh(double x) { return cosh(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }

// (s, c) with tan(x) = s / c on (-pi/2, pi/2].  kFactors: s and c are
// sin x and cos x themselves (the log variant needs them); otherwise only
// their ratio is exact.  float: the order-13 continued-fraction rational
// x P(x^2) / Q(x^2) (TAN_P_COEFFS, TAN_Q_COEFFS), or the quarter-wave
// polynomials of trig.cuh; double: the library sin and cos either way.
template <bool kFactors>
__device__ __forceinline__ void trig_pair(float x, float* s, float* c) {
  if (kFactors) {
    *s = sin_poly(x);
    *c = cos_poly(x);
  } else {
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
}
template <bool kFactors>
__device__ __forceinline__ void trig_pair(double x, double* s, double* c) {
  sincos(x, s, c);
}

// Sum of v over the block; valid in thread 0.  warp_sums holds 32
// entries of shared memory of its own.
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
  return total;
}

// K1's terms of particle i < nop; see the top of this file.  log_i is
// written only with kLogPsi.
template <typename T, bool kLogPsi>
__device__ __forceinline__ void particle_terms(
    const T* zs, int nop, int i, const T* __restrict__ params, int is_free,
    int is_ideal, int defects_sep, T* drift_out, T* term_out, T* log_out) {
  const T zi = zs[i];
  T drift_i = 0, kin_i = 0, pot_i = 0, log_i = 0;

  if (!is_free) {
    const T v0 = params[P_V0], e0 = params[P_E0];
    const T k1 = params[P_K1], kp1 = params[P_KP1];
    const T z_a = params[P_ZA], z_b = params[P_ZB];
    const T n_cell = d_floor(zi);
    const T z_cell = zi - n_cell;
    const bool in_barrier = z_a < z_cell;
    const T arg_b = kp1 * (z_cell - T(1) + T(0.5) * z_b);
    const T arg_w = k1 * (z_cell - T(0.5) * z_a);
    const T ob_ldz = in_barrier ? kp1 * d_tanh(arg_b) : -k1 * d_tan(arg_w);
    const T ob_d2 = in_barrier ? v0 - e0 : -e0;
    T barrier_v = params[P_V0D];
    if (defects_sep != 1 && d_fmod(n_cell, T(defects_sep)) != T(0)) {
      barrier_v = params[P_V0M];
    }
    pot_i = in_barrier ? barrier_v : T(0);
    drift_i = ob_ldz;
    kin_i = -ob_d2 + ob_ldz * ob_ldz;
    if (kLogPsi) {
      // f1: cosh in the barrier, cf cos in the well (cf packed once).
      const T f1 = in_barrier ? d_cosh(arg_b) : params[P_CF] * d_cos(arg_w);
      log_i = d_log(d_fabs(f1));
    }
  }

  if (!is_ideal) {
    const T L = params[P_L], inv_l = T(1) / L, rm = params[P_RM];
    const T k2 = params[P_K2], beta = params[P_BETA];
    const T r_off = params[P_ROFF];
    const T pref = T(kPi) / L;
    const T in_b = -k2 * r_off;
    const T out_ldz = pref * beta, out_kin = pref * pref * beta;
    const T in_kin = k2 * k2;
    const T abs_am = d_fabs(params[P_AM]);
    T drift_pair = 0, kin_pair = 0, log_pair = 0;
    for (int j = 0; j < nop; ++j) {
      if (j == i) continue;
      T d = zi - zs[j];
      d = d - L * d_rint(d * inv_l);
      const T r = d_fabs(d);
      const bool in_cut = r < rm;
      const T arg = in_cut ? k2 * r + in_b : pref * r;
      T s, c;
      trig_pair<kLogPsi>(arg, &s, &c);
      // tan inside the cutoff, cot outside: one divide per pair.
      const T v = (in_cut ? s : c) / (in_cut ? c : s);
      const T ldz = (in_cut ? -k2 : out_ldz) * v;
      kin_pair += (in_cut ? in_kin : out_kin) * (T(1) + v * v);
      drift_pair += d >= T(0) ? ldz : -ldz;
      if (kLogPsi) {
        // log|f2| = p log(x): x = |am| cos, p = 1 inside; x = sin,
        // p = beta outside.  Both bases are positive on the argument's
        // domain.
        const T lg = d_log(in_cut ? abs_am * c : s);
        log_pair += in_cut ? lg : beta * lg;
      }
    }
    drift_i += drift_pair;
    kin_i += kin_pair;
    log_i += T(0.5) * log_pair;
  }

  *drift_out = drift_i;
  *term_out = kin_i - drift_i * drift_i + pot_i;
  if (kLogPsi) *log_out = log_i;
}

}  // namespace qmc
