// The body of K1, the fused Bijl-Jastrow local energy, drift and log|psi|,
// shared by the pair kernel (pairwise.cu) and the fused diffusion kernel
// (diffuse.cu).  One CTA holds one walker: thread i < nop is particle i.
//
// walker_terms computes, for every particle of the walker whose positions
// sit in shared memory, the one-body Kronig-Penney terms and the
// minimum-image phonon pair terms.  It returns the particle's drift F_i,
// its energy term kin_i - F_i^2 + pot_i and with kLogPsi its log|psi|
// share; the caller reduces the terms over the block (block_sums).
//
// Each unordered pair is evaluated once, on a half ring: at step
// k = 1 .. (nop - 1) / 2 thread i takes j = (i + k) mod nop, and for an
// even nop a last step pairs i < nop / 2 with i + nop / 2.  The pair terms
// depend on r = |d| only: the kinetic term and log|f2| are even in d, the
// drift term odd.  Thread i keeps its own sums in registers and adds the
// j side (the drift term negated, the same kinetic term) to particle j's
// slot in shared memory, which also holds z_j.  At each step the partners
// form a permutation, so no two threads touch one slot, and a barrier
// ends the step.
// Particle i's drift is complete (its own sums plus its slot, in that
// fixed order) before it is squared, and the order of every addition is
// fixed, so the forward and the log variant give the same energy and
// drift (in double bit for bit: acc_add, acc_mul).
//
// The pair kinetic term is C (1 + v^2) in both variants, with v the tan
// inside the contact cutoff and the cot outside.  float evaluates (s, c)
// with the rational tan of ops/trig.py (forward: only the ratio is
// needed) or the sin/cos polynomials (log: the factors are needed too),
// v with the approximate reciprocal, and log|f2| with the approximate
// log2; double keeps the library sincos, the IEEE divide and log.
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
__device__ __forceinline__ float d_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double d_fma(double a, double b, double c) { return fma(a, b, c); }

// The products and sums of the energy and drift: float lets the compiler
// fuse a product into the next addition, double rounds each on its own,
// so that the forward and the log variant, compiled apart, give the same
// bits.
__device__ __forceinline__ float acc_mul(float a, float b) { return a * b; }
__device__ __forceinline__ double acc_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float acc_add(float a, float b) { return a + b; }
__device__ __forceinline__ double acc_add(double a, double b) { return __dadd_rn(a, b); }

// a / b: float with rcp.approx (MUFU.RCP, relative error below 2^-23)
// and one multiply; double with the IEEE divide.
__device__ __forceinline__ float pair_ratio(float a, float b) {
  float inv;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(b));
  return a * inv;
}
__device__ __forceinline__ double pair_ratio(double a, double b) {
  return a / b;
}

// The pair log in units of pair_log_unit: float log2 with lg2.approx
// (MUFU.LG2, absolute error below 2^-22), double the natural log.
__device__ __forceinline__ float pair_log(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double pair_log(double x) { return log(x); }
__device__ __forceinline__ float pair_log_unit(float) {
  return 0.693147180559945309f;  // ln 2
}
__device__ __forceinline__ double pair_log_unit(double) { return 1.0; }

// The order-13 continued-fraction rational tan x = x P(x^2) / Q(x^2)
// (ops/trig.py's TAN_P_COEFFS, TAN_Q_COEFFS): P's and Q's coefficients
// of x^2, x^4 and x^6 (both start at 1).
constexpr float kTanP1 = -0.12820512820512820f;
constexpr float kTanP2 = 2.7972027972027972e-03f;
constexpr float kTanP3 = -7.4000074000074000e-06f;
constexpr float kTanQ1 = -0.46153846153846154f;
constexpr float kTanQ2 = 2.3310023310023310e-02f;
constexpr float kTanQ3 = -2.0720020720020720e-04f;

// (s, c) with tan(x) = s / c on (-pi/2, pi/2].  kFactors: s and c are
// sin x and cos x themselves (the log variant needs them); otherwise only
// their ratio is exact.  float: the rational tan above, or the
// quarter-wave polynomials of trig.cuh; double: the library sin and cos
// either way.
template <bool kFactors>
__device__ __forceinline__ void trig_pair(float x, float* s, float* c) {
  if (kFactors) {
    *s = sin_poly(x);
    *c = cos_poly(x);
  } else {
    const float z2 = x * x;
    float p = kTanP3;
    p = p * z2 + kTanP2;
    p = p * z2 + kTanP1;
    p = p * z2 + 1.0f;
    float q = kTanQ3;
    q = q * z2 + kTanQ2;
    q = q * z2 + kTanQ1;
    q = q * z2 + 1.0f;
    *s = x * p;
    *c = q;
  }
}
template <bool kFactors>
__device__ __forceinline__ void trig_pair(double x, double* s, double* c) {
  sincos(x, s, c);
}

// One particle's slot in shared memory: its position in [0, L) and the
// j-side sums of its drift and kinetic terms, together, so that one
// access reads all three (16 bytes in float).
template <typename T>
struct alignas(4 * sizeof(T)) Slot {
  T z, unused, drift, kin;
};

// The shared memory of one walker's CTA: 64 reduction slots, then one
// Slot per thread (threads past nop pad).
template <typename T>
struct WalkerSmem {
  T* warp_sums;
  Slot<T>* slots;

  __device__ explicit WalkerSmem(unsigned char* raw)
      : warp_sums(reinterpret_cast<T*>(raw)),
        slots(reinterpret_cast<Slot<T>*>(warp_sums + 64)) {}

  static size_t bytes(int threads) {
    return 64 * sizeof(T) + static_cast<size_t>(threads) * sizeof(Slot<T>);
  }
};

// z in [0, L), where the pair terms' compare-and-select minimum image
// needs it.  The positions the samplers keep are recast there after
// every move and pass unchanged; any other is wrapped once here.
template <typename T>
__device__ __forceinline__ T into_supercell(T z, T L) {
  return (z >= T(0) && z < L) ? z : z - L * d_floor(z / L);
}

// Sums of v[0 .. kCount) over the block, valid in thread 0 (one barrier
// for all of them).  warp_sums holds 32 * kCount entries of its own.
template <typename T, int kCount>
__device__ __forceinline__ void block_sums(T (&v)[kCount], T* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    for (int n = 0; n < kCount; ++n) {
      v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
    }
  }
  if (lane == 0) {
    for (int n = 0; n < kCount; ++n) warp_sums[32 * n + warp] = v[n];
  }
  __syncthreads();
  if (warp == 0) {
    const int num_warps = blockDim.x >> 5;
    for (int n = 0; n < kCount; ++n) {
      v[n] = lane < num_warps ? warp_sums[32 * n + lane] : T(0);
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int n = 0; n < kCount; ++n) {
        v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
      }
    }
  }
}

// The pair constants, read once per thread.
template <typename T>
struct PairParams {
  T L, half_l, rm, k2, neg_k2, in_b, pref, out_ldz, out_kin, in_kin,
      abs_am, beta;

  __device__ explicit PairParams(const T* __restrict__ p)
      : L(p[P_L]),
        half_l(T(0.5) * p[P_L]),
        rm(p[P_RM]),
        k2(p[P_K2]),
        neg_k2(-p[P_K2]),
        in_b(-p[P_K2] * p[P_ROFF]),
        pref(T(kPi) / p[P_L]),
        out_ldz(pref * p[P_BETA]),
        out_kin(pref * pref * p[P_BETA]),
        in_kin(p[P_K2] * p[P_K2]),
        abs_am(d_fabs(p[P_AM])),
        beta(p[P_BETA]) {}
};

// The terms of one unordered pair at d = z_i - z_j in [-L, L]: the drift
// terms *fi of particle i and *fj of particle j, the kinetic term *kin of
// each, and with kLogPsi log|f2| = p log(x) in units of pair_log_unit
// (x = |am| cos, p = 1 inside the cutoff; x = sin, p = beta outside; both
// bases are positive on the argument's domain).
//
// The minimum image by compare and select: r = |d|, or L - |d| past L/2
// (the image across the boundary).  The imaged z_i - z_j is >= 0 unless
// exactly one of d < 0 and the wrap holds, z_j - z_i likewise with d > 0:
// *fj = -*fi, but coincident particles (d = 0) both take +ldz, as
// sign(0) = +1 in the plain version.  At |d| = L/2 nothing wraps, as with
// round-half-to-even; the cot is 0 there.
template <typename T, bool kLogPsi>
__device__ __forceinline__ void pair_terms(T d, const PairParams<T>& c,
                                           T* fi, T* fj, T* kin, T* lg) {
  const T ad = d_fabs(d);
  const bool wrap = ad > c.half_l;
  const T r = wrap ? c.L - ad : ad;
  const bool in_cut = r < c.rm;
  const T arg = d_fma(in_cut ? c.k2 : c.pref, r, in_cut ? c.in_b : T(0));
  T s, co;
  trig_pair<kLogPsi>(arg, &s, &co);
  // tan inside the cutoff, cot outside: one reciprocal per pair.
  const T v = pair_ratio(in_cut ? s : co, in_cut ? co : s);
  const T ldz = acc_mul(in_cut ? c.neg_k2 : c.out_ldz, v);
  *kin = acc_mul(in_cut ? c.in_kin : c.out_kin, d_fma(v, v, T(1)));
  *fi = (d >= T(0)) != wrap ? ldz : -ldz;
  *fj = (d <= T(0)) != wrap ? ldz : -ldz;
  if (kLogPsi) {
    const T lg_x = pair_log(in_cut ? c.abs_am * co : s);
    *lg = in_cut ? lg_x : c.beta * lg_x;
  }
}

// K1's terms of every particle of one walker; see the top of this file.
// Every thread of the block calls it (it holds barriers); thread i < nop
// gets particle i's, the others 0.  slots[0 .. blockDim.x) hold the
// positions in [0, L) (into_supercell; any finite value past nop) and
// zero sums, written before a barrier; zi is particle i's position as
// given, for the one-body terms.  log_out is written only with kLogPsi.
// The threads past nop run the same steps on a ring of their own over
// the padding slots, so the loop holds no branch.
//
// float flops of one unordered pair as written, the subtraction d and the
// sums of both sides included (fma = 2, rcp and lg2 = 1; compares,
// selects and negations not counted): 28, and 40 with kLogPsi (the
// sin/cos polynomials add 8, the log 3 and its sum 1).
template <typename T, bool kLogPsi>
__device__ __forceinline__ void walker_terms(
    Slot<T>* slots, int nop, T zi,
    const T* __restrict__ params, int is_free, int is_ideal,
    int defects_sep, T* drift_out, T* term_out, T* log_out) {
  const int i = threadIdx.x;
  const bool active = i < nop;
  T drift_i = 0, kin_i = 0, pot_i = 0, log_i = 0;

  if (active && !is_free) {
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
    kin_i = d_fma(ob_ldz, ob_ldz, -ob_d2);
    if (kLogPsi) {
      // f1: cosh in the barrier, cf cos in the well (cf packed once).
      const T f1 = in_barrier ? d_cosh(arg_b) : params[P_CF] * d_cos(arg_w);
      log_i = d_log(d_fabs(f1));
    }
  }

  if (!is_ideal) {
    const PairParams<T> c(params);
    const T z_own = slots[i].z;
    T f_sum = 0, kin_sum = 0, log_sum = 0;
    auto add_pair = [&](int j) {
      const Slot<T> other = slots[j];
      T fi, fj, kin, lg;
      pair_terms<T, kLogPsi>(z_own - other.z, c, &fi, &fj, &kin, &lg);
      f_sum = acc_add(f_sum, fi);
      kin_sum = acc_add(kin_sum, kin);
      if (kLogPsi) log_sum += lg;
      slots[j].drift = acc_add(other.drift, fj);
      slots[j].kin = acc_add(other.kin, kin);
    };
    const int half = nop >> 1;
    const int ring_begin = active ? 0 : nop;
    const int ring_end = active ? nop : static_cast<int>(blockDim.x);
    int j = i;
    for (int k = (nop - 1) >> 1; k > 0; --k) {
      if (++j == ring_end) j = ring_begin;
      add_pair(j);
      __syncthreads();
    }
    if (nop == 2 * half && half > 0) {
      if (i < half) add_pair(i + half);
      __syncthreads();
    }
    if (active) {
      const Slot<T> own = slots[i];
      drift_i = acc_add(drift_i, acc_add(f_sum, own.drift));
      kin_i = acc_add(kin_i, acc_add(kin_sum, own.kin));
      if (kLogPsi) log_i += pair_log_unit(T(0)) * log_sum;
    }
  }

  *drift_out = drift_i;
  *term_out = acc_add(d_fma(-drift_i, drift_i, kin_i), pot_i);
  if (kLogPsi) *log_out = log_i;
}

}  // namespace qmc
