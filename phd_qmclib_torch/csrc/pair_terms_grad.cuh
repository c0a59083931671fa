// The body of K1's parameter VJP: the derivatives of one walker's log|psi|
// and local energy with respect to the packed parameters
// (ops/pairwise.py::pack_params), as the log variant of K1 computes them
// (pair_terms.cuh: the same minimum image and branch selection; in float
// the forward variant's rational tan, the approximate reciprocal and
// log2, in double sincos, the IEEE divide and log).
//
// E_L = sum_i (kin_i - F_i^2 + pot_i), with the drift F_i and kin_i the
// sums of the one-body term and of the pair terms of particle i.  For a
// parameter p,
//   dE/dp = sum_i (dkin_i/dp - 2 F_i dF_i/dp + dpot_i/dp).
// An unordered pair (i, j) adds ldz with the sign s_i to F_i and with s_j
// to F_j (s_j = -s_i but for coincident particles) and the same kin to
// kin_i and kin_j, so its share is
//   2 dkin/dp - 2 (s_i F_i + s_j F_j) dldz/dp,
// which needs the forward's drift F but no second pass over the pairs.
// One-body: dE/dp = 2 (ldz1_i - F_i) dldz1_i/dp - dd2_i/dp + dpot_i/dp,
// with ldz1 = f1'/f1 and d2 = f1''/f1.
//
// The pair terms depend on L, k2, r_off, beta and |am|; rm enters only
// through the cutoff mask, so its derivative is 0, as in autograd of the
// plain version.  The one-body terms depend on v0, e0, k1, kp1, z_a, z_b,
// v0d, v0m and (log|psi| only) cf.  With positions in [0, L) the
// derivative in L is that of the minimum image, dr/dL = 1 across the
// boundary, 0 elsewhere, as in the plain version.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "pair_terms.cuh"

namespace qmc {

// The packed vector's length: the rows of the VJP hold one value per slot.
constexpr int kParamsSize = 16;

// One unordered pair's derivatives in one form for both branches.  The
// pair terms are ldz = A v, kin = B t (t = 1 + v^2) and log|f2| =
// P log(base), with v = tan arg, base = cos arg inside the cutoff
// (arg = k2 (r - r_off), A = -k2, B = k2^2, P = 1, plus log|am|) and
// v = cot arg, base = sin arg outside (arg = pi r / L, A = pi/L beta,
// B = (pi/L)^2 beta, P = beta).  With sigma = +1 inside and -1 outside,
// dv/darg = sigma t and dlog(base)/darg = -sigma v, so the pair's share of
// ge dE/dp + glp dlog|psi|/dp for any parameter p is
//   darg/dp G + ge (2 t dB/dp + fs v dA/dp) + glp log(base) dP/dp,
//   G = t (c1 v + c2 fs) - c3 v,  c1 = sigma ge 4B, c2 = sigma ge A,
//                                 c3 = sigma glp P,
// with fs = -2 (s_i F_i + s_j F_j) the factor of dldz in dE.  Per slot:
//   k2 (inside):    (r - r_off) G + ge (4 k2 t - fs v);
//   r_off (inside): -k2 G: sum G;
//   am (inside):    glp / am per pair: the count;
//   beta (outside): ge (2 (pi/L)^2 t + pi/L fs v) + glp log sin arg,
//                   log sin arg = -log(t) / 2 (t = 1 / sin^2): the sums
//                   of t, fs v and log t, weighted once after the loop;
//   L:              darg/dL G, with darg/dL = k2 [wrap] inside and
//                   pi/L ([wrap] - r/L) outside (sums of G where the
//                   pair wraps, and outside of r G), plus outside
//                   -ge beta / L (4 (pi/L)^2 t + pi/L fs v), from the
//                   same sums of t and fs v.
// So a pair outside the cutoff, nearly every pair, adds t, fs v, log t,
// G (where it wraps) and r G to five plain sums with no weight; the
// weights are the thread's constants.  kMixed false: the caller knows that
// no lane of the warp holds a pair inside the cutoff, and every select
// folds to the outside operand at compile time (there d != 0, so
// s_j = -s_i); true: the operands are selected per lane, and each branch's
// sums are predicated.
template <typename T>
struct PairVjpConsts {
  T L, half_l, rm, pref;          // the geometry; rm < 0: every pair outside
  T c1_out, c2_out, c3_out;       // G outside
  T k2, in_b, r_off;              // the argument inside
  T c1_in, c2_in, c3_in;          // G inside
  T k2_t, k2_w;                   // the k2 slot inside: ge 4 k2, -ge

  __device__ PairVjpConsts(const T* __restrict__ p, T ge, T glp, T rm_)
      : L(p[P_L]), half_l(T(0.5) * p[P_L]), rm(rm_),
        pref(T(kPi) / p[P_L]), k2(p[P_K2]), in_b(-p[P_K2] * p[P_ROFF]),
        r_off(p[P_ROFF]) {
    const T beta = p[P_BETA];
    c1_out = T(-4) * ge * pref * pref * beta;
    c2_out = -ge * pref * beta;
    c3_out = -glp * beta;
    c1_in = T(4) * ge * k2 * k2;
    c2_in = -ge * k2;
    c3_in = glp;
    k2_t = T(4) * ge * k2;
    k2_w = -ge;
  }
};

// The pair sums of one particle (see above): outside the cutoff the sums
// of t, fs v, log t (pair_log's unit), G where the pair wraps, and r G;
// inside the k2 slot's share, G, G where the pair wraps, and the count.
template <typename T>
struct PairVjpSums {
  T t = 0, w = 0, lg = 0, wrap_out = 0, rg = 0;
  T k2 = 0, g_in = 0, wrap_in = 0, num_in = 0;
};

// One unordered pair at d = z_i - z_j (both in [0, L)), r its minimum-image
// distance (wrap: the image across the boundary), in: r < rm; g_i, g_j are
// -2 F_i, -2 F_j.
template <typename T, bool kMixed>
__device__ __forceinline__ void pair_vjp_terms(T d, T r, bool wrap, bool in,
                                               T g_i, T g_j,
                                               const PairVjpConsts<T>& c,
                                               PairVjpSums<T>* s) {
  if (!kMixed) in = false;
  const T m = in ? c.k2 : c.pref;
  const T arg = kMixed ? d_fma(m, r, in ? c.in_b : T(0)) : m * r;
  T sn, cs;
  trig_pair<false>(arg, &sn, &cs);  // only the ratio is needed
  const T v = pair_ratio(in ? sn : cs, in ? cs : sn);
  const T t = d_fma(v, v, T(1));
  const bool s_i = (d >= T(0)) != wrap;
  const T fs = kMixed ? (s_i ? g_i : -g_i) + ((d <= T(0)) != wrap ? g_j
                                                                  : -g_j)
                      : (s_i ? g_i - g_j : g_j - g_i);
  const T w = fs * v;
  const T g = d_fma(t, d_fma(in ? c.c1_in : c.c1_out, v,
                             (in ? c.c2_in : c.c2_out) * fs),
                    -(in ? c.c3_in : c.c3_out) * v);
  if (in) {
    s->k2 += d_fma(r - c.r_off, g, d_fma(c.k2_t, t, c.k2_w * w));
    s->g_in += g;
    if (wrap) s->wrap_in += g;
    s->num_in += T(1);
  } else {
    s->t += t;
    s->w += w;
    s->lg += pair_log(t);
    if (wrap) s->wrap_out += g;
    s->rg = d_fma(r, g, s->rg);
  }
}

// The pair sums' shares of the slots, weighted: the thread's part of the
// L, k2, r_off, beta and am slots (see above; p the packed parameters).
template <typename T>
__device__ __forceinline__ void add_pair_slots(const PairVjpSums<T>& s,
                                               const T* __restrict__ p,
                                               T ge, T glp,
                                               T (&acc)[kParamsSize]) {
  const T length = p[P_L], k2 = p[P_K2], beta = p[P_BETA];
  const T pref = T(kPi) / length;
  const T coef = d_fma(T(2) * pref * pref, s.t, pref * s.w);  // + 2 pref^2 t
  acc[P_K2] += s.k2;
  acc[P_ROFF] -= k2 * s.g_in;
  acc[P_AM] += glp * s.num_in / p[P_AM];
  acc[P_BETA] += d_fma(ge, coef, T(-0.5) * pair_log_unit(T(0)) * glp * s.lg);
  acc[P_L] += k2 * s.wrap_in + pref * s.wrap_out -
              pref / length * s.rg -
              ge * beta / length * d_fma(T(2) * pref * pref, s.t, coef);
}

// One level of block_row_sums' exchange: kCount values in, kCount / 2 out,
// the lanes with bit kCount keeping the upper half.
template <int kCount, typename T>
__device__ __forceinline__ void reduce_scatter(T* v, int lane) {
  if constexpr (kCount > 1) {
    const bool upper = (lane & kCount) != 0;
#pragma unroll
    for (int k = 0; k < kCount / 2; ++k) {
      const T send = upper ? v[k] : v[k + kCount / 2];
      const T keep = upper ? v[k + kCount / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kCount);
    }
    reduce_scatter<kCount / 2>(v, lane);
  }
}

// The 16 slot sums of a block, written to out[0 .. 16) by threads 0..15.
// Each warp reduces and scatters at once (four halving exchanges at lane
// offsets 16, 8, 4, 2 leave lane l with slot l >> 1, summed over the lanes
// of its parity; one more exchange adds the other parity): 16 shuffles
// where one reduction per slot takes 80.  warp_sums holds 16 * 32
// entries; one barrier.
template <typename T>
__device__ __forceinline__ void block_row_sums(T (&v)[kParamsSize],
                                               T* warp_sums, T* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  reduce_scatter<kParamsSize>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  if ((lane & 1) == 0) warp_sums[32 * (lane >> 1) + warp] = v[0];
  __syncthreads();
  if (threadIdx.x < kParamsSize) {
    const int num_warps = blockDim.x >> 5;
    T sum = 0;
    for (int w = 0; w < num_warps; ++w) {
      sum += warp_sums[32 * threadIdx.x + w];
    }
    out[threadIdx.x] = sum;
  }
}

// The one-body derivatives of particle i at zi (as given) with the
// forward's drift f_i, weighted by the upstream ge (energy) and glp
// (log|psi|), added to acc.  In the barrier (u = z_cell - 1 + z_b/2,
// ldz1 = kp1 tanh(kp1 u), d2 = v0 - e0, f1 = cosh(kp1 u)); in the well
// (u = z_cell - z_a/2, ldz1 = -k1 tan(k1 u), d2 = -e0, f1 = cf cos(k1 u)).
template <typename T>
__device__ __forceinline__ void one_body_grad_terms(
    T zi, T f_i, const T* __restrict__ params, int defects_sep, T ge, T glp,
    T (&acc)[kParamsSize]) {
  const T k1 = params[P_K1], kp1 = params[P_KP1];
  const T z_a = params[P_ZA], z_b = params[P_ZB];
  const T n_cell = d_floor(zi);
  const T z_cell = zi - n_cell;
  acc[P_E0] += ge;  // d(-d2)/de0 = 1 in both regions
  if (z_a < z_cell) {
    const T u = z_cell - T(1) + T(0.5) * z_b;
    const T th = d_tanh(kp1 * u);
    const T sech2 = d_fma(-th, th, T(1));
    const T c2 = T(2) * (kp1 * th - f_i);
    acc[P_V0] -= ge;
    acc[P_KP1] += ge * c2 * d_fma(kp1 * sech2, u, th) + glp * th * u;
    acc[P_ZB] += T(0.5) * kp1 * (ge * c2 * kp1 * sech2 + glp * th);
    if (defects_sep == 1 || d_fmod(n_cell, T(defects_sep)) == T(0)) {
      acc[P_V0D] += ge;
    } else {
      acc[P_V0M] += ge;
    }
  } else {
    const T u = z_cell - T(0.5) * z_a;
    const T tn = d_tan(k1 * u);
    const T sec2 = d_fma(tn, tn, T(1));
    const T c2 = T(2) * (-k1 * tn - f_i);
    acc[P_K1] -= ge * c2 * d_fma(k1 * sec2, u, tn) + glp * tn * u;
    acc[P_ZA] += T(0.5) * k1 * (ge * c2 * k1 * sec2 + glp * tn);
    acc[P_CF] += glp / params[P_CF];
  }
}

}  // namespace qmc
