// The body of K1's parameter VJP: the derivatives of one walker's log|psi|
// and local energy with respect to the packed parameters
// (ops/pairwise.py::pack_params), as the log variant of K1 computes them
// (pair_terms.cuh: the same minimum image, the same branch selection, in
// float the same sin/cos polynomials, reciprocal and log2).
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

// The sums of one particle's pairs, per unordered pair as in pair_terms:
// the energy's derivatives (e_*) and log|psi|'s (lp_*), and the count of
// pairs inside the cutoff (d log|f2| / d am = 1 / am for each).
template <typename T>
struct PairGradSums {
  T e_l = 0, e_k2 = 0, e_roff = 0, e_beta = 0;
  T lp_l = 0, lp_k2 = 0, lp_roff = 0, lp_beta = 0, num_in = 0;
};

// The derivatives of one unordered pair at d = z_i - z_j in [-L, L] (both
// positions in [0, L)), with the forward's drifts f_i and f_j.
//
// Inside the cutoff (arg = k2 (r - r_off), v = tan arg, t = 1 + v^2):
//   ldz = -k2 v, kin = k2^2 t, log|f2| = log|am| + log cos arg,
//   d/dk2: ldz -v - k2 t (r - r_off), kin 2 k2 t (1 + k2 v (r - r_off)),
//          log -v (r - r_off);
//   d/dr_off: ldz k2^2 t, kin -2 k2^3 v t, log k2 v;
//   d/dL: -dr/dL times the d/dr_off terms.
// Outside (arg = pi r / L, v = cot arg, t = 1 + v^2, a = d arg / dL =
// pi/L (dr/dL - r/L)):
//   ldz = pi/L beta v, kin = (pi/L)^2 beta t, log|f2| = beta log sin arg,
//   d/dbeta: ldz pi/L v, kin (pi/L)^2 t, log log sin arg;
//   d/dL: ldz -pi/L beta (v/L + t a), kin -2 (pi/L)^2 beta t (1/L + v a),
//         log beta v a.
template <typename T>
__device__ __forceinline__ void pair_grad_terms(T d, T f_i, T f_j,
                                                const PairParams<T>& c,
                                                T r_off, T inv_l,
                                                PairGradSums<T>* g) {
  const T ad = d_fabs(d);
  const bool wrap = ad > c.half_l;
  const T r = wrap ? c.L - ad : ad;
  const bool in_cut = r < c.rm;
  const T arg = d_fma(in_cut ? c.k2 : c.pref, r, in_cut ? c.in_b : T(0));
  T s, co;
  trig_pair<true>(arg, &s, &co);
  const T v = pair_ratio(in_cut ? s : co, in_cut ? co : s);
  const T t = d_fma(v, v, T(1));
  // -2 (s_i F_i + s_j F_j): the factor of dldz in dE.
  const T fs = T(-2) * (((d >= T(0)) != wrap ? f_i : -f_i) +
                        ((d <= T(0)) != wrap ? f_j : -f_j));
  if (in_cut) {
    const T k2 = c.k2;
    const T a = r - r_off;
    const T k2t = k2 * t;
    const T e_k2 = T(4) * k2t * d_fma(k2 * v, a, T(1)) - fs * d_fma(k2t, a, v);
    const T lp_k2 = -v * a;
    const T e_roff = T(-4) * k2 * k2 * k2t * v + fs * k2 * k2t;
    const T lp_roff = k2 * v;
    g->e_k2 += e_k2;
    g->lp_k2 += lp_k2;
    g->e_roff += e_roff;
    g->lp_roff += lp_roff;
    if (wrap) {
      g->e_l -= e_roff;
      g->lp_l -= lp_roff;
    }
    g->num_in += T(1);
  } else {
    const T a = c.pref * ((wrap ? T(1) : T(0)) - r * inv_l);
    g->e_beta += d_fma(T(2) * c.pref * c.pref, t, fs * c.pref * v);
    g->lp_beta += pair_log_unit(T(0)) * pair_log(s);
    g->e_l += T(-4) * c.out_kin * t * d_fma(v, a, inv_l) -
              fs * c.out_ldz * d_fma(t, a, v * inv_l);
    g->lp_l += c.beta * v * a;
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
