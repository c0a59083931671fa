// The body of K1, the fused Bijl-Jastrow local energy, drift and log|psi|,
// shared by the pair kernel (pairwise.cu, both variants) and the fused
// diffusion kernel (diffuse.cu).  One CTA holds one walker: thread i < nop
// is particle i.  There is one pair loop, walker_terms's, for all three.
//
// walker_terms computes, for every particle of the walker, the
// minimum-image phonon pair terms and, after the pair loop (so that only
// the pair sums live through it), the one-body Kronig-Penney terms.  It
// returns the particle's drift F_i, its energy term kin_i - F_i^2 + pot_i
// and with kLogPsi its log|psi| share; the caller reduces the terms over
// the block (block_sums).
//
// The schedule, each unordered pair once on a half ring: at step
// k = 1 .. steps = (nop - 1) / 2 thread i takes particle (i + k) mod nop,
// and for an even nop a last step pairs i < nop / 2 with i + nop / 2.
//   * The positions twice over: each ring holds particle s mod nop at
//     slot s for s <= nop + steps, so that thread i's partner at step k is
//     slot i + k, an immediate offset, with no wrap test.
//   * The padding threads (i >= nop) walk a ring of zeros past the real
//     one with a negative vote cutoff and store nothing, so every lane of
//     a warp votes at every step.
//   * A warp vote per step (ring_pair): unless some lane holds a pair
//     inside the contact cutoff rm (or a coincident pair, with
//     least_positive as the cutoff when rm <= 0), every lane takes the fast
//     body: every select folded to the outside operands, j's drift term
//     = -i's, and u = pi/L cot(pi r / L) from the rational tan with its
//     coefficients scaled by (pi/L)^2k, so that the argument's multiply
//     goes; otherwise K1's pair_terms.  0.6% of pairs are inside the
//     cutoff at the bench density, but a warp holds one at ~18% of steps
//     (ops/pairwise.py::vote_share counts them).
//   * The kinetic terms on the taker's side: a pair's kinetic term is the
//     same for both particles and only the walker's sum of them is wanted,
//     so the thread that takes the pair counts it twice and nothing is
//     stored for j.  Only the drift, odd in d, keeps a j side.
//   * The j sides in kBuffers rings of 8-byte RingSlots (16 in double):
//     step k adds to ring k mod kBuffers, so a barrier orders kBuffers
//     steps, not one.  4 rings up to 256 threads; at 1024, 2 in float and
//     1 in double, which keeps the rings within 48 KB (ring_buffers).
//     float unrolls each group of kBuffers steps with one pointer per
//     ring; double guards each step, so that it holds one copy of its much
//     longer body.
//   * With kLogPsi, the fast body's log|f2| = beta log sin(pi r / L) comes
//     from the u already in hand: log sin = -log(1 + cot^2) / 2, with
//     cot = u L / pi, one fma and one lg2.approx in float, no sin/cos
//     polynomials; double takes log of the library sin.
// Tried and dropped (PERF.md, section 6): a warp-tiled schedule (lane l
// of warp t holds particle 32 t + l, the partner tile's positions and j
// sides rotating by shuffles, a barrier per tile step): with the vote, a
// reconvergence before every shuffle; without it, both branches' selects;
// either way the warps' unequal shares of the tiles' half ring; slower at
// 17408 x 64 and in f64.  The signed image d - L round(d / L) in the fast
// body (u odd in s, no sign selects): 2 instructions a pair fewer, 1.8%
// slower in float, as its serial chain before the vote is longer.  One
// vote per group of 4 steps (the fast body on every pair, K1's added
// where a lane is inside the cutoff): 22% slower, as ~half the groups
// hold such a pair and pay for both.  8 rings up to 256 threads (a
// barrier every 8 steps): K1 2.6 points less of a gain at 17408 x 128
// and 6-9 points less at N = 64 (fewer CTAs fit an SM), the fused
// diffusion kernel 6-8% slower.  The drift's sign from the imaged
// distance (wrap ? -d : d) in place of (d >= 0) != wrap: K1 1.4-2 points
// less of a gain, the fused diffusion kernel 2-4% slower.
// Each thread's sums are added in a fixed order, and the log terms go to
// sums of their own, so the results are deterministic and in double the
// forward and the log variant give the same energy and drift bit for bit
// (acc_add, acc_mul).  K3 runs the same code at the moved positions, so
// its energy and drift are K1's there.
//
// float flops of one unordered pair outside the cutoff as written (fma =
// 2, rcp and lg2 = 1; compares, selects and negations not counted): 24
// (the difference, the image, r^2, the two polynomials 12, r P, the
// reciprocal and the ratio 3, the three sums 6), and 29 with kLogPsi (the
// log's argument 3, lg2 and its sum); inside it K1's pair_terms, 28 and
// 40, and its sums.
//
// K1's pair kinetic term is C (1 + v^2) in both variants, with v the tan
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

constexpr unsigned kFullMask = 0xffffffffu;

// The least positive value: the vote's cutoff when rm <= 0, so that a
// coincident pair still takes K1's body.
__device__ __forceinline__ float least_positive(float) { return 1.40129846e-45f; }
__device__ __forceinline__ double least_positive(double) { return 4.9406564584124654e-324; }

// The pair terms outside the cutoff in the fast body's form: for a
// minimum-image distance r, u = pi/L cot(pi r / L), so that the drift
// term is +-beta u and the pair's kinetic term (pi/L)^2 beta + beta u^2;
// with kLog also ls = log(1 + cot^2) = -2 log sin(pi r / L) in units of
// pair_log_unit.  float: the rational tan of trig_pair<false> with its
// coefficients scaled by (pi/L)^2k (r P'(r^2) / Q'(r^2) = tan(pi r / L)
// L / pi), rcp.approx and lg2.approx; double: sincos, the IEEE divide
// and log.
template <typename T>
struct OutsidePair;

template <>
struct OutsidePair<float> {
  float p1, p2, p3, q1, q2, q3, inv_pref2;

  __device__ explicit OutsidePair(float pref) {
    const float a = pref * pref;
    p1 = kTanP1 * a;
    p2 = kTanP2 * a * a;
    p3 = kTanP3 * a * a * a;
    q1 = kTanQ1 * a;
    q2 = kTanQ2 * a * a;
    q3 = kTanQ3 * a * a * a;
    inv_pref2 = 1.0f / a;
  }

  template <bool kLog>
  __device__ __forceinline__ float u(float r, float* ls) const {
    const float rr = r * r;
    const float p = fmaf(fmaf(fmaf(p3, rr, p2), rr, p1), rr, 1.0f);
    const float q = fmaf(fmaf(fmaf(q3, rr, q2), rr, q1), rr, 1.0f);
    const float u = pair_ratio(q, r * p);
    if constexpr (kLog) *ls = pair_log(fmaf(u * inv_pref2, u, 1.0f));
    return u;
  }
};

template <>
struct OutsidePair<double> {
  double pref;

  __device__ explicit OutsidePair(double pref_) : pref(pref_) {}

  template <bool kLog>
  __device__ __forceinline__ double u(double r, double* ls) const {
    double s, c;
    sincos(pref * r, &s, &c);
    if constexpr (kLog) *ls = -2.0 * log(s);
    return pref * c / s;
  }
};

// A thread's pair constants: K1's (for the voted steps), the fast body's
// and the vote's cutoff: rm, the least positive value when rm <= 0 (so
// that a coincident pair votes), or -1 on a padding thread, which never
// votes.
template <typename T>
struct PairConsts {
  PairParams<T> k1;
  OutsidePair<T> out;
  T rm_vote;

  __device__ PairConsts(const T* __restrict__ params, bool active)
      : k1(params), out(k1.pref),
        rm_vote(active ? (k1.rm > T(0) ? k1.rm : least_positive(T(0)))
                       : T(-1)) {}
};

// A thread's own pair sums: the drift; the kinetic terms less
// (pi/L)^2 beta each, as sum u^2 (fast body) and sum kin - (pi/L)^2 beta
// (K1's body), each pair counted once here and twice in the walker's sum;
// with kLogPsi the fast body's sum ls of log(1 + cot^2) and K1's body's
// sum lg of log|f2|, both in units of pair_log_unit.
template <typename T>
struct OwnSums {
  T f = 0, u2 = 0, kin = 0, ls = 0, lg = 0;
};

// One ring slot: a particle's position in [0, L) and a j-side drift sum.
template <typename T>
struct alignas(2 * sizeof(T)) RingSlot {
  T z, j;
};

// The pair of the thread's particle at zi and the one in *slot: i's side
// to *own, j's drift term to the slot's sum (unless store is false: a
// padding thread's).  kVote: the warp votes on "some lane holds a pair
// inside the cutoff or a coincident pair"; unless one does, every lane
// takes the fast body; without the vote (a step not every lane takes),
// K1's pair_terms.
template <typename T, bool kLogPsi, bool kVote>
__device__ __forceinline__ void ring_pair(T zi, RingSlot<T>* slot,
                                          const PairConsts<T>& c,
                                          bool store, OwnSums<T>* own) {
  const RingSlot<T> other = *slot;
  const T d = zi - other.z;
  const T ad = d_fabs(d);
  const bool wrap = ad > c.k1.half_l;
  const T r = wrap ? c.k1.L - ad : ad;
  T j = other.j;
  if (!kVote || __builtin_expect(__any_sync(kFullMask, r < c.rm_vote), 0)) {
    T fi, fj, kin, lg;
    pair_terms<T, kLogPsi>(d, c.k1, &fi, &fj, &kin, &lg);
    own->f += fi;
    own->kin += kin - c.k1.out_kin;
    if constexpr (kLogPsi) own->lg += lg;
    j += fj;
  } else {
    T ls;
    const T u = c.out.template u<kLogPsi>(r, &ls);
    const T g = (d >= T(0)) != wrap ? c.k1.beta : -c.k1.beta;
    own->f = d_fma(g, u, own->f);
    own->u2 = d_fma(u, u, own->u2);
    if constexpr (kLogPsi) own->ls += ls;
    j = d_fma(-g, u, j);
  }
  if (store) slot->j = j;
}

// The slots of one ring: particle s mod nop at slot s <= nop + steps
// (steps = (nop - 1) / 2), so that thread i's partners i + 1 .. i + steps
// need no wrap test, then steps + 1 slots at 0 that the padding threads
// read.  Two steps that add to one slot of one ring are kBuffers apart,
// and a barrier every kBuffers steps orders them.
__host__ __device__ __forceinline__ int ring_len(int nop) {
  return nop + 2 * ((nop - 1) >> 1) + 2;
}

// Rings of a block of `threads` threads: 4 up to 256; at 1024, 2 in float
// and 1 in double, which keeps the rings within 48 KB.
template <typename T>
__host__ __device__ constexpr int ring_buffers(int threads) {
  return threads <= 256 ? 4 : sizeof(T) == 4 ? 2 : 1;
}

// The shared memory of one walker's CTA: `buffers` rings of ring_len(nop)
// slots, then block_sums' 32 reduction slots for each of kSums sums; a
// kernel may keep more past them (end()).
template <typename T, int kSums>
struct WalkerSmem {
  RingSlot<T>* rings;
  T* warp_sums;

  __device__ WalkerSmem(unsigned char* raw, int buffers, int len)
      : rings(reinterpret_cast<RingSlot<T>*>(raw)),
        warp_sums(reinterpret_cast<T*>(rings + buffers * len)) {}

  __device__ unsigned char* end() const {
    return reinterpret_cast<unsigned char*>(warp_sums + 32 * kSums);
  }

  static size_t bytes(int buffers, int nop) {
    return static_cast<size_t>(buffers) * ring_len(nop) *
               sizeof(RingSlot<T>) +
           32 * kSums * sizeof(T);
  }
};

// The one-body Kronig-Penney terms at z: the orbital's log-derivative
// *ldz, the kinetic term *kin, the barrier or defect potential *pot and,
// with kLogPsi, log|f1| (cosh in the barrier, cf cos in the well, cf
// packed once).
template <typename T, bool kLogPsi>
__device__ __forceinline__ void one_body_terms(T z,
                                               const T* __restrict__ params,
                                               int defects_sep, T* ldz,
                                               T* kin, T* pot, T* lg) {
  const T v0 = params[P_V0], e0 = params[P_E0];
  const T k1 = params[P_K1], kp1 = params[P_KP1];
  const T z_a = params[P_ZA], z_b = params[P_ZB];
  const T n_cell = d_floor(z);
  const T z_cell = z - n_cell;
  const bool in_barrier = z_a < z_cell;
  const T arg_b = kp1 * (z_cell - T(1) + T(0.5) * z_b);
  const T arg_w = k1 * (z_cell - T(0.5) * z_a);
  const T ob_ldz = in_barrier ? kp1 * d_tanh(arg_b) : -k1 * d_tan(arg_w);
  const T ob_d2 = in_barrier ? v0 - e0 : -e0;
  T barrier_v = params[P_V0D];
  if (defects_sep != 1 && d_fmod(n_cell, T(defects_sep)) != T(0)) {
    barrier_v = params[P_V0M];
  }
  *pot = in_barrier ? barrier_v : T(0);
  *ldz = ob_ldz;
  *kin = d_fma(ob_ldz, ob_ldz, -ob_d2);
  if (kLogPsi) {
    const T f1 = in_barrier ? d_cosh(arg_b) : params[P_CF] * d_cos(arg_w);
    *lg = d_log(d_fabs(f1));
  }
}

// K1's terms of every particle of one walker; see the top of this file.
// Every thread of the block calls it (it holds barriers); thread i < nop
// gets particle i's, the others 0.  zi is particle i's position as given
// (any finite value past nop): the pair terms take it wrapped into [0, L)
// (into_supercell), the one-body terms as it is.  smem holds kBuffers
// rings, ring_buffers<T>(blockDim.x) of them.  log_out is written only
// with kLogPsi.
template <typename T, bool kLogPsi, int kBuffers, int kSums>
__device__ __forceinline__ void walker_terms(
    const WalkerSmem<T, kSums>& smem, int nop, T zi,
    const T* __restrict__ params, int is_free, int is_ideal,
    int defects_sep, T* drift_out, T* term_out, T* log_out) {
  const int i = threadIdx.x;
  const bool active = i < nop;
  const int steps = (nop - 1) >> 1;
  const int len = ring_len(nop);
  OwnSums<T> own;
  T out_kin = 0;

  if (!is_ideal) {
    const T z_own = active ? into_supercell(zi, params[P_L]) : T(0);
    if (active) {
      for (int b = 0; b < kBuffers; ++b) {
        smem.rings[b * len + i] = {z_own, T(0)};
        if (i <= steps) smem.rings[b * len + nop + i] = {z_own, T(0)};
      }
    }
    for (int s = nop + steps + 1 + i; s < len; s += blockDim.x) {
      for (int b = 0; b < kBuffers; ++b) smem.rings[b * len + s] = {T(0), T(0)};
    }
    __syncthreads();

    const PairConsts<T> c(params, active);
    out_kin = c.k1.out_kin;
    // Thread i reads slots i + k of its rings; a padding thread, the
    // zeros past the real ring, and stores nothing.  slot[b]: the slot of
    // step k + b in ring (k + b) mod kBuffers, k = 1 mod kBuffers.
    RingSlot<T>* const ring = smem.rings + (active ? i : nop + steps + 1);
    RingSlot<T>* slot[kBuffers];
#pragma unroll
    for (int b = 0; b < kBuffers; ++b) {
      slot[b] = ring + ((1 + b) % kBuffers) * len + 1 + b;
    }
    if constexpr (sizeof(T) == 4) {
      // Whole groups of kBuffers steps, then the last steps apart.
      int k = 1;
      for (; k + kBuffers - 1 <= steps; k += kBuffers) {
#pragma unroll
        for (int b = 0; b < kBuffers; ++b) {
          ring_pair<T, kLogPsi, true>(z_own, slot[b], c, active, &own);
          slot[b] += kBuffers;
        }
        __syncthreads();
      }
#pragma unroll
      for (int b = 0; b < kBuffers - 1; ++b) {
        if (k + b <= steps) {
          ring_pair<T, kLogPsi, true>(z_own, slot[b], c, active, &own);
        }
      }
    } else {
      // Each step guarded, so that the kernel holds one copy of double's
      // much longer body (sincos and the divide): a separate copy of the
      // last steps made K3 slower at N = 64.
      for (int k = 1; k <= steps; k += kBuffers) {
#pragma unroll
        for (int b = 0; b < kBuffers; ++b) {
          if (k + b <= steps) {
            ring_pair<T, kLogPsi, true>(z_own, slot[b], c, active, &own);
          }
          slot[b] += kBuffers;
        }
        __syncthreads();
      }
    }
    // An even nop: particle i < nop / 2 with i + nop / 2, as step
    // steps + 1.
    __syncthreads();
    if (nop == 2 * (steps + 1) && i <= steps) {
      ring_pair<T, kLogPsi, false>(
          z_own, ring + ((steps + 1) % kBuffers) * len + steps + 1, c, true,
          &own);
    }
    __syncthreads();
  }

  T drift_i = 0, kin_i = 0, pot_i = 0, log_i = 0;
  if (active) {
    if (!is_free) {
      one_body_terms<T, kLogPsi>(zi, params, defects_sep, &drift_i, &kin_i,
                                 &pot_i, &log_i);
    }
    if (!is_ideal) {
      // The j sides of particle i: its slots i and, for i <= steps,
      // nop + i of every ring.
      T j = 0;
      for (int b = 0; b < kBuffers; ++b) {
        j += smem.rings[b * len + i].j;
        if (i <= steps) j += smem.rings[b * len + nop + i].j;
      }
      drift_i = acc_add(drift_i, acc_add(own.f, j));
      // The particle's share of the walker's kinetic pair sum: nop - 1
      // times (pi/L)^2 beta, and twice its pairs' kinetic terms less that.
      kin_i = acc_add(kin_i, acc_add(acc_mul(T(nop - 1), out_kin),
                                     acc_mul(T(2), d_fma(params[P_BETA],
                                                         own.u2, own.kin))));
      if (kLogPsi) {
        // beta log sin = -beta ls / 2 on the fast body's pairs.
        log_i += pair_log_unit(T(0)) *
                 d_fma(T(-0.5) * params[P_BETA], own.ls, own.lg);
      }
    }
  }

  *drift_out = drift_i;
  *term_out = acc_add(d_fma(-drift_i, drift_i, kin_i), pot_i);
  if (kLogPsi) *log_out = log_i;
}

}  // namespace qmc
