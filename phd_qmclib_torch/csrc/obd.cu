// The one-body density matrix (OBDM) on a grid of offsets, for the mrbp
// model's Bijl-Jastrow trial function.
//
// Replaces no Pallas kernel: the JAX package evaluates its
// one_body_density_grid (phd_qmclib_tpu/models/jastrow.py) with XLA, and
// the port's plain version (phd_qmclib_torch/models/jastrow.py) with
// (W, N, N) torch passes, one chain of them per offset.  It was added
// because that chain was most of the device time of every run with the
// OBDM estimator on.  For walker w, offset s_m and particle i, with the
// positions z:
//   base_i    = log|f1(z_i)| + sum_{j != i} log f2(r_ij),
//   num_{i,m} = log|f1(z_i + s_m)| + sum_{j != i} log f2(|z_i + s_m - z_j|),
//   out[w, m] = sum_i exp(num_{i,m} - base_i) / N,
// the pair distances by the minimum image, log f2 = p log x with
// x = |am| cos(k2 (r - r_off)), p = 1 inside the cutoff r < rm and
// x = sin(pi r / L), p = beta outside (pair_terms.cuh's log variant).
//
// What bounds it on the H100: FP32 instruction issue.  The memory traffic
// is N positions and M offsets in and M values out per walker (9.1 MB at
// 17408 x 128 x 32) against N (N - 1) (M + 1) ordered pairs (9.34e9).
// Counted in float as written (fma = 2, lg2 = 1; compares, minima,
// selects and the vote not counted), a pair outside the cutoff costs
// OBD_FLOPS_PER_PAIR = 17 flops: the difference, L - |d|, the odd
// polynomial of sin(pi r / L) in r (r^2, 5 fma, the product by r: 12),
// the log2 and its weighted sum (fma).  Inside the cutoff the argument's
// fma, the even polynomial (z^2, 5 fma) and the product by |am| add 14,
// but the sum then has p = 1 and no weight: the bound counts every pair
// at 17 (0.6% of them lie inside at the bench density).  The one-body
// terms and the exponential, once per (i, m), are not counted.
//
// What the design does about it: one CTA per walker, the positions in
// shared memory (wrapped into [0, L) twice over, so that particle i's
// partners i + 1 .. i + N - 1 are consecutive slots: a ring with no wrap
// test that never meets the diagonal), and no pair value leaves the
// registers.
//   * First each particle's base (one thread per particle, its ring).
//   * Then the (i, m) items: lane l of a warp takes offset m = l mod G
//     (G = 32, or M rounded up to a power of two below 32) and particle
//     i = l / G of the warp's group, so at M >= 32 all 32 lanes share i
//     and read the same partner at once, a broadcast from shared memory.
//     The shifted position z_i + s_m is wrapped into [0, L) once per
//     item, so that every difference lies in (-L, L) and the minimum
//     image is L - |d| and a minimum.
//   * A warp vote per pair: unless a lane holds a pair inside the cutoff,
//     the pair is the outside body alone; where one does, that lane
//     replaces x and p.  The outside x is the same either way, so a
//     pair's value does not depend on its warp.
//   * sin(pi r / L) by the quarter-wave polynomial of trig.cuh with its
//     coefficients scaled by (pi / L)^(2k + 1), so that it is a
//     polynomial in r with no argument multiply; the log by lg2.approx
//     (MUFU), summed in log2 units and scaled by ln 2 once.
//   * Four partial sums a ring, by step mod 4, added in a fixed order at
//     the end: independent chains, and shorter ones for the rounding.
//     The base and the items use the same ring function, so at s = 0 an
//     item's sums equal its base bit for bit and the OBDM is 1.
//   * Each lane keeps its column's sum over its items in a register;
//     the columns are reduced over the particles by shuffles within the
//     warp and across the warps in shared memory in a fixed order, and
//     written once: no atomics, the result is deterministic.
// Any N up to 1024 and any M (M > 32 in chunks of 32, one after the
// other in the CTA), float and double; the free-gas and ideal-gas
// branches are uniform flags.  Double keeps the library sin, cos, log and
// exp.  Built without --use_fast_math: the one-body cosh/cos/log and the
// exp of each item are the accurate ones.
//
// Fused-sweep rows: walker w reads parameter row and offset row
// w / walkers_per_row (a single sampling passes one row and
// walkers_per_row = num_walkers).  Only the rows' addresses differ, so a
// row's arithmetic is its single-row launch's, bit for bit.
#include <cuda_runtime.h>
#include <math.h>

#include "pair_terms.cuh"
#include "pair_terms_grad.cuh"  // kParamsSize

namespace {

using qmc::kParamsSize;

constexpr int kObdThreads = 256;
constexpr int kObdWarps = kObdThreads / 32;

__device__ __forceinline__ float d_fmin(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double d_fmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
// The cos of the pair factor inside the cutoff: trig.cuh's polynomial in
// float, as pair_terms' log variant; the library cos in double.
__device__ __forceinline__ float cut_cos(float x) { return qmc::cos_poly(x); }
__device__ __forceinline__ double cut_cos(double x) { return cos(x); }

// The pair constants of one parameter row, read once per thread.
template <typename T>
struct ObdConsts {
  T L, pref, rm, k2, in_b, abs_am, beta;
  T sin_c[6];  // float: sin(pref r) = r sum_k sin_c[k] r^2k

  __device__ explicit ObdConsts(const T* __restrict__ p)
      : L(p[qmc::P_L]),
        pref(T(qmc::kPi) / p[qmc::P_L]),
        rm(p[qmc::P_RM]),
        k2(p[qmc::P_K2]),
        in_b(-p[qmc::P_K2] * p[qmc::P_ROFF]),
        abs_am(qmc::d_fabs(p[qmc::P_AM])),
        beta(p[qmc::P_BETA]) {
    // trig.cuh's sin_poly coefficients, from x^1 up, scaled in double,
    // then rounded once.
    const double coeffs[6] = {1.0, -1.66666666e-01, 8.33333098e-03,
                              -1.98408615e-04, 2.75252866e-06,
                              -2.38894895e-08};
    const double pref_d = static_cast<double>(pref);
    double scale = pref_d;
    for (int k = 0; k < 6; ++k) {
      sin_c[k] = static_cast<T>(coeffs[k] * scale);
      scale *= pref_d * pref_d;
    }
  }

  // sin(pi r / L) outside the cutoff, r in [0, L/2].
  __device__ __forceinline__ float outside(float r) const {
    const float r2 = r * r;
    float acc = sin_c[5];
    acc = acc * r2 + sin_c[4];
    acc = acc * r2 + sin_c[3];
    acc = acc * r2 + sin_c[2];
    acc = acc * r2 + sin_c[1];
    acc = acc * r2 + sin_c[0];
    return r * acc;
  }
  __device__ __forceinline__ double outside(double r) const {
    return sin(pref * r);
  }
};

// Adds p log2 x (float; p log x in double) of the ordered pair (zs, zj)
// to acc: both positions in [0, L), so d = zs - zj lies in (-L, L) and
// r = min(|d|, L - |d|).  Every lane of the warp must call it (the vote).
template <typename T>
__device__ __forceinline__ void add_pair(T zs, T zj, const ObdConsts<T>& c,
                                         T& acc) {
  const T ad = qmc::d_fabs(zs - zj);
  const T r = d_fmin(ad, c.L - ad);
  const bool in = r < c.rm;
  T x = c.outside(r), p = c.beta;
  if (__builtin_expect(__any_sync(0xffffffffu, in), 0)) {
    if (in) {
      x = c.abs_am * cut_cos(qmc::d_fma(c.k2, r, c.in_b));
      p = T(1);
    }
  }
  acc = qmc::d_fma(p, qmc::pair_log(x), acc);
}

// The pair sum of the position zs in [0, L) over the ring's `steps`
// partners, in units of pair_log_unit: four partial sums, by step mod 4.
template <typename T>
__device__ __forceinline__ T ring_sum(T zs, const T* ring, int steps,
                                      const ObdConsts<T>& c) {
  T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int k = 0;
  for (; k + 4 <= steps; k += 4) {
    add_pair(zs, ring[k], c, a0);
    add_pair(zs, ring[k + 1], c, a1);
    add_pair(zs, ring[k + 2], c, a2);
    add_pair(zs, ring[k + 3], c, a3);
  }
  if (k < steps) add_pair(zs, ring[k], c, a0);
  if (k + 1 < steps) add_pair(zs, ring[k + 1], c, a1);
  if (k + 2 < steps) add_pair(zs, ring[k + 2], c, a2);
  return (a0 + a1) + (a2 + a3);
}

// log|f1(z)|: cosh in the barrier, cf cos in the well (walker_terms'
// one-body log).
template <typename T>
__device__ __forceinline__ T log_f1(T z, const T* __restrict__ params) {
  const T n_cell = qmc::d_floor(z);
  const T z_cell = z - n_cell;
  const bool in_barrier = params[qmc::P_ZA] < z_cell;
  const T arg_b = params[qmc::P_KP1] * (z_cell - T(1) +
                                        T(0.5) * params[qmc::P_ZB]);
  const T arg_w = params[qmc::P_K1] * (z_cell - T(0.5) * params[qmc::P_ZA]);
  const T f1 = in_barrier ? qmc::d_cosh(arg_b)
                          : params[qmc::P_CF] * qmc::d_cos(arg_w);
  return qmc::d_log(qmc::d_fabs(f1));
}

// The shared memory of one walker's CTA.
template <typename T>
struct ObdSmem {
  T* ring;      // 2 nop: the wrapped positions, twice over
  T* raw;       // nop: the positions as given (the one-body terms)
  T* base_f1;   // nop: log|f1(z_i)|
  T* base_f2;   // nop: the ring sum of particle i
  T* columns;   // 32 per warp

  __device__ ObdSmem(unsigned char* smem, int nop)
      : ring(reinterpret_cast<T*>(smem)),
        raw(ring + 2 * nop),
        base_f1(raw + nop),
        base_f2(base_f1 + nop),
        columns(base_f2 + nop) {}

  static size_t bytes(int nop) {
    return (5 * static_cast<size_t>(nop) + 32 * kObdWarps) * sizeof(T);
  }
};

// One CTA per walker, kObdThreads threads.  group: the lanes per
// particle (G above), a power of two up to 32.
template <typename T>
__global__ void __launch_bounds__(kObdThreads)
obd_grid_kernel(const T* __restrict__ pos, const T* __restrict__ params,
                const T* __restrict__ offsets, T* __restrict__ out,
                int walkers_per_row, int nop, int num_pos, int group,
                int is_free, int is_ideal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ObdSmem<T> smem(smem_raw, nop);
  const size_t walker = blockIdx.x;
  const size_t row = walker / static_cast<size_t>(walkers_per_row);
  params += row * kParamsSize;
  offsets += row * num_pos;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const T length = params[qmc::P_L];
  for (int p = t; p < nop; p += blockDim.x) {
    const T z = pos[walker * nop + p];
    const T zw = qmc::into_supercell(z, length);
    smem.raw[p] = z;
    smem.ring[p] = zw;
    smem.ring[p + nop] = zw;
  }
  __syncthreads();

  const ObdConsts<T> c(params);
  const int steps = is_ideal ? 0 : nop - 1;
  // The log of particle p's factors at the position z (as given; zs
  // wrapped): the one-body log and the ring sum, apart.
  auto item = [&](T z, int p, T* f1, T* f2) {
    *f1 = is_free ? T(0) : log_f1(z, params);
    *f2 = ring_sum(qmc::into_supercell(z, length), smem.ring + p + 1, steps,
                   c);
  };

  // The bases: warps over the particles (warp-uniform trip counts, the
  // lanes past nop on particle nop - 1, unstored).
  for (int p0 = warp * 32; p0 < nop; p0 += blockDim.x) {
    const int p = min(p0 + lane, nop - 1);
    T f1, f2;
    item(smem.raw[p], p, &f1, &f2);
    if (p0 + lane < nop) {
      smem.base_f1[p] = f1;
      smem.base_f2[p] = f2;
    }
  }
  __syncthreads();

  // The items, G offsets at a time: lane l holds offset chunk + l mod G
  // of particle group_index * P + l / G.
  const int per_warp = 32 / group;
  const int groups = (nop + per_warp - 1) / per_warp;
  const T unit = qmc::pair_log_unit(T(0));
  for (int chunk = 0; chunk < num_pos; chunk += group) {
    const int m = chunk + (lane & (group - 1));
    const T s = offsets[min(m, num_pos - 1)];
    T column = 0;
    for (int g = warp; g < groups; g += kObdWarps) {
      const int i = g * per_warp + lane / group;
      const int p = min(i, nop - 1);
      T f1, f2;
      item(smem.raw[p] + s, p, &f1, &f2);
      const T e = d_exp((f1 - smem.base_f1[p]) +
                        unit * (f2 - smem.base_f2[p]));
      if (i < nop) column += e;
    }
    // Over the warp's particles, then over the warps.
    for (int off = group; off < 32; off <<= 1) {
      column += __shfl_xor_sync(0xffffffffu, column, off);
    }
    if (lane < group) smem.columns[warp * 32 + lane] = column;
    __syncthreads();
    if (t < group && chunk + t < num_pos) {
      T sum = 0;
      for (int v = 0; v < kObdWarps; ++v) sum += smem.columns[v * 32 + t];
      out[walker * num_pos + chunk + t] = sum / T(nop);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* pos, const void* params, const void* offsets,
           void* out, int num_walkers, int walkers_per_row, int nop,
           int num_pos, int is_free, int is_ideal, void* stream) {
  if (num_walkers <= 0 || walkers_per_row <= 0 ||
      num_walkers % walkers_per_row != 0 || nop <= 0 ||
      nop > qmc::kMaxThreads || num_pos <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int group = 1;
  while (group < 32 && group < num_pos) group <<= 1;
  obd_grid_kernel<T><<<num_walkers, kObdThreads, ObdSmem<T>::bytes(nop),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(params),
      static_cast<const T*>(offsets), static_cast<T*>(out), walkers_per_row,
      nop, num_pos, group, is_free, is_ideal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_obd_grid_f32(const void* pos, const void* params,
                                const void* offsets, void* out,
                                int num_walkers, int walkers_per_row, int nop,
                                int num_pos, int is_free, int is_ideal,
                                void* stream) {
  return launch<float>(pos, params, offsets, out, num_walkers,
                       walkers_per_row, nop, num_pos, is_free, is_ideal,
                       stream);
}

extern "C" int qmc_obd_grid_f64(const void* pos, const void* params,
                                const void* offsets, void* out,
                                int num_walkers, int walkers_per_row, int nop,
                                int num_pos, int is_free, int is_ideal,
                                void* stream) {
  return launch<double>(pos, params, offsets, out, num_walkers,
                        walkers_per_row, nop, num_pos, is_free, is_ideal,
                        stream);
}
