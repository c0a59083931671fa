// The S(k) harmonics: the Fourier components of the density,
// rho_k = sum_i exp(i k z_i), at the harmonic momenta k_j = j 2 pi / L,
// j = 0 .. M - 1, as the triples (|rho_k|^2, Re rho_k, Im rho_k).
//
// Replaces no Pallas kernel: the JAX package computes these with an XLA
// scan (_fourier_harmonics_scan, phd_qmclib_tpu/models/jastrow.py:464),
// and the port's plain version (_harmonics_reim,
// phd_qmclib_torch/models/jastrow.py) with one torch launch per mode and
// part into an (M, 2, W, N) buffer, summed over the particles after.  It
// was added because that chain of 2 M + 10 launches was most of the
// device time, and of the host's dispatch, of every run with S(k) on.
// For walker w and particle i, theta_i = (2 pi / L) z_i, then the
// Chebyshev recurrence
//   c_0 = 1, s_0 = 0, c_1 = cos theta_i, s_1 = sin theta_i,
//   c_{j+1} = (2 c_1) c_j - c_{j-1}   (the same for s),
//   out[w, j] = (re^2 + im^2, re, im), re = sum_i c_j, im = sum_i s_j.
// Every element is rounded as the plain version rounds it: the product
// and the difference apart (__fmul_rn, __fsub_rn; no fma contraction, no
// --use_fast_math), the accurate sinf/cosf, and k_1 = 2 pi / L as the
// plain version's torch division gives it: 2 pi rounded to T, divided by
// L with IEEE rounding (__fdiv_rn), here, so that an evaluation is one
// launch.  Only the order of the particle sum differs.
//
// What bounds it on the H100: bytes and flops alike.  N positions in and
// 3 M values out per walker, against 6 flops per particle and mode (the
// recurrence's two products and two differences, the two sums): at
// 16384 x 64 x 32 (the sk cell) 10.5 MB, 3.13 us at 3.35 TB/s, and
// 201 MFLOP, 3.0 us at 67 TFLOP/s; at 16384 x 64 x 64 (variational)
// 6.0 us by the flops; at 17408 x 128 x 64 (production) 12.8 us by the
// flops.
//
// What the design does about it: nothing but the positions and the
// triples touches device memory, and one launch does a whole evaluation.
// Keeping each element's rounding forbids the fma, so the product and
// the difference take an issue slot each: the arithmetic alone reaches
// half the FP32 peak at most.
//   * One warp per walker, lanes over the particles (lane l takes
//     particles l, l + 32, ...); the positions are read once, coalesced.
//   * The modes go 32 at a time.  Each lane runs the recurrence of its
//     particles through the 32 modes of the chunk in registers, adding
//     mode m into acc_c[m], acc_s[m] (fully unrolled: the register count
//     is fixed, whatever M).  Between chunks a particle's recurrence
//     state (2 c_1, c_{j-1}, c_j, s_{j-1}, s_j) waits in the warp's
//     shared memory.  The virtual start (c_{-1}, c_0) = (c_1, 1),
//     (s_{-1}, s_0) = (-s_1, 0) makes modes 0 and 1 come out of the same
//     step, exactly: 2 c_1 * 1 - c_1 = c_1 and 2 c_1 * 0 + s_1 = s_1.
//   * The particle sums of a chunk reduce across the warp by a
//     reduce-scatter: five rounds of shuffles that halve the modes a lane
//     holds (16 + 8 + 4 + 2 + 1 = 31 shuffles per part, against 32 x 5
//     for a reduction per mode), after which lane l holds mode j0 + l.
//     The order is fixed: no atomics, the result is deterministic.
//   * Lane l forms its triple and stages it in shared memory; the warp
//     then stores the chunk's 96 values as three coalesced rows.
// Groups of 8 or 16 lanes a walker (4 or 2 walkers a warp, so that a
// shuffle serves several) took 7-15% less device time on an H100 at the
// three shapes above, which the host-bound steps do not show; one warp a
// walker is the simpler schedule.
// Any N up to 1024 and any M >= 1 (the unused modes of the last chunk
// are computed and not stored), float and double.
//
// Fused-sweep rows: walker w reads L from row w / walkers_per_row of
// the table (a single sampling passes one row and walkers_per_row =
// num_walkers).  Only the address differs, so a row's arithmetic is its
// single-row launch's, bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kModes = 32;           // modes a chunk; one per lane
constexpr int kMaxWarps = 8;         // warps (walkers) a CTA
constexpr int kMaxNop = 1024;
constexpr size_t kSmemBudget = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kTwoPi = 6.283185307179586476925286766559;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  *s = sinf(x);
  *c = cosf(x);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  *s = sin(x);
  *c = cos(x);
}

// One warp's shared memory: each particle's recurrence state, and the
// staging row of a chunk's triples.
template <typename T>
struct SsfSmem {
  T* two_c1;
  T* c_prev;
  T* c_cur;
  T* s_prev;
  T* s_cur;
  T* stage;  // 3 kModes

  __device__ SsfSmem(unsigned char* smem, int warp, int nop) {
    T* base = reinterpret_cast<T*>(smem) + warp * words(nop);
    two_c1 = base;
    c_prev = two_c1 + nop;
    c_cur = c_prev + nop;
    s_prev = c_cur + nop;
    s_cur = s_prev + nop;
    stage = s_cur + nop;
  }

  __host__ __device__ static size_t words(int nop) {
    return 5 * static_cast<size_t>(nop) + 3 * kModes;
  }
};

// One round of the reduce-scatter: the lanes whose bit kHalf is set keep
// the upper half of their 2 kHalf modes, the others the lower half, and
// each adds its partner's copy of the half it keeps.
template <int kHalf, typename T>
__device__ __forceinline__ void fold(T (&v)[kModes], int lane) {
  const bool upper = lane & kHalf;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const T send = upper ? v[k] : v[k + kHalf];
    const T keep = upper ? v[k + kHalf] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, kHalf);
  }
}

// v[0] of lane l becomes the sum over the warp's lanes of their v[l].
template <typename T>
__device__ __forceinline__ void reduce_scatter(T (&v)[kModes], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
}

// blockDim.x / 32 warps, one walker each.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
ssf_harmonics_kernel(const T* __restrict__ pos,
                     const T* __restrict__ lengths,
                     T* __restrict__ out, int num_walkers,
                     int walkers_per_row, int nop, int num_modes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t walker =
      static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (walker >= static_cast<size_t>(num_walkers)) return;  // whole warp
  const SsfSmem<T> smem(smem_raw, warp, nop);
  const T k = div_rn(static_cast<T>(kTwoPi),
                     lengths[walker / static_cast<size_t>(walkers_per_row)]);

  // Each particle's start: (c_{-1}, c_0) = (c_1, 1), (s_{-1}, s_0) =
  // (-s_1, 0).
  for (int p = lane; p < nop; p += 32) {
    T s1, c1;
    sin_cos(mul_rn(k, pos[walker * nop + p]), &s1, &c1);
    smem.two_c1[p] = T(2) * c1;
    smem.c_prev[p] = c1;
    smem.c_cur[p] = T(1);
    smem.s_prev[p] = -s1;
    smem.s_cur[p] = T(0);
  }

  T* const row = out + walker * num_modes * 3;
  for (int j0 = 0; j0 < num_modes; j0 += kModes) {
    const bool last = j0 + kModes >= num_modes;
    T acc_c[kModes], acc_s[kModes];
#pragma unroll
    for (int m = 0; m < kModes; ++m) acc_c[m] = acc_s[m] = T(0);
    for (int p = lane; p < nop; p += 32) {
      const T tc = smem.two_c1[p];
      T ca = smem.c_prev[p], cb = smem.c_cur[p];
      T sa = smem.s_prev[p], sb = smem.s_cur[p];
#pragma unroll
      for (int m = 0; m < kModes; ++m) {
        acc_c[m] += cb;
        acc_s[m] += sb;
        const T cn = sub_rn(mul_rn(tc, cb), ca);
        const T sn = sub_rn(mul_rn(tc, sb), sa);
        ca = cb;
        cb = cn;
        sa = sb;
        sb = sn;
      }
      if (!last) {
        smem.c_prev[p] = ca;
        smem.c_cur[p] = cb;
        smem.s_prev[p] = sa;
        smem.s_cur[p] = sb;
      }
    }
    reduce_scatter(acc_c, lane);
    reduce_scatter(acc_s, lane);
    const T re = acc_c[0], im = acc_s[0];
    smem.stage[3 * lane] = add_rn(mul_rn(re, re), mul_rn(im, im));
    smem.stage[3 * lane + 1] = re;
    smem.stage[3 * lane + 2] = im;
    __syncwarp();
    const int values = 3 * min(kModes, num_modes - j0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int v = lane + 32 * q;
      if (v < values) row[3 * j0 + v] = smem.stage[v];
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* pos, const void* lengths, void* out, int num_walkers,
           int walkers_per_row, int nop, int num_modes, void* stream) {
  if (num_walkers <= 0 || walkers_per_row <= 0 ||
      num_walkers % walkers_per_row != 0 || nop <= 0 || nop > kMaxNop ||
      num_modes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per_warp = SsfSmem<T>::words(nop) * sizeof(T);
  int warps = static_cast<int>(kSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int grid = (num_walkers + warps - 1) / warps;
  ssf_harmonics_kernel<T><<<grid, warps * 32, warps * per_warp,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pos), static_cast<const T*>(lengths),
      static_cast<T*>(out), num_walkers, walkers_per_row, nop, num_modes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_ssf_harmonics_f32(const void* pos, const void* lengths,
                                     void* out, int num_walkers,
                                     int walkers_per_row, int nop,
                                     int num_modes, void* stream) {
  return launch<float>(pos, lengths, out, num_walkers, walkers_per_row, nop,
                       num_modes, stream);
}

extern "C" int qmc_ssf_harmonics_f64(const void* pos, const void* lengths,
                                     void* out, int num_walkers,
                                     int walkers_per_row, int nop,
                                     int num_modes, void* stream) {
  return launch<double>(pos, lengths, out, num_walkers, walkers_per_row, nop,
                        num_modes, stream);
}
