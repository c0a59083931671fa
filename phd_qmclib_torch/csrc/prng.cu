// Standard normals for the DMC diffusion step: Philox4x32-10 bits and
// full Box-Muller with quarter-wave polynomial cos/sin, times a scale.
//
// Replaces the Pallas TPU kernel phd_qmclib_tpu/ops/prng.py::
// _normals_kernel (wrapper normal_pallas).  The TPU kernel draws bits
// from the chip's hardware generator; this one computes Philox4x32-10
// (Salmon et al., SC11), counter-based, so every element is a pure
// function of (key, step, element index) and the plain torch version in
// ops/prng.py reproduces the integer words exactly:
//   key     = (seed mod 2^32, seed >> 32)
//   counter = (q mod 2^32, q >> 32, step mod 2^32, step >> 32)
// for the quad q of output elements 4q .. 4q+3.  Words (w0, w1) give the
// pair u1 = (w0 >> 8) 2^-24 + 2^-24 in (0, 1], u2 = (w1 >> 8) 2^-24 in
// [0, 1), and elements 4q = r cos(2 pi u2), 4q+1 = r sin(2 pi u2) with
// r = sqrt(-2 log u1); words (w2, w3) give elements 4q+2 and 4q+3.
// The generator and the transform live in philox.cuh, which the fused
// diffusion kernel (diffuse.cu) includes too.  Each output is
// scale * z, with z the float normal: a float multiply by the scale
// rounded to float for a float output (torch's f32 tensor-times-scalar),
// a double multiply of double(z) for a double output; scale 1 gives z.
//
// What bounds it on the H100: instruction issue, then bytes written.  At
// 17408 x 128 f32 the 8.9 MB of output take 2.66 us at the card's
// 3.35 TB/s (a kernel that only stores them takes ~3.1 us); a quad costs
// ~40 issue slots of Philox (10 rounds of two wide multiplies and two
// 3-input xors) and ~140 of two Box-Mullers, which keep the accurate
// logf and sqrtf, ~3.5 us over 132 SMs at 1.98 GHz.
//
// What the design does about it: a persistent grid (the SMs times the
// CTAs the launch bounds keep resident, sized by the wrapper) whose
// threads stride over the quads, so that the launch and the tail are
// paid once per thread, not once per quad; the Philox key schedule is a
// kernel parameter, so each round's xor reads its key from the constant
// bank; hi and lo of each Philox product from one 32x32 -> 64 multiply;
// the Box-Muller log and square root without the branches for arguments
// they never see and the signs as conditional negations (philox.cuh: bit
// for bit the accurate logf and sqrtf and the +-1 multiplies, which the
// check kernel below verifies over all 2^24 values of each uniform); each quad written as
// one 16-byte streaming store (two for double) where the output is
// 16-byte aligned, with a scalar path for the tail and for an unaligned
// output.  Nothing is read from memory.  Built without --use_fast_math:
// the radius is the accurate logf's and sqrtf's, as the TPU kernel's
// jnp.log is.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using qmc::box_muller;
using qmc::philox4x32_10;
using qmc::PhiloxKeys;

constexpr int kThreads = 256;
// CTAs of kThreads that the launch bounds keep resident on one SM (at most
// 64 registers a thread); ops/prng.py sizes the grid with the same number.
constexpr int kCtasPerSm = 4;

// The round keys of a 64-bit seed, built on the host for a launch.
PhiloxKeys keys_of(unsigned long long key) {
  return PhiloxKeys(static_cast<uint32_t>(key),
                    static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ void store_quad(float* out, int q, const float* z,
                                           float scale) {
  __stcs(reinterpret_cast<float4*>(out) + q,
         make_float4(scale * z[0], scale * z[1], scale * z[2],
                     scale * z[3]));
}

__device__ __forceinline__ void store_quad(double* out, int q, const float* z,
                                           double scale) {
  double2* dst = reinterpret_cast<double2*>(out) + 2 * q;
  __stcs(dst, make_double2(scale * static_cast<double>(z[0]),
                           scale * static_cast<double>(z[1])));
  __stcs(dst + 1, make_double2(scale * static_cast<double>(z[2]),
                               scale * static_cast<double>(z[3])));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
philox_normals_kernel(T* __restrict__ out, int numel, const PhiloxKeys keys,
                      uint64_t step, T s) {
  const uint32_t s0 = static_cast<uint32_t>(step);
  const uint32_t s1 = static_cast<uint32_t>(step >> 32);
  const int full_quads = numel / 4;
  const int num_quads = full_quads + (numel % 4 != 0);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < num_quads;
       q += gridDim.x * kThreads) {
    const uint4 w = philox4x32_10(static_cast<uint32_t>(q), 0u, s0, s1, keys);
    float z[4];
    box_muller(w.x, w.y, &z[0], &z[1]);
    box_muller(w.z, w.w, &z[2], &z[3]);
    if (aligned && q < full_quads) {
      store_quad(out, q, z, s);
    } else {
      for (int k = 0; k < 4 && 4 * q + k < numel; ++k) {
        out[4 * q + k] = s * static_cast<T>(z[k]);
      }
    }
  }
}

// The rows of a fused parameter sweep in one launch: row r of out (row_numel
// elements) holds scales[r] times the normals of (keys[r], step), its quads
// counted from 0 inside the row, so that it is word for word the single-row
// kernel's output for that key and scale.  CTA c takes row c mod R and is
// the (c div R)-th of that row's gridDim.x / R CTAs: neighbouring CTAs,
// which the hardware spreads over the SMs, take different rows, so that
// the CTAs that take one more quad a thread (a row's first) land on
// different SMs.  Each thread builds its row's key schedule, loads its
// scale and tests its row's alignment once, then strides over the row's
// quads with a 32-bit index, as the single-row kernel does.  The schedule
// is held in registers (an empty asm hides how it was built, or the
// compiler rebuilds each round key for every quad): each round's xor
// reads it there, where the single-row kernel reads the constant bank.
template <typename T>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
philox_normals_rows_kernel(T* __restrict__ out, int row_numel, int num_rows,
                           const unsigned long long* __restrict__ keys,
                           const T* __restrict__ scales, uint64_t step) {
  const uint32_t s0 = static_cast<uint32_t>(step);
  const uint32_t s1 = static_cast<uint32_t>(step >> 32);
  const int full_quads = row_numel / 4;
  const int row_quads = full_quads + (row_numel % 4 != 0);
  const int row = blockIdx.x % num_rows;
  const int row_ctas = gridDim.x / num_rows;
  const unsigned long long key = __ldg(keys + row);
  PhiloxKeys row_keys(static_cast<uint32_t>(key),
                      static_cast<uint32_t>(key >> 32));
#pragma unroll
  for (int round = 0; round < qmc::kPhiloxRounds; ++round) {
    asm("" : "+r"(row_keys.k0[round]), "+r"(row_keys.k1[round]));
  }
  const T s = __ldg(scales + row);
  T* row_out = out + static_cast<int64_t>(row) * row_numel;
  const bool aligned = (reinterpret_cast<uintptr_t>(row_out) & 15) == 0;
  for (int q = blockIdx.x / num_rows * kThreads + threadIdx.x; q < row_quads;
       q += row_ctas * kThreads) {
    const uint4 w = philox4x32_10(static_cast<uint32_t>(q), 0u, s0, s1,
                                  row_keys);
    float z[4];
    box_muller(w.x, w.y, &z[0], &z[1]);
    box_muller(w.z, w.w, &z[2], &z[3]);
    if (aligned && q < full_quads) {
      store_quad(row_out, q, z, s);
    } else {
      for (int k = 0; k < 4 && 4 * q + k < row_numel; ++k) {
        row_out[4 * q + k] = s * static_cast<T>(z[k]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
philox_words_kernel(uint4* __restrict__ out, int num_quads,
                    const PhiloxKeys keys, uint64_t step) {
  const uint32_t s0 = static_cast<uint32_t>(step);
  const uint32_t s1 = static_cast<uint32_t>(step >> 32);
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < num_quads;
       q += gridDim.x * kThreads) {
    out[q] = philox4x32_10(static_cast<uint32_t>(q), 0u, s0, s1, keys);
  }
}

template <typename T>
int launch_normals(void* out, int numel, unsigned long long key,
                   unsigned long long step, double scale, int grid,
                   void* stream) {
  if (numel <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // The scale cast to T on the host: for float, round to nearest, as
  // torch casts a Python scalar for an f32 multiply.
  philox_normals_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(out), numel, keys_of(key), step,
          static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_normals_rows(void* out, int row_numel, int num_rows,
                        const void* keys, const void* scales,
                        unsigned long long step, int grid, void* stream) {
  // grid: the CTAs of each row (ops/prng.py::rows_grid).
  if (row_numel <= 0 || num_rows <= 0 || grid <= 0 ||
      grid > (1 << 30) / num_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  philox_normals_rows_kernel<T>
      <<<grid * num_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(out), row_numel, num_rows,
          static_cast<const unsigned long long*>(keys),
          static_cast<const T*>(scales), step);
  return static_cast<int>(cudaGetLastError());
}

// The check of philox.cuh's transform against its plain CUDA form: for
// every 24-bit value k of a uniform's word (w = k << 8), the radius
// sqrt(-2 log u1) against sqrtf(-2 logf(u1)), and the unit cos and sin
// against the folding of the original form (rint of a half, +-1
// multiplies), bit for bit; counts the values where any differs.
__global__ void check_box_muller_kernel(int* __restrict__ mismatches) {
  const float inv24 = 1.0f / 16777216.0f;
  int bad = 0;
  for (uint32_t k = blockIdx.x * blockDim.x + threadIdx.x; k < (1u << 24);
       k += gridDim.x * blockDim.x) {
    const uint32_t w = k << 8;
    const float radius = qmc::bm_radius(w);
    float cosv, sinv;
    qmc::bm_unit(w, &cosv, &sinv);
    const float u1 = static_cast<float>(k) * inv24 + inv24;
    const float radius_ref = sqrtf(-2.0f * logf(u1));
    const float a = 2.0f * (static_cast<float>(k) * inv24);
    const float b = a - 2.0f * rintf(0.5f * a);
    const float c = fabsf(b);
    const bool flip = c > 0.5f;
    const float arg = 3.14159265358979323846f * (flip ? 1.0f - c : c);
    const float cos_ref = (flip ? -1.0f : 1.0f) * qmc::cos_poly(arg);
    const float sin_ref = (b >= 0.0f ? 1.0f : -1.0f) * qmc::sin_poly(arg);
    bad += __float_as_uint(radius) != __float_as_uint(radius_ref) ||
           __float_as_uint(cosv) != __float_as_uint(cos_ref) ||
           __float_as_uint(sinv) != __float_as_uint(sin_ref);
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

extern "C" int qmc_philox_ctas_per_sm() { return kCtasPerSm; }

extern "C" int qmc_philox_normals_f32(void* out, int numel,
                                      unsigned long long key,
                                      unsigned long long step, double scale,
                                      int grid, void* stream) {
  return launch_normals<float>(out, numel, key, step, scale, grid, stream);
}

extern "C" int qmc_philox_normals_f64(void* out, int numel,
                                      unsigned long long key,
                                      unsigned long long step, double scale,
                                      int grid, void* stream) {
  return launch_normals<double>(out, numel, key, step, scale, grid, stream);
}

extern "C" int qmc_philox_normals_rows_f32(void* out, int row_numel,
                                           int num_rows, const void* keys,
                                           const void* scales,
                                           unsigned long long step, int grid,
                                           void* stream) {
  return launch_normals_rows<float>(out, row_numel, num_rows, keys, scales,
                                    step, grid, stream);
}

extern "C" int qmc_philox_normals_rows_f64(void* out, int row_numel,
                                           int num_rows, const void* keys,
                                           const void* scales,
                                           unsigned long long step, int grid,
                                           void* stream) {
  return launch_normals_rows<double>(out, row_numel, num_rows, keys, scales,
                                     step, grid, stream);
}

extern "C" int qmc_philox_words(void* out, int num_quads,
                                unsigned long long key,
                                unsigned long long step, int grid,
                                void* stream) {
  if (num_quads <= 0 || grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  philox_words_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(out), num_quads, keys_of(key), step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qmc_check_box_muller(void* mismatches, void* stream) {
  check_box_muller_kernel<<<1024, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}
