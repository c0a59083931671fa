// Standard normals for the DMC diffusion step: Philox4x32-10 bits and
// full Box-Muller with quarter-wave polynomial cos/sin.
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
// diffusion kernel (diffuse.cu) includes too.
//
// What bounds it on the H100: bytes written.  Each output element costs
// one quarter of a Philox call (10 rounds of two 32x32 multiplies) plus
// half a logf/sqrtf and one polynomial, ~40 integer and float ops per
// 4-byte store; at 17408 x 128 the 8.9 MB of output take ~3 us at the
// card's 3.35 TB/s, comparable to the arithmetic.
//
// What the design does about it: one thread per quad, nothing read
// from memory, the four outputs written to consecutive addresses (a
// 16-byte vector store for float).  Built without --use_fast_math: the
// radius uses the accurate logf, as the TPU kernel's jnp.log does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using qmc::box_muller;
using qmc::philox4x32_10;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
philox_normals_kernel(T* __restrict__ out, int numel, uint32_t k0,
                      uint32_t k1, uint32_t s0, uint32_t s1) {
  const int num_quads = numel / 4 + (numel % 4 != 0);
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= num_quads) return;
  const uint4 w = philox4x32_10(static_cast<uint32_t>(q), 0u, s0, s1, k0, k1);
  float z[4];
  box_muller(w.x, w.y, &z[0], &z[1]);
  box_muller(w.z, w.w, &z[2], &z[3]);
  const int base = 4 * q;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (base + 4 <= numel) {
      reinterpret_cast<float4*>(out)[q] = make_float4(z[0], z[1], z[2], z[3]);
      return;
    }
  }
  for (int k = 0; k < 4 && base + k < numel; ++k) {
    out[base + k] = static_cast<T>(z[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
philox_words_kernel(uint4* __restrict__ out, int num_quads, uint32_t k0,
                    uint32_t k1, uint32_t s0, uint32_t s1) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= num_quads) return;
  out[q] = philox4x32_10(static_cast<uint32_t>(q), 0u, s0, s1, k0, k1);
}

template <typename T>
int launch_normals(void* out, int numel, int k0, int k1, int s0, int s1,
                   void* stream) {
  if (numel <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int num_quads = numel / 4 + (numel % 4 != 0);
  const int blocks = (num_quads + kThreads - 1) / kThreads;
  philox_normals_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(out), numel, static_cast<uint32_t>(k0),
          static_cast<uint32_t>(k1), static_cast<uint32_t>(s0),
          static_cast<uint32_t>(s1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_philox_normals_f32(void* out, int numel, int key_lo,
                                      int key_hi, int step_lo, int step_hi,
                                      void* stream) {
  return launch_normals<float>(out, numel, key_lo, key_hi, step_lo, step_hi,
                               stream);
}

extern "C" int qmc_philox_normals_f64(void* out, int numel, int key_lo,
                                      int key_hi, int step_lo, int step_hi,
                                      void* stream) {
  return launch_normals<double>(out, numel, key_lo, key_hi, step_lo,
                                step_hi, stream);
}

extern "C" int qmc_philox_words(void* out, int num_quads, int key_lo,
                                int key_hi, int step_lo, int step_hi,
                                void* stream) {
  if (num_quads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (num_quads + kThreads - 1) / kThreads;
  philox_words_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(out), num_quads, static_cast<uint32_t>(key_lo),
      static_cast<uint32_t>(key_hi), static_cast<uint32_t>(step_lo),
      static_cast<uint32_t>(step_hi));
  return static_cast<int>(cudaGetLastError());
}
