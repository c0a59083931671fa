// Per-walker position histogram: hist[w, b] = #{i : bin(z_wi) = b}.
//
// Replaces the Pallas TPU kernel phd_qmclib_tpu/ops/histogram.py::
// _hist_kernel (wrapper walker_histogram_pallas), and with it the JAX
// sampler's production formulation walker_histogram_mxu (a bf16 one-hot
// factorization for the TPU's matrix unit), whose counts it gives bit for
// bit.  The DMC density estimator bins the (W, N) positions; the g2
// estimator bins the (W N, N) rows of the minimum-image distance matrix.
//
// Bin rule: bin = clip(floor_divide(z, bin_size), 0, B - 1), with the
// floor division of Python, jnp and torch (fmod, then an exact IEEE
// divide of the remainder-free numerator, then floor with the round-up
// of a fraction above one half).  That is the exact floor of z / bin_size,
// where floor(z / bin_size) with one rounded divide can land one bin
// high just below a bin edge.  NaN and negative quotients go to bin 0,
// quotients at or above B - 1 to bin B - 1.  Counts are exact integers,
// written once in the input's type.
//
// What bounds it on the H100: bytes.  Each element costs a few flops
// and one shared-memory atomic; at the g2 shape (17408 x 128 rows of
// 128 distances, 128 bins, f32) the kernel reads 1.14 GB and writes
// 1.14 GB, about 0.7 ms at the card's 3.35 TB/s.
//
// What the design does about it: one warp per row, kWarps rows per CTA.
// The 32 lanes read a row's elements at consecutive addresses (one
// 128-byte transaction per 32 floats), count into the warp's own int
// bins in shared memory with shared-memory atomicAdd, and write the row
// of counts once, again lane-contiguous.  No count touches device memory
// until it is final.  num_bins is a runtime argument; the launcher
// shrinks the warps per CTA so that the bins fit the default 48 KB of
// shared memory and refuses more than one warp's worth.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kMaxWarps = 8;
constexpr int kSharedBytes = 48 * 1024;

__device__ __forceinline__ float d_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double d_fmod(double x, double y) { return fmod(x, y); }
__device__ __forceinline__ float d_floor(float x) { return floorf(x); }
__device__ __forceinline__ double d_floor(double x) { return floor(x); }
__device__ __forceinline__ float d_copysign(float x, float y) {
  return copysignf(x, y);
}
__device__ __forceinline__ double d_copysign(double x, double y) {
  return copysign(x, y);
}

// Floor division of two floats, step for step as torch's
// div_floor_floating (and CPython's float_divmod, which jnp's // follows).
template <typename T>
__device__ __forceinline__ T floor_divide(T a, T b) {
  if (b == T(0)) return a / b;
  const T mod = d_fmod(a, b);
  T div = (a - mod) / b;
  if (mod != T(0) && ((b < T(0)) != (mod < T(0)))) div -= T(1);
  if (div == T(0)) return d_copysign(T(0), a / b);
  T floordiv = d_floor(div);
  if (div - floordiv > T(0.5)) floordiv += T(1);
  return floordiv;
}

template <typename T>
__device__ __forceinline__ int bin_of(T z, T bin_size, int num_bins) {
  const T q = floor_divide(z, bin_size);
  if (!(q >= T(0))) return 0;  // negative or NaN
  if (q >= static_cast<T>(num_bins - 1)) return num_bins - 1;
  return static_cast<int>(q);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarpSize)
walker_histogram_kernel(const T* __restrict__ pos,
                        const T* __restrict__ bin_size, T* __restrict__ out,
                        int num_rows, int row_len, int num_bins) {
  extern __shared__ int counts[];
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarpSize) + warp;
  if (row >= num_rows) return;
  int* row_counts = counts + warp * num_bins;
  for (int b = lane; b < num_bins; b += kWarpSize) row_counts[b] = 0;
  __syncwarp();
  const T bs = *bin_size;
  const T* z = pos + row * row_len;
  for (int i = lane; i < row_len; i += kWarpSize) {
    atomicAdd(&row_counts[bin_of(z[i], bs, num_bins)], 1);
  }
  __syncwarp();
  T* dst = out + row * num_bins;
  for (int b = lane; b < num_bins; b += kWarpSize) {
    dst[b] = static_cast<T>(row_counts[b]);
  }
}

template <typename T>
int launch(const void* pos, const void* bin_size, void* out, int num_rows,
           int row_len, int num_bins, void* stream) {
  if (num_rows <= 0 || row_len <= 0 || num_bins <= 0 ||
      num_bins > kSharedBytes / static_cast<int>(sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int warps = kSharedBytes / (num_bins * static_cast<int>(sizeof(int)));
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int blocks = (num_rows + warps - 1) / warps;
  const size_t shared = static_cast<size_t>(warps) * num_bins * sizeof(int);
  walker_histogram_kernel<T>
      <<<blocks, warps * kWarpSize, shared,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pos), static_cast<const T*>(bin_size),
          static_cast<T*>(out), num_rows, row_len, num_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_walker_histogram_f32(const void* pos, const void* bin_size,
                                        void* out, int num_rows, int row_len,
                                        int num_bins, void* stream) {
  return launch<float>(pos, bin_size, out, num_rows, row_len, num_bins,
                       stream);
}

extern "C" int qmc_walker_histogram_f64(const void* pos, const void* bin_size,
                                        void* out, int num_rows, int row_len,
                                        int num_bins, void* stream) {
  return launch<double>(pos, bin_size, out, num_rows, row_len, num_bins,
                        stream);
}
