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
// floor division of Python, jnp and torch: the exact floor of the real
// quotient z / bin_size (one rounded divide can land one bin high just
// below a bin edge).  NaN, +-inf (torch's inf // bs is NaN) and negative
// quotients go to bin 0, quotients at or above B - 1 to bin B - 1.
// Counts are exact integers, written once in the input's type.  The bin
// size is a device table: row w takes bin_size[w / group_rows], so that the
// rows of a fused parameter sweep, each with its own supercell, bin in one
// launch (one entry and group_rows = num_rows for a single sampling).
//
// The exact floor without fmod: for a bin size bs > 0 with a finite
// reciprocal, q = floor(z * (1 / bs)) is the true floor n or one off
// (two roundings, relative error < 2^-22, and only quotients below B
// <= 12,288 matter), and r = fma(-q, bs, z) is then exact: z and q bs are
// multiples of ulp(bs) and |r| <= bs (Sterbenz's lemma when q = 1 > n =
// 0), or r rounds to >= bs when q = n - 1.  So r < 0 means q = n + 1 and
// r >= bs means q = n - 1: one correction gives n.  Any other bin size (0,
// negative, inf, NaN, or one whose reciprocal overflows) keeps torch's
// fmod form (div_floor_floating) step for step.  The class is decided
// once per thread from bs: a uniform branch.
//
// What bounds it on the H100: bytes.  The bin costs ~10 instructions per
// element; at the g2 shape (17408 x 128 rows of 128 distances, 128 bins,
// f32) the kernel reads 1.14 GB and writes 1.14 GB, 0.68 ms at the
// card's 3.35 TB/s; at the density shape (17408 x 128, 128 bins) 17.8 MB,
// 5.3 us.
//
// What the design does about it: a persistent grid (the SMs times the
// resident CTAs, sized by the wrapper) whose CTAs walk tiles of
// contiguous rows, one row per warp, so that the bin size, the zeroing of
// the bins and the launch are paid once per warp, not once per row.  A
// row of at most 512 bytes, 16-byte aligned and a whole number of
// 16-byte vectors (the density and g2 rows: 128 floats), is read with one
// 16-byte non-coherent load per lane, and the next row's load is issued
// before the current row's shared-memory atomics, so that each warp keeps
// two rows in flight; other rows take a scalar path, four loads per lane
// at a time.  Each warp counts into its own int bins in shared memory;
// the row of counts is read and cleared in one pass (no separate zeroing)
// and written with 16-byte streaming stores where the output rows are
// 16-byte aligned, else element by element.  num_bins is a runtime
// argument: the wrapper shrinks the warps per CTA so that the bins fit
// the default 48 KB of shared memory.
//
// More bins than one warp's 48 KB holds (12,288) take the tiled kernel
// at the end of this file: a whole CTA counts one row at a time, the bins
// cut into tiles that fit the shared memory, one pass over the row (from
// L1 after the first) per tile.  Its work is the write of the counts,
// num_bins values per row, so the re-read rows cost nothing beside it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpSize = 32;
constexpr int kMaxWarps = 8;
// CTAs of kMaxWarps warps that the launch bounds keep resident on one SM
// (at most 32 registers a thread); ops/histogram.py sizes the grid with
// it and the shared memory the bins take.
constexpr int kCtasPerSm = 8;
constexpr int kSharedBytes = 48 * 1024;
constexpr int kVecBytes = 16;

__device__ __forceinline__ float d_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double d_fmod(double x, double y) { return fmod(x, y); }
__device__ __forceinline__ float d_floor(float x) { return floorf(x); }
__device__ __forceinline__ double d_floor(double x) { return floor(x); }
__device__ __forceinline__ float d_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double d_fma(double a, double b, double c) {
  return fma(a, b, c);
}
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

// The bin of z by the fmod form: any bin size.
template <typename T>
struct FmodBin {
  T bs;
  int last;
  __device__ __forceinline__ int operator()(T z) const {
    const T q = floor_divide(z, bs);
    if (!(q >= T(0))) return 0;  // negative or NaN
    if (q >= static_cast<T>(last)) return last;
    return static_cast<int>(q);
  }
};

// The bin of z by the reciprocal and one fma correction (see the note
// at the head): bin sizes with FastBin::takes(bs).
template <typename T>
struct FastBin {
  T bs, inv, top;
  int last;
  __device__ __forceinline__ FastBin(T bin_size, T reciprocal, int num_bins)
      : bs(bin_size), inv(reciprocal), top(static_cast<T>(num_bins)),
        last(num_bins - 1) {}
  static __device__ __forceinline__ bool takes(T bin_size, T reciprocal) {
    return bin_size > T(0) && reciprocal > T(0) &&
           reciprocal < static_cast<T>(INFINITY);
  }
  __device__ __forceinline__ int operator()(T z) const {
    // NaN, +-inf and negative z: bin 0 (-0 passes and lands there too).
    if (!(z >= T(0) && z < static_cast<T>(INFINITY))) return 0;
    T q = d_floor(z * inv);
    if (q >= top) return last;  // the true floor is at least B - 1
    const T r = d_fma(-q, bs, z);
    if (r < T(0)) {
      q -= T(1);
    } else if (r >= bs) {
      q += T(1);
    }
    const int b = static_cast<int>(q);
    return b < last ? b : last;
  }
};

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int kLen = 4;
  static __device__ __forceinline__ void unpack(const float4& v, float* e) {
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int kLen = 2;
  static __device__ __forceinline__ void unpack(const double2& v, double* e) {
    e[0] = v.x;
    e[1] = v.y;
  }
};

// Counts kLen consecutive bins of the warp's row out as one 16-byte
// streaming store, clearing them for the next row.
__device__ __forceinline__ void store_counts(int* bins, float* dst, int v) {
  int4* src = reinterpret_cast<int4*>(bins) + v;
  const int4 c = *src;
  *src = make_int4(0, 0, 0, 0);
  __stcs(reinterpret_cast<float4*>(dst) + v,
         make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w)));
}

__device__ __forceinline__ void store_counts(int* bins, double* dst, int v) {
  int2* src = reinterpret_cast<int2*>(bins) + v;
  const int2 c = *src;
  *src = make_int2(0, 0);
  __stcs(reinterpret_cast<double2*>(dst) + v,
         make_double2(static_cast<double>(c.x), static_cast<double>(c.y)));
}

// The warp's row of counts to dst, and its bins back to 0.
template <typename T>
__device__ __forceinline__ void flush_row(int* bins, T* dst, int num_bins,
                                          bool vec_out, int lane) {
  if (vec_out) {
    const int num_vecs = num_bins / Vec16<T>::kLen;
    for (int v = lane; v < num_vecs; v += kWarpSize) {
      store_counts(bins, dst, v);
    }
  } else {
    for (int b = lane; b < num_bins; b += kWarpSize) {
      dst[b] = static_cast<T>(bins[b]);
      bins[b] = 0;
    }
  }
}

// The bin size of a row: bin_size[row / group_rows], the row's group (a
// fused sweep's row; one group for a single sampling), with the class of
// its rule, read again only when the group changes.  The rule is decided
// per row from its group's size: a branch uniform across the warp (or the
// CTA) that walks the row.
template <typename T>
struct GroupBins {
  const T* bin_size;
  int64_t group_rows, num_rows, group = -1;
  T bs, inv;
  bool fast;
  __device__ __forceinline__ void at(int64_t row) {
    const int64_t g = group_rows >= num_rows ? 0 : row / group_rows;
    if (g != group) {
      group = g;
      bs = __ldg(bin_size + g);
      inv = T(1) / bs;
      fast = FastBin<T>::takes(bs, inv);
    }
  }
};

struct Walk {
  int64_t row, stride, num_rows;
  int row_len, num_bins, lane;
  bool vec_out;
};

template <typename T, class Rule>
__device__ __forceinline__ void bin_vec(const Rule& rule, int* bins,
                                        typename Vec16<T>::type cur) {
  T e[Vec16<T>::kLen];
  Vec16<T>::unpack(cur, e);
#pragma unroll
  for (int k = 0; k < Vec16<T>::kLen; ++k) atomicAdd(&bins[rule(e[k])], 1);
}

template <typename T, class Rule>
__device__ __forceinline__ void bin_scalar(const Rule& rule, int* bins,
                                           const T* z, int row_len,
                                           int lane) {
  int i = lane;
  for (; i + 3 * kWarpSize < row_len; i += 4 * kWarpSize) {
    const T a = __ldg(z + i), b = __ldg(z + i + kWarpSize);
    const T c = __ldg(z + i + 2 * kWarpSize);
    const T d = __ldg(z + i + 3 * kWarpSize);
    atomicAdd(&bins[rule(a)], 1);
    atomicAdd(&bins[rule(b)], 1);
    atomicAdd(&bins[rule(c)], 1);
    atomicAdd(&bins[rule(d)], 1);
  }
  for (; i < row_len; i += kWarpSize) {
    atomicAdd(&bins[rule(__ldg(z + i))], 1);
  }
}

// Rows of 16-byte vectors, one vector per lane, the next row in flight.
template <typename T>
__device__ __forceinline__ void walk_vec(GroupBins<T> gb, const T* pos,
                                         T* out, int* bins, Walk w,
                                         typename Vec16<T>::type cur) {
  using V = typename Vec16<T>::type;
  constexpr int kLen = Vec16<T>::kLen;
  const bool active = w.lane < w.row_len / kLen;
  for (; w.row < w.num_rows; w.row += w.stride) {
    const int64_t next = w.row + w.stride;
    V nxt = cur;
    if (active && next < w.num_rows) {
      nxt = __ldg(reinterpret_cast<const V*>(pos + next * w.row_len) + w.lane);
    }
    gb.at(w.row);
    if (active) {
      if (gb.fast) {
        bin_vec<T>(FastBin<T>(gb.bs, gb.inv, w.num_bins), bins, cur);
      } else {
        bin_vec<T>(FmodBin<T>{gb.bs, w.num_bins - 1}, bins, cur);
      }
    }
    __syncwarp();
    flush_row(bins, out + w.row * w.num_bins, w.num_bins, w.vec_out, w.lane);
    __syncwarp();
    cur = nxt;
  }
}

// Any rows: scalar loads, four per lane at a time.
template <typename T>
__device__ __forceinline__ void walk_scalar(GroupBins<T> gb, const T* pos,
                                            T* out, int* bins, Walk w) {
  for (; w.row < w.num_rows; w.row += w.stride) {
    const T* z = pos + w.row * w.row_len;
    gb.at(w.row);
    if (gb.fast) {
      bin_scalar(FastBin<T>(gb.bs, gb.inv, w.num_bins), bins, z, w.row_len,
                 w.lane);
    } else {
      bin_scalar(FmodBin<T>{gb.bs, w.num_bins - 1}, bins, z, w.row_len,
                 w.lane);
    }
    __syncwarp();
    flush_row(bins, out + w.row * w.num_bins, w.num_bins, w.vec_out, w.lane);
    __syncwarp();
  }
}

template <typename T, bool kVecIn>
__global__ void __launch_bounds__(kMaxWarps * kWarpSize, kCtasPerSm)
walker_histogram_kernel(const T* __restrict__ pos,
                        const T* __restrict__ bin_size, T* __restrict__ out,
                        int64_t num_rows, int64_t group_rows, int row_len,
                        int num_bins, int vec_out) {
  extern __shared__ __align__(16) int counts[];
  const int warps = blockDim.x / kWarpSize;
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  Walk w{static_cast<int64_t>(blockIdx.x) * warps + warp,
         static_cast<int64_t>(gridDim.x) * warps, num_rows, row_len,
         num_bins, lane, vec_out != 0};
  // The first row's load goes out before the bin size's comes back.
  typename Vec16<T>::type first{};
  if (kVecIn && w.row < num_rows && lane < row_len / Vec16<T>::kLen) {
    first = __ldg(reinterpret_cast<const typename Vec16<T>::type*>(
                      pos + w.row * row_len) + lane);
  }
  int* bins = counts + warp * num_bins;
  for (int b = lane; b < num_bins; b += kWarpSize) bins[b] = 0;
  __syncwarp();
  const GroupBins<T> gb{bin_size, group_rows, num_rows};
  if constexpr (kVecIn) {
    walk_vec(gb, pos, out, bins, w, first);
  } else {
    walk_scalar(gb, pos, out, bins, w);
  }
}

// --- more bins than one warp's shared memory holds ---------------------------
//
// The CTA's threads walk rows blockIdx.x, blockIdx.x + gridDim.x, ...; for
// each tile [t0, t0 + width) of the bins they bin the whole row, count the
// elements that fall into the tile into the CTA's shared counts, and
// write and clear the tile.  Every element falls into one tile, so the
// counts are the plain version's bit for bit.
//
// The bin rule is the same FastBin while its proof holds.  The computed
// quotient z * (1 / bs) carries two roundings, a relative error below
// 2^-22 in f32 (2^-51 in f64): an absolute error below 1 for every
// quotient below 2^22, so that its floor is the true floor or one off,
// and a computed quotient at or above B still means a true floor of at
// least B - 1.  q < 2^24 is exact in T, and the fma's q bs is exact
// whatever q, so the one correction gives the true floor as before.
// 65,536 bins sit well inside; kFastBins = 2^22 is the most the tiled
// kernel bins that way, and beyond it (as for a bin size without a
// finite positive reciprocal) it takes the fmod form, exact for any
// quotient.
constexpr int kFastBins = 1 << 22;

template <typename T>
__device__ __forceinline__ void flush_tile(int* counts, T* dst, int width,
                                           bool vec_out) {
  if (vec_out) {
    const int num_vecs = width / Vec16<T>::kLen;
    for (int v = threadIdx.x; v < num_vecs; v += blockDim.x) {
      store_counts(counts, dst, v);
    }
  } else {
    for (int b = threadIdx.x; b < width; b += blockDim.x) {
      dst[b] = static_cast<T>(counts[b]);
      counts[b] = 0;
    }
  }
}

template <typename T, class Rule>
__device__ __forceinline__ void tiled_row(const Rule& rule, const T* z,
                                          T* dst, int* counts, int row_len,
                                          int num_bins, int tile,
                                          bool vec_out) {
  int width;
  for (int t0 = 0; t0 < num_bins; t0 += width) {
    width = num_bins - t0 < tile ? num_bins - t0 : tile;
    for (int i = threadIdx.x; i < row_len; i += blockDim.x) {
      const int b = rule(__ldg(z + i)) - t0;
      if (b >= 0 && b < width) atomicAdd(&counts[b], 1);
    }
    __syncthreads();
    flush_tile(counts, dst + t0, width, vec_out);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarpSize, kCtasPerSm)
walker_histogram_tiled_kernel(const T* __restrict__ pos,
                              const T* __restrict__ bin_size,
                              T* __restrict__ out, int64_t num_rows,
                              int64_t group_rows, int row_len, int num_bins,
                              int tile, int vec_out) {
  extern __shared__ __align__(16) int counts[];
  for (int b = threadIdx.x; b < tile; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  GroupBins<T> gb{bin_size, group_rows, num_rows};
  for (int64_t row = blockIdx.x; row < num_rows; row += gridDim.x) {
    const T* z = pos + row * row_len;
    T* dst = out + row * num_bins;
    gb.at(row);
    if (num_bins <= kFastBins && gb.fast) {
      tiled_row(FastBin<T>(gb.bs, gb.inv, num_bins), z, dst, counts, row_len,
                num_bins, tile, vec_out != 0);
    } else {
      tiled_row(FmodBin<T>{gb.bs, num_bins - 1}, z, dst, counts, row_len,
                num_bins, tile, vec_out != 0);
    }
  }
}

// tile: bins per pass, a multiple of 4 (so that every tile of a 16-byte
// aligned output row starts 16-byte aligned) that fits the shared memory.
template <typename T>
int launch_tiled(const void* pos, const void* bin_size, void* out,
                 long long num_rows, long long group_rows, int row_len,
                 int num_bins, int tile, int grid, void* stream) {
  const long long shared =
      static_cast<long long>(tile) * static_cast<long long>(sizeof(int));
  if (num_rows <= 0 || group_rows <= 0 || num_rows % group_rows != 0 ||
      row_len <= 0 || num_bins <= 0 || tile < 4 ||
      tile % 4 != 0 || grid < 1 || shared > kSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_out =
      reinterpret_cast<uintptr_t>(out) % kVecBytes == 0 &&
      (static_cast<long long>(num_bins) * sizeof(T)) % kVecBytes == 0;
  walker_histogram_tiled_kernel<T>
      <<<grid, kMaxWarps * kWarpSize, shared,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pos), static_cast<const T*>(bin_size),
          static_cast<T*>(out), num_rows, group_rows, row_len, num_bins, tile,
          vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* pos, const void* bin_size, void* out,
           long long num_rows, long long group_rows, int row_len,
           int num_bins, int warps, int grid, void* stream) {
  const long long shared = static_cast<long long>(warps) * num_bins *
                           static_cast<long long>(sizeof(int));
  if (num_rows <= 0 || group_rows <= 0 || num_rows % group_rows != 0 ||
      row_len <= 0 || num_bins <= 0 || warps < 1 ||
      warps > kMaxWarps || grid < 1 || shared > kSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row_bytes = static_cast<long long>(row_len) * sizeof(T);
  const bool vec_in = reinterpret_cast<uintptr_t>(pos) % kVecBytes == 0 &&
                      row_bytes % kVecBytes == 0 &&
                      row_bytes <= kWarpSize * kVecBytes;
  const int vec_out =
      reinterpret_cast<uintptr_t>(out) % kVecBytes == 0 &&
      (static_cast<long long>(num_bins) * sizeof(T)) % kVecBytes == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec_in) {
    walker_histogram_kernel<T, true><<<grid, warps * kWarpSize, shared, s>>>(
        static_cast<const T*>(pos), static_cast<const T*>(bin_size),
        static_cast<T*>(out), num_rows, group_rows, row_len, num_bins,
        vec_out);
  } else {
    walker_histogram_kernel<T, false><<<grid, warps * kWarpSize, shared, s>>>(
        static_cast<const T*>(pos), static_cast<const T*>(bin_size),
        static_cast<T*>(out), num_rows, group_rows, row_len, num_bins,
        vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_walker_histogram_ctas_per_sm() { return kCtasPerSm; }

extern "C" int qmc_walker_histogram_f32(const void* pos, const void* bin_size,
                                        void* out, long long num_rows,
                                        long long group_rows, int row_len,
                                        int num_bins, int warps, int grid,
                                        void* stream) {
  return launch<float>(pos, bin_size, out, num_rows, group_rows, row_len,
                       num_bins, warps, grid, stream);
}

extern "C" int qmc_walker_histogram_f64(const void* pos, const void* bin_size,
                                        void* out, long long num_rows,
                                        long long group_rows, int row_len,
                                        int num_bins, int warps, int grid,
                                        void* stream) {
  return launch<double>(pos, bin_size, out, num_rows, group_rows, row_len,
                        num_bins, warps, grid, stream);
}

extern "C" int qmc_walker_histogram_tiled_f32(
    const void* pos, const void* bin_size, void* out, long long num_rows,
    long long group_rows, int row_len, int num_bins, int tile, int grid,
    void* stream) {
  return launch_tiled<float>(pos, bin_size, out, num_rows, group_rows,
                             row_len, num_bins, tile, grid, stream);
}

extern "C" int qmc_walker_histogram_tiled_f64(
    const void* pos, const void* bin_size, void* out, long long num_rows,
    long long group_rows, int row_len, int num_bins, int tile, int grid,
    void* stream) {
  return launch_tiled<double>(pos, bin_size, out, num_rows, group_rows,
                              row_len, num_bins, tile, grid, stream);
}
