// Fused DMC diffusion step: noise, drift move, recast, local energy and
// drift of the moved walker, and the branching weight, in one pass.
//
// Replaces the Pallas TPU kernel phd_qmclib_tpu/ops/pairwise.py::
// _diffuse_kernel (wrapper diffuse_energy_drift_pallas).  For walker w and
// particle i, with the cloned parents (cpos, cdrift, cenergy):
//   xi_wi  = the Philox normal of element w N + i for (seed, step), or
//            the injected xi when one is given;
//   z'_wi  = recast(cpos_wi + 2 cdrift_wi dt + sigma xi_wi) into [0, L);
//   E'_w, F'_wi = K1 (forward) at z'_w;
//   weight_w = exp(-dt ((E'_w + cenergy_w) / 2 - E_ref)).
// The TPU kernel draws its noise from the chip's hardware generator and
// recasts with z - L floor(z / L); this one draws the normals kernel's
// stream (philox.cuh: the same words and normals as prng.cu) and recasts
// with the floor modulo of torch.remainder, as the torch step does.
//
// What bounds it on the H100: FP32 instruction issue in the pair loop, as
// for K1 (pairwise.cu).  The noise is one Philox quad and two Box-Mullers
// per four elements, and the memory traffic is 3 N + 1 values in and
// 2 N + 2 out per walker (~45 MB at 17408 x 128, ~13 us at HBM rate),
// so the tensor cores, TMA and asynchronous copies have nothing to take.
//
// What held the first design back (K1's body, pair_terms.cuh::
// walker_terms, reached from here; its SASS): 44 instructions a pair, of
// them both cutoff branches' selects on every pair, a ring index with a
// wrap test, a read-modify-write of the partner's shared-memory slot and
// a block barrier per ring step (63 a walker at N = 128); and the noise
// drawn once per element, each thread running the whole Philox quad of
// its element and both Box-Muller paths (the warp diverges on e & 3).
//
// What this design does about it: one CTA per walker, one thread per
// particle, each unordered pair once on K1's half ring, but:
//   * the partners at immediate offsets: the positions twice over in
//     shared memory (slot s holds particle s mod nop up to nop + steps),
//     so that thread i's partner at step k is slot i + k, no wrap test;
//   * a warp vote per step: unless some lane holds a pair inside the
//     cutoff (or a coincident pair), the body runs with every select
//     folded to the outside operands, j's drift term = -i's, and the
//     rational tan's coefficients scaled by (pi/L)^2k, so that
//     u = pi/L cot(pi r / L) comes from r without the argument's multiply;
//     otherwise K1's pair_terms (0.6% of pairs are inside the cutoff at
//     the bench density, but a warp holds one at ~18% of steps);
//   * the kinetic terms counted twice by the thread that takes the pair
//     (only their walker sum is wanted), so only the drift keeps a j side;
//   * the j sides in 4 rings (step k adds to ring k mod 4, 2 or 1 at
//     1024 threads), so that a barrier orders 4 steps, not one; float
//     unrolls each group of 4 steps with one pointer per ring, double
//     guards each step instead of a separate copy of the last ones;
//   * the padding threads walk a ring of zeros with a negative cutoff
//     and store nothing, so every lane votes at every step;
//   * the noise once per quad: thread t of the walker draws the t-th
//     Philox quad covering its elements and both Box-Mullers of it into
//     shared memory (quads that straddle two walkers are drawn by both);
//     the key schedule is a kernel parameter, read from the constant bank;
//   * instantiations by block size (128, 256, 1024 threads), launch
//     bounds of 64 registers (float uses ~40, double 64).
// Each thread's sums are added in a fixed order, so the results are
// deterministic; the order is not K1's, so the energy and drift agree
// with K1's to rounding, not bit for bit.  The pair positions are
// into_supercell of the moved ones and the one-body terms take the moved
// positions, as K1 at the moved walker does.
// Tried and dropped (PERF.md, section 6): a warp-tiled schedule (lane l of
// warp t holds particle 32 t + l, the partner tile's positions and j sides
// rotating by shuffles, a barrier per tile step): with the vote, a
// reconvergence before every shuffle; without it, both branches' selects;
// either way the warps' unequal shares of the tiles' half ring; slower
// than the parent at 17408 x 64 and in f64.  The signed image
// d - L round(d / L) in the fast body (u odd in s, no sign selects): 2
// instructions a pair fewer, 1.8% slower in float, as its serial chain
// before the vote is longer.  One vote per group of 4 steps (the fast
// body on every pair, K1's added where a lane is inside the cutoff):
// 22% slower, as ~half the groups hold such a pair and pay for both.
//
// The move, the recast and the weight are written with round-to-nearest
// intrinsics (no fma contraction) in the torch step's order,
// ((cpos + (2 cdrift) dt) + sigma xi), so that with the same xi the moved
// positions equal the DMC step's (samplers/dmc.py, Sampling.diffuse) on
// the card bit for bit.
// E_ref is a 0-d device tensor read through a pointer: no host sync.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_terms.cuh"
#include "philox.cuh"

namespace {

using qmc::d_fma;
using qmc::kMaxThreads;
using qmc::PairParams;

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
// The least positive value: the vote's cutoff when rm <= 0, so that a
// coincident pair still takes K1's body.
__device__ __forceinline__ float least_positive(float) { return 1.40129846e-45f; }
__device__ __forceinline__ double least_positive(double) { return 4.9406564584124654e-324; }

// torch.remainder(z, L): the floor modulo from fmod.
template <typename T>
__device__ __forceinline__ T floor_mod(T z, T L) {
  T m = qmc::d_fmod(z, L);
  if (m != T(0) && ((L < T(0)) != (m < T(0)))) m += L;
  return m;
}

// The one-body terms of walker_terms (pair_terms.cuh), the same
// expressions: the orbital's log-derivative, the kinetic term and the
// barrier or defect potential at z.
template <typename T>
__device__ __forceinline__ void one_body_terms(T z,
                                               const T* __restrict__ params,
                                               int defects_sep, T* ldz,
                                               T* kin, T* pot) {
  using namespace qmc;
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
}

// The pair terms outside the cutoff in the fast body's form: for a
// minimum-image distance r, u = pi/L cot(pi r / L), so that the drift
// term is +-beta u and the pair's kinetic term (pi/L)^2 beta + beta u^2.
// float: the rational tan of trig_pair<false> with its coefficients
// scaled by (pi/L)^2k (r P'(r^2) / Q'(r^2) = tan(pi r / L) L / pi) and
// rcp.approx; double: sincos and the IEEE divide.
template <typename T>
struct OutsidePair;

template <>
struct OutsidePair<float> {
  float p1, p2, p3, q1, q2, q3;

  __device__ explicit OutsidePair(float pref) {
    using namespace qmc;
    const float a = pref * pref;
    p1 = kTanP1 * a;
    p2 = kTanP2 * a * a;
    p3 = kTanP3 * a * a * a;
    q1 = kTanQ1 * a;
    q2 = kTanQ2 * a * a;
    q3 = kTanQ3 * a * a * a;
  }

  __device__ __forceinline__ float u(float r) const {
    const float rr = r * r;
    const float p = fmaf(fmaf(fmaf(p3, rr, p2), rr, p1), rr, 1.0f);
    const float q = fmaf(fmaf(fmaf(q3, rr, q2), rr, q1), rr, 1.0f);
    return qmc::pair_ratio(q, r * p);
  }
};

template <>
struct OutsidePair<double> {
  double pref;

  __device__ explicit OutsidePair(double pref_) : pref(pref_) {}

  __device__ __forceinline__ double u(double r) const {
    double s, c;
    sincos(pref * r, &s, &c);
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

// A thread's own pair sums: the drift, and the kinetic terms less
// (pi/L)^2 beta each, as sum u^2 (fast body) and sum kin - (pi/L)^2 beta
// (K1's body).  A pair's kinetic term is the same for both particles and
// only the walker's sum of them is wanted, so the thread that takes the
// pair counts it twice and no j side is kept for it.
template <typename T>
struct OwnSums {
  T f = 0, u2 = 0, kin = 0;
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
template <typename T, bool kVote>
__device__ __forceinline__ void ring_pair(T zi, RingSlot<T>* slot,
                                          const PairConsts<T>& c,
                                          bool store, OwnSums<T>* own) {
  const RingSlot<T> other = *slot;
  const T d = zi - other.z;
  const T ad = qmc::d_fabs(d);
  const bool wrap = ad > c.k1.half_l;
  const T r = wrap ? c.k1.L - ad : ad;
  T j = other.j;
  if (!kVote || __builtin_expect(__any_sync(kFullMask, r < c.rm_vote), 0)) {
    T fi, fj, kin;
    qmc::pair_terms<T, false>(d, c.k1, &fi, &fj, &kin, nullptr);
    own->f += fi;
    own->kin += kin - c.k1.out_kin;
    j += fj;
  } else {
    const T u = c.out.u(r);
    const T g = (d >= T(0)) != wrap ? c.k1.beta : -c.k1.beta;
    own->f = d_fma(g, u, own->f);
    own->u2 = d_fma(u, u, own->u2);
    j = d_fma(-g, u, j);
  }
  if (store) slot->j = j;
}

// The kernel's shared memory: kBuffers rings of ring_len(nop) slots, 32
// reduction slots, then a normal per thread.  A ring holds at slot s the
// position of particle s mod nop for s <= nop + steps (steps = (nop - 1)
// / 2), so that thread i's partners i + 1 .. i + steps need no wrap
// test, then steps + 1 slots at 0 that the padding threads read.  Step k
// adds its j sides to ring k mod kBuffers: two steps that add to one
// slot of one ring are kBuffers apart, and a barrier every kBuffers
// steps orders them.
__host__ __device__ __forceinline__ int ring_len(int nop) {
  return nop + 2 * ((nop - 1) >> 1) + 2;
}

template <typename T>
struct DiffuseSmem {
  RingSlot<T>* rings;
  T* warp_sums;
  float* noise;

  __device__ DiffuseSmem(unsigned char* raw, int buffers, int len)
      : rings(reinterpret_cast<RingSlot<T>*>(raw)),
        warp_sums(reinterpret_cast<T*>(rings + buffers * len)),
        noise(reinterpret_cast<float*>(warp_sums + 32)) {}

  static size_t bytes(int buffers, int nop, int threads) {
    return static_cast<size_t>(buffers) * ring_len(nop) *
               sizeof(RingSlot<T>) +
           32 * sizeof(T) + static_cast<size_t>(threads) * sizeof(float);
  }
};

// Rings of a block size's instantiation: 4 up to 256 threads; at 1024,
// 2 in float and 1 in double, which keeps the rings within 48 KB.
template <typename T>
__host__ __device__ constexpr int ring_buffers(int threads) {
  return threads <= 256 ? 4 : sizeof(T) == 4 ? 2 : 1;
}

// CTAs of kThreads that the launch bounds keep resident on an SM: 64
// registers a thread, float and double.
constexpr int diffuse_min_ctas(int threads) { return 1024 / threads; }

// One CTA per walker, thread i < nop is particle i; kThreads is the block
// size's bound (128, 256 or 1024), blockDim.x = nop rounded up to a warp.
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, diffuse_min_ctas(kThreads))
diffuse_kernel(const T* __restrict__ cpos, const T* __restrict__ cdrift,
               const T* __restrict__ cenergy, const T* __restrict__ params,
               const T* __restrict__ xi, const T* __restrict__ e_ref, T dt,
               T sigma, const qmc::PhiloxKeys keys, uint32_t s0, uint32_t s1,
               T* __restrict__ npos, T* __restrict__ nenergy,
               T* __restrict__ ndrift, T* __restrict__ nweight, int nop,
               int is_free, int is_ideal, int defects_sep) {
  constexpr int kBuffers = ring_buffers<T>(kThreads);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int steps = (nop - 1) >> 1;
  const int len = ring_len(nop);
  const DiffuseSmem<T> smem(smem_raw, kBuffers, len);

  const size_t walker = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < nop;
  const size_t base = walker * nop;

  if (xi == nullptr) {
    // Thread t draws quad base / 4 + t; the walker's elements start at
    // element off of the first quad.
    const int off = static_cast<int>(base & 3);
    if (i < (off + nop + 3) >> 2) {
      const unsigned long long q = (base >> 2) + i;
      const uint4 w = qmc::philox4x32_10(static_cast<uint32_t>(q),
                                         static_cast<uint32_t>(q >> 32), s0,
                                         s1, keys);
      float z[4];
      qmc::box_muller(w.x, w.y, &z[0], &z[1]);
      qmc::box_muller(w.z, w.w, &z[2], &z[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int local = 4 * i + k - off;
        if (local >= 0 && local < nop) smem.noise[local] = z[k];
      }
    }
    __syncthreads();
  }

  const T length = params[qmc::P_L];
  T z_move = 0, z_pair = 0;
  if (active) {
    const size_t e = base + i;
    const T noise = xi != nullptr ? xi[e] : static_cast<T>(smem.noise[i]);
    const T moved = add_rn(add_rn(cpos[e], mul_rn(mul_rn(T(2), cdrift[e]), dt)),
                           mul_rn(sigma, noise));
    z_move = add_rn(T(0), floor_mod(moved, length));
    npos[e] = z_move;
    z_pair = qmc::into_supercell(z_move, length);
    for (int b = 0; b < kBuffers; ++b) {
      smem.rings[b * len + i] = {z_pair, T(0)};
      if (i <= steps) smem.rings[b * len + nop + i] = {z_pair, T(0)};
    }
  }
  for (int s = nop + steps + 1 + i; s < len; s += blockDim.x) {
    for (int b = 0; b < kBuffers; ++b) smem.rings[b * len + s] = {T(0), T(0)};
  }
  __syncthreads();

  OwnSums<T> own;
  T out_kin = 0;
  if (!is_ideal) {
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
          ring_pair<T, true>(z_pair, slot[b], c, active, &own);
          slot[b] += kBuffers;
        }
        __syncthreads();
      }
#pragma unroll
      for (int b = 0; b < kBuffers - 1; ++b) {
        if (k + b <= steps) {
          ring_pair<T, true>(z_pair, slot[b], c, active, &own);
        }
      }
    } else {
      // Each step guarded, so that the kernel holds one copy of double's
      // much longer body (sincos and the divide): a separate copy of the
      // last steps made it slower at N = 64.
      for (int k = 1; k <= steps; k += kBuffers) {
#pragma unroll
        for (int b = 0; b < kBuffers; ++b) {
          if (k + b <= steps) {
            ring_pair<T, true>(z_pair, slot[b], c, active, &own);
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
      ring_pair<T, false>(z_pair,
                          ring + ((steps + 1) % kBuffers) * len + steps + 1,
                          c, true, &own);
    }
    __syncthreads();
  }

  T drift_i = 0, kin_i = 0, pot_i = 0;
  if (active) {
    if (!is_free) {
      one_body_terms(z_move, params, defects_sep, &drift_i, &kin_i, &pot_i);
    }
    if (!is_ideal) {
      // The j sides of particle i: its slots i and, for i <= steps,
      // nop + i of every ring.
      T j = 0;
      for (int b = 0; b < kBuffers; ++b) {
        j += smem.rings[b * len + i].j;
        if (i <= steps) j += smem.rings[b * len + nop + i].j;
      }
      drift_i += own.f + j;
      // The particle's share of the walker's kinetic pair sum: nop - 1
      // times (pi/L)^2 beta, and twice its pairs' kinetic terms less that.
      kin_i += T(nop - 1) * out_kin +
               T(2) * d_fma(params[qmc::P_BETA], own.u2, own.kin);
    }
    ndrift[base + i] = drift_i;
  }
  T sums[1] = {d_fma(-drift_i, drift_i, kin_i) + pot_i};
  qmc::block_sums(sums, smem.warp_sums);
  if (threadIdx.x == 0) {
    const T energy = sums[0];
    nenergy[walker] = energy;
    const T mean = mul_rn(T(0.5), add_rn(energy, cenergy[walker]));
    nweight[walker] = d_exp(mul_rn(-dt, sub_rn(mean, e_ref[0])));
  }
}

template <typename T, int kThreads>
void launch_diffuse(const void* cpos, const void* cdrift, const void* cenergy,
                    const void* params, const void* xi, const void* e_ref,
                    double dt, double sigma, const qmc::PhiloxKeys& keys,
                    unsigned long long step, void* npos, void* nenergy,
                    void* ndrift, void* nweight, int num_walkers, int nop,
                    int is_free, int is_ideal, int defects_sep, int threads,
                    cudaStream_t stream) {
  diffuse_kernel<T, kThreads><<<
      num_walkers, threads,
      DiffuseSmem<T>::bytes(ring_buffers<T>(kThreads), nop, threads),
      stream>>>(
          static_cast<const T*>(cpos), static_cast<const T*>(cdrift),
          static_cast<const T*>(cenergy), static_cast<const T*>(params),
          static_cast<const T*>(xi), static_cast<const T*>(e_ref),
          static_cast<T>(dt), static_cast<T>(sigma), keys,
          static_cast<uint32_t>(step), static_cast<uint32_t>(step >> 32),
          static_cast<T*>(npos), static_cast<T*>(nenergy),
          static_cast<T*>(ndrift), static_cast<T*>(nweight), nop, is_free,
          is_ideal, defects_sep);
}

template <typename T>
int launch(const void* cpos, const void* cdrift, const void* cenergy,
           const void* params, const void* xi, const void* e_ref, double dt,
           double sigma, unsigned long long key, unsigned long long step,
           void* npos, void* nenergy, void* ndrift, void* nweight,
           int num_walkers, int nop, int is_free, int is_ideal,
           int defects_sep, void* stream) {
  if (num_walkers <= 0 || nop <= 0 || nop > kMaxThreads ||
      defects_sep < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((nop + 31) / 32) * 32;
  const qmc::PhiloxKeys keys(static_cast<uint32_t>(key),
                             static_cast<uint32_t>(key >> 32));
  // The instantiation by block size: the registers a small block can have.
  auto* run = threads <= 128   ? launch_diffuse<T, 128>
              : threads <= 256 ? launch_diffuse<T, 256>
                               : launch_diffuse<T, kMaxThreads>;
  run(cpos, cdrift, cenergy, params, xi, e_ref, dt, sigma, keys, step,
         npos, nenergy, ndrift, nweight, num_walkers, nop, is_free, is_ideal,
         defects_sep, threads, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_diffuse_energy_drift_f32(
    const void* cpos, const void* cdrift, const void* cenergy,
    const void* params, const void* xi, const void* e_ref, double dt,
    double sigma, unsigned long long key, unsigned long long step,
    void* npos, void* nenergy, void* ndrift, void* nweight, int num_walkers,
    int nop, int is_free, int is_ideal, int defects_sep, void* stream) {
  return launch<float>(cpos, cdrift, cenergy, params, xi, e_ref, dt, sigma,
                       key, step, npos, nenergy, ndrift, nweight, num_walkers,
                       nop, is_free, is_ideal, defects_sep, stream);
}

extern "C" int qmc_diffuse_energy_drift_f64(
    const void* cpos, const void* cdrift, const void* cenergy,
    const void* params, const void* xi, const void* e_ref, double dt,
    double sigma, unsigned long long key, unsigned long long step,
    void* npos, void* nenergy, void* ndrift, void* nweight, int num_walkers,
    int nop, int is_free, int is_ideal, int defects_sep, void* stream) {
  return launch<double>(cpos, cdrift, cenergy, params, xi, e_ref, dt, sigma,
                        key, step, npos, nenergy, ndrift, nweight, num_walkers,
                        nop, is_free, is_ideal, defects_sep, stream);
}
