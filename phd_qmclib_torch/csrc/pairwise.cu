// Fused Bijl-Jastrow local energy, drift and (optionally) log|psi| for
// the mrbp model.
//
// Replaces the Pallas TPU kernel phd_qmclib_tpu/ops/pairwise.py::_kernel
// (wrapper energy_and_drift_pallas), both of its variants, as one
// template with a compile-time flag kLogPsi:
//   * forward (with_log_psi=False, the DMC step): E_L (W,) and the drift
//     (W, N);
//   * log (with_log_psi=True, the VMC step): log|psi| (W,) as well.
// For every walker it computes the one-body Kronig-Penney terms (orbital
// log-derivative, kinetic, barrier/defect potential, and with kLogPsi
// log|f1|) and the O(N^2) minimum-image phonon pair block, one
// branch-selected tan/cot per unordered pair (and one log with kLogPsi).
// The walker's body lives in pair_terms.cuh, which the fused diffusion
// kernel (diffuse.cu) shares.  Both variants take a table of parameter
// rows: walker w reads row w / walkers_per_row, so that one launch serves
// the rows of a fused parameter sweep (a single sampling passes one row
// and walkers_per_row = num_walkers).  Only the row's address differs, so
// a sweep row's arithmetic is its single-row launch's, bit for bit.
//
// What bounds it on the H100: FP32 instruction issue.  The only memory
// traffic is N positions in and N + 1 (N + 2 with kLogPsi) values out per
// walker: 17.8 MB at 17408 x 128 against 141.5 M unordered pairs.
// Counted in float as written (pair_terms.cuh; fma = 2, rcp and lg2 = 1),
// an unordered pair costs 28 flops, 40 with kLogPsi: ~220 flops per byte,
// ten times the card's 20 (67 TFLOP/s over 3.35 TB/s).  The real limit is
// instruction issue: the f32 pair loop's SASS holds 44 instructions per
// unordered pair (49.5 with kLogPsi; compares, selects, one LDS.128, one
// STS.64, the barrier and the ring index besides the arithmetic), and an
// issue slot retires at most one FMA, so the flops fill at most a third
// of the slots.  The first design (one thread per particle over all
// j != i) evaluated every pair twice, with an IEEE divide, a rintf on the
// conversion pipe and, with kLogPsi, an accurate logf per ordered pair:
// ~84 instructions per unordered pair in f32, ~154 with kLogPsi.
//
// What the design does about it: one CTA per walker, one thread per
// particle, the walker's positions in shared memory.  Each unordered pair
// is evaluated once on a half ring (walker_terms): the odd drift term goes
// to i and, negated, to j, the even kinetic term to both, the j side
// through a shared-memory slot per particle, a barrier per step.  The
// minimum image is two compares and a select (positions in [0, L)), the
// tan/cot ratio one MUFU reciprocal, the pair log one MUFU log2; log|f2|
// needs no j side, as only its walker sum is wanted.  The energy and
// log|psi| terms are reduced in one pass (block_sums).  No pair value
// ever leaves the registers.  Any N up to 1024, float and double; the
// free-gas and ideal-gas branches are uniform flags read once per thread.
//
// Accuracy: built without --use_fast_math: the one-body tanf/tanhf/cosf/
// coshf/logf are the accurate ones.  The approximate reciprocal and log2
// stay well inside the kernel-vs-plain tolerances of chip_smoke.py and
// tests/test_torch_cuda_kernels.py; double keeps the IEEE divide, sincos
// and log, and is the oracle of the schedule.  E_L sums per-particle terms
// (kin_i - drift_i^2 + pot_i) before the block reduction, the order of
// the Pallas kernel and of the plain torch version: the kinetic and
// drift^2 sums are each large against E_L and cancel.
//
// The parameter VJP (pair_logpsi_params_vjp_kernel) is the backward of the
// log variant with respect to the packed parameters: per walker w the row
// g_lp[w] dlog|psi|_w/dp + g_E[w] dE_w/dp over the 16 slots, which the
// wrapper sums over the walkers.  It has no Pallas counterpart: it stands
// for XLA's autodiff of the JAX package's log_psi_and_energy, which the
// gradient optimizer of the trial function differentiates.  Its body is in
// pair_terms_grad.cuh.  The same layout: one CTA per walker, one thread
// per particle, each unordered pair once on the half ring; its pair terms
// need no j side (only walker sums are wanted), so the loop holds no
// barrier and no shared-memory write.  Bounded, like the forward, by FP32
// instruction issue: 39 flops a pair inside the cutoff and 35 outside
// (chip_smoke.py's count) for the forward's bytes.
//
// What held the first design back, from its SASS: 45 instructions a pair
// common to both branches, then 20 outside the cutoff and 19 inside; the
// 16 slot sums live through the loop (the one-body terms came first) and
// 9 pair sums beside them, 53 registers in float and spills in double
// under the one launch bound of 1024 threads; each slot reduced on its own
// (80 shuffles a thread).  What this design does about it:
//   * one form of the pair's derivatives for both branches
//     (pair_terms_grad.cuh): the branch selects its operands, and the
//     weights (g_E, g_lp and the parameters) are the thread's constants: a
//     pair outside the cutoff adds t, fs v, log t, G and r G to plain sums,
//     weighted once after the loop; log sin = -log(1 + cot^2) / 2 needs
//     only the ratio, so float takes the forward variant's rational tan
//     (8 instructions) where the sin/cos polynomials took 12;
//   * pairs inside the cutoff are rare (0.6% of them at the bench's
//     density): a warp vote per step runs the body with every select
//     folded to the outside operand unless a lane of the warp holds one,
//     so the lanes never diverge; there the drift factor is one
//     difference and a select;
//   * the positions and -2 F twice over in shared memory (nop + steps
//     slots), so that the ring's partner is an immediate offset, one
//     8-byte load a pair, no wrap test;
//   * the one-body terms after the loop; instantiations by block size
//     (128, 256, 1024 threads) whose launch bounds give 64 registers in
//     float and 80 in double up to 256 threads (no spills);
//   * the 16 slots reduced and scattered across a warp at once
//     (block_row_sums: 16 shuffles), written by 16 threads.
// No atomics: the rows and their torch sum are deterministic.  Double keeps
// the IEEE divide, sincos and log.
#include <cuda_runtime.h>

#include "pair_terms.cuh"
#include "pair_terms_grad.cuh"

namespace {

using qmc::kMaxThreads;

template <typename T, bool kLogPsi>
__global__ void __launch_bounds__(kMaxThreads)
pair_energy_drift_kernel(const T* __restrict__ pos,
                         const T* __restrict__ params,
                         T* __restrict__ energy, T* __restrict__ drift,
                         T* __restrict__ log_psi, int walkers_per_row,
                         int nop, int is_free, int is_ideal,
                         int defects_sep) {
  extern __shared__ __align__(32) unsigned char smem_raw[];
  const qmc::WalkerSmem<T> smem(smem_raw);

  const size_t walker = blockIdx.x;
  const int i = threadIdx.x;
  // The walker's row of the parameter table (a sweep's rows, each
  // walkers_per_row walkers; one row for a single sampling).
  params += walker / static_cast<size_t>(walkers_per_row) * qmc::kParamsSize;
  const T zi = i < nop ? pos[walker * nop + i] : T(0);
  smem.slots[i] = {qmc::into_supercell(zi, params[qmc::P_L]), T(0), T(0),
                   T(0)};
  __syncthreads();

  T drift_i, term, log_i;
  qmc::walker_terms<T, kLogPsi>(smem.slots, nop, zi, params, is_free,
                                is_ideal, defects_sep, &drift_i, &term,
                                &log_i);
  if (i < nop) drift[walker * nop + i] = drift_i;

  // One reduction pass for the energy and, with kLogPsi, log|psi|.
  if constexpr (kLogPsi) {
    T sums[2] = {term, log_i};
    qmc::block_sums(sums, smem.warp_sums);
    if (i == 0) {
      energy[walker] = sums[0];
      log_psi[walker] = sums[1];
    }
  } else {
    T sums[1] = {term};
    qmc::block_sums(sums, smem.warp_sums);
    if (i == 0) energy[walker] = sums[0];
  }
}

template <typename T, bool kLogPsi>
int launch(const void* pos, const void* params, void* log_psi, void* energy,
           void* drift, int num_walkers, int walkers_per_row, int nop,
           int is_free, int is_ideal, int defects_sep, void* stream) {
  if (num_walkers <= 0 || walkers_per_row <= 0 ||
      num_walkers % walkers_per_row != 0 || nop <= 0 || nop > kMaxThreads ||
      defects_sep < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((nop + 31) / 32) * 32;
  pair_energy_drift_kernel<T, kLogPsi>
      <<<num_walkers, threads, qmc::WalkerSmem<T>::bytes(threads),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pos), static_cast<const T*>(params),
          static_cast<T*>(energy), static_cast<T*>(drift),
          static_cast<T*>(log_psi), walkers_per_row, nop, is_free, is_ideal,
          defects_sep);
  return static_cast<int>(cudaGetLastError());
}

// One particle's entry in the VJP's shared memory: its position in [0, L)
// and -2 times its drift (the factor of dldz in dE).
template <typename T>
struct alignas(2 * sizeof(T)) VjpSlot {
  T z, g;
};

// CTAs of kThreads that the VJP's launch bounds keep resident on an SM:
// 64 registers a thread in float (1024 threads a SM), 80 in double (768)
// up to 256 threads; 64 at 1024 threads either way.
template <typename T>
constexpr int vjp_min_ctas(int threads) {
  return threads >= 1024 ? 1 : (sizeof(T) == 4 ? 1024 : 768) / threads;
}

// One CTA per walker, thread i < nop is particle i; kThreads is the block
// size's bound (128, 256 or 1024), blockDim.x = nop rounded up to a warp.
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, vjp_min_ctas<T>(kThreads))
pair_logpsi_params_vjp_kernel(const T* __restrict__ pos,
                              const T* __restrict__ params,
                              const T* __restrict__ drift,
                              const T* __restrict__ g_lp,
                              const T* __restrict__ g_e,
                              T* __restrict__ rows, int nop, int is_free,
                              int is_ideal, int defects_sep) {
  using qmc::kParamsSize;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  T* warp_sums = reinterpret_cast<T*>(smem_raw);  // 32 per slot
  VjpSlot<T>* slots = reinterpret_cast<VjpSlot<T>*>(warp_sums +
                                                    32 * kParamsSize);

  const size_t walker = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < nop;
  const T* walker_pos = pos + walker * nop;
  const T* walker_drift = drift + walker * nop;
  const T length = params[qmc::P_L];
  // Slot s < nop + steps holds particle s mod nop, so that thread i's
  // partners i + 1 .. i + steps need no wrap test.
  const int steps = (nop - 1) >> 1;
  for (int s = i; s < nop + steps; s += blockDim.x) {
    const int p = s < nop ? s : s - nop;
    slots[s] = {qmc::into_supercell(walker_pos[p], length),
                T(-2) * walker_drift[p]};
  }
  __syncthreads();

  const T ge = g_e[walker], glp = g_lp[walker];
  qmc::PairVjpSums<T> sums;
  if (!is_ideal) {
    // The threads past nop walk thread 0's ring with every pair outside
    // (rm < 0), so that every lane of a warp votes at every step; their
    // sums are dropped.
    const qmc::PairVjpConsts<T> c(params, ge, glp,
                                  active ? params[qmc::P_RM] : T(-1));
    const VjpSlot<T>* ring = slots + (active ? i : 0);
    const T z_own = ring[0].z, g_own = ring[0].g;
    auto pair = [&](const VjpSlot<T>& other, bool vote) {
      const T d = z_own - other.z;
      const T ad = qmc::d_fabs(d);
      const bool wrap = ad > c.half_l;
      const T r = wrap ? c.L - ad : ad;
      const bool in = r < c.rm;
      if (!vote || __builtin_expect(__any_sync(0xffffffffu, in), 0)) {
        qmc::pair_vjp_terms<T, true>(d, r, wrap, in, g_own, other.g, c,
                                     &sums);
      } else {
        qmc::pair_vjp_terms<T, false>(d, r, wrap, in, g_own, other.g, c,
                                      &sums);
      }
    };
#pragma unroll 4
    for (int k = 1; k <= steps; ++k) pair(ring[k], true);
    const int half = nop >> 1;
    if (nop == 2 * half && i < half) pair(ring[half], false);
  }

  // The one-body terms after the pair loop, so that only the pair sums
  // live through it.
  T acc[kParamsSize];
  for (int p = 0; p < kParamsSize; ++p) acc[p] = T(0);
  if (active) {
    if (!is_free) {
      qmc::one_body_grad_terms(walker_pos[i], walker_drift[i], params,
                               defects_sep, ge, glp, acc);
    }
    if (!is_ideal) qmc::add_pair_slots(sums, params, ge, glp, acc);
  }
  qmc::block_row_sums(acc, warp_sums, rows + walker * kParamsSize);
}

template <typename T, int kThreads>
void launch_vjp(const void* pos, const void* params, const void* drift,
                const void* g_lp, const void* g_e, void* rows,
                int num_walkers, int nop, int is_free, int is_ideal,
                int defects_sep, int threads, size_t smem,
                cudaStream_t stream) {
  pair_logpsi_params_vjp_kernel<T, kThreads>
      <<<num_walkers, threads, smem, stream>>>(
          static_cast<const T*>(pos), static_cast<const T*>(params),
          static_cast<const T*>(drift), static_cast<const T*>(g_lp),
          static_cast<const T*>(g_e), static_cast<T*>(rows), nop, is_free,
          is_ideal, defects_sep);
}

template <typename T>
int launch_params_vjp(const void* pos, const void* params, const void* drift,
                      const void* g_lp, const void* g_e, void* rows,
                      int num_walkers, int nop, int is_free, int is_ideal,
                      int defects_sep, void* stream) {
  if (num_walkers <= 0 || nop <= 0 || nop > kMaxThreads ||
      defects_sep < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((nop + 31) / 32) * 32;
  const size_t smem = 32 * qmc::kParamsSize * sizeof(T) +
                      (nop + ((nop - 1) >> 1)) * sizeof(VjpSlot<T>);
  const auto s = static_cast<cudaStream_t>(stream);
  // The instantiation by block size: the registers a small block can have.
  auto* launch = threads <= 128   ? launch_vjp<T, 128>
                 : threads <= 256 ? launch_vjp<T, 256>
                                  : launch_vjp<T, kMaxThreads>;
  launch(pos, params, drift, g_lp, g_e, rows, num_walkers, nop, is_free,
         is_ideal, defects_sep, threads, smem, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qmc_pair_logpsi_params_vjp_f32(
    const void* pos, const void* params, const void* drift, const void* g_lp,
    const void* g_e, void* rows, int num_walkers, int nop, int is_free,
    int is_ideal, int defects_sep, void* stream) {
  return launch_params_vjp<float>(pos, params, drift, g_lp, g_e, rows,
                                  num_walkers, nop, is_free, is_ideal,
                                  defects_sep, stream);
}

extern "C" int qmc_pair_logpsi_params_vjp_f64(
    const void* pos, const void* params, const void* drift, const void* g_lp,
    const void* g_e, void* rows, int num_walkers, int nop, int is_free,
    int is_ideal, int defects_sep, void* stream) {
  return launch_params_vjp<double>(pos, params, drift, g_lp, g_e, rows,
                                   num_walkers, nop, is_free, is_ideal,
                                   defects_sep, stream);
}

extern "C" int qmc_pair_energy_drift_f32(const void* pos, const void* params,
                                         void* energy, void* drift,
                                         int num_walkers, int walkers_per_row,
                                         int nop, int is_free, int is_ideal,
                                         int defects_sep, void* stream) {
  return launch<float, false>(pos, params, nullptr, energy, drift,
                              num_walkers, walkers_per_row, nop, is_free,
                              is_ideal, defects_sep, stream);
}

extern "C" int qmc_pair_energy_drift_f64(const void* pos, const void* params,
                                         void* energy, void* drift,
                                         int num_walkers, int walkers_per_row,
                                         int nop, int is_free, int is_ideal,
                                         int defects_sep, void* stream) {
  return launch<double, false>(pos, params, nullptr, energy, drift,
                               num_walkers, walkers_per_row, nop, is_free,
                               is_ideal, defects_sep, stream);
}

extern "C" int qmc_pair_logpsi_energy_drift_f32(
    const void* pos, const void* params, void* log_psi, void* energy,
    void* drift, int num_walkers, int walkers_per_row, int nop, int is_free,
    int is_ideal, int defects_sep, void* stream) {
  return launch<float, true>(pos, params, log_psi, energy, drift,
                             num_walkers, walkers_per_row, nop, is_free,
                             is_ideal, defects_sep, stream);
}

extern "C" int qmc_pair_logpsi_energy_drift_f64(
    const void* pos, const void* params, void* log_psi, void* energy,
    void* drift, int num_walkers, int walkers_per_row, int nop, int is_free,
    int is_ideal, int defects_sep, void* stream) {
  return launch<double, true>(pos, params, log_psi, energy, drift,
                              num_walkers, walkers_per_row, nop, is_free,
                              is_ideal, defects_sep, stream);
}
