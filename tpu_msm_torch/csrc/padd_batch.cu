// Batched complete projective add; psub_batch is the same kernel with q
// negated as it loads.
//
// Replaces tpu_msm/cuzk/kernels.py `_padd_kernel` / `padd_batch`, and
// `psub_batch` (its `pneg_stacked` copy of q included).
// Bound on the H100: operations at the main path's widths (32,769
// lanes at 2^20): 12 word-wide Montgomery multiplies (mul_wide.cuh, 315
// int32 multiply and multiply-add halves each at L = 22) against 6 L
// elements in and 3 L out per lane. With one thread a lane and the
// points in the thread (the kernel this replaces) a launch waited on one
// thread's chain of 12 dependent multiplies with 8 warps an SM.
// Design: the lanes of a one-shot batch add of padd_lane.cuh. kAddG = 6
// threads of one warp share a lane, so a thread makes one multiply a
// level (2 threads a lane, three multiplies each, were timed too: slower
// with 32,769 lanes, level with 16,388; PERF.md). The block, of 1 to 4
// warps (cuzk/kernels.py `padd_batch_geometry`), loads its lanes' limbs
// into shared memory row by row, coalesced; q.y becomes 4p - y there for
// psub_batch (`negate`), in q's dtype, as pneg_stacked computes it. The
// add runs in padd_lane.cuh's four phases on the lane's shared memory,
// and the block stores the sums row by row, coalesced.
// Layout: p, q, out (3, L, F), lane-major.
#include "padd_lane.cuh"

#include <cstring>

namespace {

template <int L, int W, typename Tin, typename Tout>
__global__ void __launch_bounds__(msm::kPaddMaxWarps * 32)
padd_kernel(const Tin* __restrict__ p, const Tin* __restrict__ q,
            Tout* __restrict__ out, int64_t F, int negate,
            const int32_t* __restrict__ kc, const msm::WideConsts<L, W> KW) {
  msm::padd_block<L, W, Tin, Tout, false>(p, q, out, F, F, negate, kc,
                                          KW);
}

}  // namespace

// in_bits / out_bits: 16 or 32, the width of the int elements; negate:
// 1 for p - q; threads_per_lane must be kAddG (the wrapper's lane count
// rests on it); warps a block (1 to 4) and blocks from cuzk/kernels.py
// padd_batch_geometry, which must cover F; wide: host memory, the words
// of msm::WideConsts<L, W>.
extern "C" int msm_padd_batch(int num_limbs, int limb_bits, int in_bits,
                              int out_bits, const void* p, const void* q,
                              void* out, int64_t F, int negate,
                              int threads_per_lane, int warps, int blocks,
                              const int32_t* consts, const uint32_t* wide,
                              void* stream) {
  if (F < 1 || threads_per_lane != msm::kAddG || warps < 1 ||
      warps > msm::kPaddMaxWarps || blocks < 1 ||
      (int64_t)blocks * warps * msm::kPaddLanesPerWarp < F)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    return msm::dispatch_widths(in_bits, out_bits, [&](auto tin, auto tout) {
      using Tin = decltype(tin);
      using Tout = decltype(tout);
      return msm::launch_padd_lanes<L>(
          padd_kernel<L, W, Tin, Tout>, warps, blocks, s,
          static_cast<const Tin*>(p), static_cast<const Tin*>(q),
          static_cast<Tout*>(out), F, negate, consts, KW);
    });
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
