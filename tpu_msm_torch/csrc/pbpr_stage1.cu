// Stage 1 of the parallel bucket-points reduction (cuZK Alg. 4): the m/g
// running sums of every bucket slice.
//
// Replaces tpu_msm/cuzk/kernels.py `_pbpr_kernel` / `pbpr_stage1`.
// What it computes, in the plain version's order: for each lane (window
// w, slice t), the Bt = B / T buckets t Bt + Bt - 1 - j, j = 0 .. Bt - 1,
// from the top down, with m += bucket; g += m, both from infinity.
// Bound on the H100: operations in total (per window 2 B complete adds of
// 12 word-wide Montgomery multiplies, mul_wide.cuh, against 3 L elements
// read per bucket and 6 L words written per slice), but depth at the
// shapes the reduction gives it: 8,192 lanes at 2^20 (Wp = 16, T = 512),
// each a chain of 2 Bt dependent adds. With one thread a lane and the
// points in the thread (the kernel this replaces) each link of that chain
// was one thread's twelve multiplies one after another.
// Design: the lanes of pbpr_lane.cuh (12 threads a lane, its m add and g
// add at once on padd_lane.cuh's shared add, the next bucket by
// cp.async), which pbpr_full.cu's stage 1 runs too; this kernel stores m
// and g as int32.
// Layouts: buckets (3, L, Wp, B) int16 or int32; m, g (3, L, Wp, T) int32.
#include "pbpr_lane.cuh"

#include <cstring>

namespace {

template <int L, int W, typename Tin>
__global__ void __launch_bounds__(msm::kStage1MaxWarps * 32,
                                  msm::stage1_min_blocks(L))
stage1_kernel(const Tin* __restrict__ buckets, int32_t* __restrict__ m_out,
              int32_t* __restrict__ g_out, int Wp, int B, int T,
              const int32_t* __restrict__ kc,
              const msm::WideConsts<L, W> KW) {
  msm::stage1_block<L, W, Tin, int32_t>(buckets, m_out, g_out,
                                        (int64_t)Wp * T, Wp, B, T, kc, KW);
}

}  // namespace

// in_bits: 16 or 32, the width of the bucket elements (16: 4-byte aligned
// and 3 L Wp B even); 3 L Wp B < 2^31; threads_per_chain must be kAddG
// (the wrapper's lane count rests on it); warps a block (1 to
// kStage1MaxWarps) and blocks from cuzk/kernels.py pbpr_stage1_geometry,
// which must cover the Wp T lanes; wide: host memory, the words of
// msm::WideConsts<L, W>.
extern "C" int msm_pbpr_stage1(int num_limbs, int limb_bits, int in_bits,
                               const void* buckets, int32_t* m_out,
                               int32_t* g_out, int Wp, int B, int T,
                               int threads_per_chain, int warps, int blocks,
                               const int32_t* consts, const uint32_t* wide,
                               void* stream) {
  if (Wp < 1 || B < 1 || T < 1 || B % T || 3LL * num_limbs * Wp * B >> 31 ||
      threads_per_chain != msm::kAddG || warps < 1 ||
      warps > msm::kStage1MaxWarps || blocks < 1 ||
      (int64_t)blocks * warps * msm::kStage1LanesPerWarp < (int64_t)Wp * T ||
      (in_bits != 16 && in_bits != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    if (in_bits == 16 && (3LL * L * Wp * B) % 2)
      return static_cast<int>(cudaErrorInvalidValue);
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    constexpr int words = msm::Stage1Lane<L>::WARP_WORDS;
    return in_bits == 16
               ? msm::launch_lanes(stage1_kernel<L, W, int16_t>, warps, words,
                                   blocks, s,
                                   static_cast<const int16_t*>(buckets),
                                   m_out, g_out, Wp, B, T, consts, KW)
               : msm::launch_lanes(stage1_kernel<L, W, int32_t>, warps, words,
                                   blocks, s,
                                   static_cast<const int32_t*>(buckets),
                                   m_out, g_out, Wp, B, T, consts, KW);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
