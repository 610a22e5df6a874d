// Full-stream globalisation G = T + S: one complete add per stream
// position, the per-lane column prefix S broadcast over the rows.
//
// Replaces tpu_msm/cuzk/kernels.py `_globalize_kernel` / `globalize`.
// Bound on the H100: operations. One complete add (12 word-wide
// Montgomery multiplies, mul_wide.cuh) per position against 3 L elements
// read from T and 3 L written; S is R times smaller and stays in cache.
// With one thread a position and the points in the thread (the kernel
// this replaces) a launch waited on one thread's chain of 12 dependent
// multiplies.
// Design: padd_batch.cu's, from padd_lane.cuh: each of the n = R F
// positions is a lane of 6 threads of one warp, 5 lanes a warp, in
// blocks of 1 to 4 warps (cuzk/kernels.py `padd_batch_geometry` over n
// lanes); the block loads each (coordinate, limb) row of its lanes of T
// coalesced into shared memory, and q from S at lane idx mod F (still
// consecutive words, but where a row of the stream wraps; the modulo in
// 32 bits, so n < 2^32); the add runs
// in padd_lane.cuh's four phases, and the block stores the sums row by
// row in the requested dtype, coalesced. Lane indices and offsets are
// int64: 3 L R F passes 2^31 at the 2^20 shapes. The TPU kernel's
// (8, F8) block layout and its aliasing of the output onto T are not
// carried over: the layout is the scan's own, and the wrapper allocates
// the output.
// Layouts: T, out (3, L, R, F); S (3, L, F); lane-major.
#include "padd_lane.cuh"

#include <cstring>

namespace {

template <int L, int W, typename Tin, typename Tout>
__global__ void __launch_bounds__(msm::kPaddMaxWarps * 32)
globalize_kernel(const Tin* __restrict__ tbuf, const Tin* __restrict__ sbuf,
                 Tout* __restrict__ out, int64_t n, int64_t F,
                 const int32_t* __restrict__ kc,
                 const msm::WideConsts<L, W> KW) {
  msm::padd_block<L, W, Tin, Tout, true>(tbuf, sbuf, out, n, F, 0, kc, KW);
}

}  // namespace

// n = R * F stream positions, fewer than 2^32; in_bits / out_bits: 16 or 32;
// threads_per_lane must be kAddG; warps a block (1 to 4) and blocks
// from cuzk/kernels.py padd_batch_geometry over n lanes, which must cover
// n; wide: host memory, the words of msm::WideConsts<L, W>.
extern "C" int msm_globalize(int num_limbs, int limb_bits, int in_bits,
                             int out_bits, const void* tbuf, const void* sbuf,
                             void* out, int64_t n, int64_t F,
                             int threads_per_lane, int warps, int blocks,
                             const int32_t* consts, const uint32_t* wide,
                             void* stream) {
  if (F < 1 || n < F || n % F || n >> 32 || threads_per_lane != msm::kAddG ||
      warps < 1 || warps > msm::kPaddMaxWarps || blocks < 1 ||
      (int64_t)blocks * warps * msm::kPaddLanesPerWarp < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    return msm::dispatch_widths(in_bits, out_bits, [&](auto tin, auto tout) {
      using Tin = decltype(tin);
      using Tout = decltype(tout);
      return msm::launch_padd_lanes<L>(
          globalize_kernel<L, W, Tin, Tout>, warps, blocks, s,
          static_cast<const Tin*>(tbuf), static_cast<const Tin*>(sbuf),
          static_cast<Tout*>(out), n, F, consts, KW);
    });
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
