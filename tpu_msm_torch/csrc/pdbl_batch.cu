// Batched complete projective doubling.
//
// Replaces tpu_msm/cuzk/kernels.py `_pdbl_kernel` / `pdbl_batch`.
// Bound on the H100: operations with many lanes (9 word-wide Montgomery
// multiplies a lane, mul_wide.cuh, 315 int32 multiply and multiply-add
// halves each at L = 22, against 3 L words in and 3 L out), depth with
// few: the reduction path (cuzk/pbpr.py) doubles 16 lanes at 2^20. With
// one thread a lane on the 12-bit multiply (the kernel this replaces) a
// doubling was 9 dependent multiplies in one thread.
// Design: the doubling of padd_lane.cuh in three product levels, kDblG =
// 4 threads of one warp a lane, 8 lanes a warp, so every thread of a
// warp works: levels 1 and 3 are one product a thread, and the chain is
// three multiplies deep. The block, of 1 to 4 warps (cuzk/kernels.py
// `pdbl_batch_geometry`), loads its lanes' limbs into shared memory row
// by row, coalesced (each (coordinate, limb) row of the lanes is
// contiguous in device memory), the doubling runs on the lane's words
// (the point, then DblScratch) and the sum, back in the point's words,
// is stored row by row, coalesced.
// Layout: p, out (3, L, F) int32, lane-major.
#include "padd_lane.cuh"

#include <cstring>

namespace {

constexpr int kMaxWarps = 4;   // warps a block at most; the wrapper picks

// A lane's int32 words, which its kDblG threads share: the point, then the
// doubling's scratch.
template <int L>
struct DblLane {
  static constexpr int S = 3 * L;
  static constexpr int WORDS = S + msm::DblScratch<L>::WORDS;   // 11 L
  static constexpr int STRIDE = WORDS | 1;   // odd: lanes on distinct banks
};

template <int L, int W>
__global__ void __launch_bounds__(kMaxWarps * 32)
pdbl_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ out,
            int64_t n, const int32_t* __restrict__ kc,
            const msm::WideConsts<L, W> KW) {
  constexpr int G = msm::kDblG, LPW = 32 / G;
  using M = DblLane<L>;
  using D = msm::DblPhases<L, W>;
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  extern __shared__ int32_t lanes[];     // [lanes a block][STRIDE]
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);            // ends in __syncthreads

  // element (row, lane l) <-> thread l + lpb * (row mod G)
  const int lpb = (blockDim.x >> 5) * LPW;
  const int64_t f0 = (int64_t)blockIdx.x * lpb;
  const int nl = static_cast<int>(n - f0 < lpb ? n - f0 : lpb);
  const int ll = threadIdx.x % lpb;
  const int r0 = threadIdx.x / lpb;
  const bool mover = ll < nl;
  if (mover) {
    int32_t* m = lanes + ll * M::STRIDE;
    for (int row = r0; row < 3 * L; row += G)
      m[row] = p[(int64_t)row * n + f0 + ll];
  }
  __syncthreads();

  const int g = threadIdx.x % G;                     // thread within the lane
  const int l = static_cast<int>(threadIdx.x / G);   // lane within the block
  const bool active = l < nl;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (active) {
    int32_t* m = lanes + l * M::STRIDE;
    D::level1(m, m + M::S, g, KWs);
    __syncwarp(mask);
    D::level2(m + M::S, g, K, KWs);
    __syncwarp(mask);
    D::mid(m + M::S, g, K);
    __syncwarp(mask);
    D::level3(m, m + M::S, g, KWs);
    __syncwarp(mask);
    D::finish(m, m + M::S, g);
  }
  __syncthreads();

  if (mover) {
    const int32_t* m = lanes + ll * M::STRIDE;
    for (int row = r0; row < 3 * L; row += G)
      out[(int64_t)row * n + f0 + ll] = m[row];
  }
}

}  // namespace

// threads_per_doubling must be kDblG (the wrapper's lane count rests on
// it); warps a block (1 to 4) and blocks from cuzk/kernels.py
// pdbl_batch_geometry, which must cover F; wide: host memory, the words
// of msm::WideConsts<L, W>.
extern "C" int msm_pdbl_batch(int num_limbs, int limb_bits, const int32_t* p,
                              int32_t* out, int64_t F,
                              int threads_per_doubling, int warps, int blocks,
                              const int32_t* consts, const uint32_t* wide,
                              void* stream) {
  constexpr int LPW = 32 / msm::kDblG;   // lanes a warp
  if (F < 1 || threads_per_doubling != msm::kDblG || warps < 1 ||
      warps > kMaxWarps || blocks < 1 || (int64_t)blocks * warps * LPW < F)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    return msm::launch_lanes(pdbl_kernel<L, W>, warps,
                             LPW * DblLane<L>::STRIDE, blocks, s, p, out, F,
                             consts, KW);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
