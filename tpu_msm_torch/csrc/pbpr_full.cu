// The whole parallel bucket-points reduction (cuZK Alg. 4) of each window.
//
// Replaces tpu_msm/cuzk/kernels.py `_pbpr_full_kernel` / `pbpr_full`.
// Bound on the H100: operations in total (per window 2 B complete adds
// in stage 1, T log2 T + 3 (T - 1) in the two lane scans, log2(B/T)
// doublings and one add, each product one word-wide Montgomery multiply
// of mul_wide.cuh, against 6 L bytes read per bucket), but depth at the
// shapes the MSM gives it: each lane of stage 1 is a chain of 2 Bt
// dependent adds (Bt = B / T), and the scans are 2 log2 T levels.
// What the kernel computes, in the TPU kernel's order (kernels.py
// :656-754): stage 1, slice t of Bt buckets walked from its top down
// with m += bucket; g += m; phase A, a suffix Hillis-Steele scan over the
// T lanes of m and g (lane t += lane t + k, infinity past the end); the
// mask (m lane 0 -> infinity, g lanes > 0 -> infinity); phase B, the same
// scan again; log2(Bt) doublings of m lane 0; G_w = g lane 0 + that.
// Every add is padd_lane.cuh's shared add (`msm::Phases`) and every
// doubling its shared doubling (`msm::DblPhases`): the operands and order
// of ops/rows.py padd_rows and pdbl_rows, each product one msm::mul_wide,
// so the output is bit-identical to the plain version.
// Design, two launches:
//  1. Stage 1, an ordinary launch over every SM: the lanes of
//     pbpr_lane.cuh, which pbpr_stage1.cu runs too (12 threads a lane,
//     the m add and the g add at once, so a lane is Bt + 1 steps deep;
//     2 lanes a warp, 1 to 4 warps a block as cuzk/kernels.py
//     `pbpr_stage1_geometry` picks them; the lane's state in shared
//     memory, the next bucket by cp.async, an int16 element fetched as
//     its 4-byte word). m and g go as int16 to half 0 and half 1 of the
//     first exchange array.
//  2. The two scans and the tail, ONE cooperative launch (the pattern of
//     col_prefix.cu): each level is a set of independent adds spread over
//     the whole grid, and a grid-wide barrier after each level. An add is
//     a chain of kAddG = 6 threads of one warp, 5 chains a warp (its last
//     two threads idle), kWarps warps a block; its words (the first
//     point, then the add's scratch with the second point in its T, as
//     msm::PaddLane lays out a lane) are in shared memory. Thread g loads
//     and stores limbs g, g + 6, ... of the points. Points pass between
//     levels as int16 (exact by the limb bound) through two exchange
//     arrays in device memory, read past the L1 (__ldcg). The levels come
//     from the wrapper as a table in device memory, (shift k, m lane
//     stride, g lane stride) a level, phase A then phase B
//     (`pbpr_scan_levels` in cuzk/kernels.py, the one place that decides
//     them): a level computes the lanes of each half that are multiples
//     of its stride, only the sums that a later step reads. The mask is
//     applied where phase B's first level (or, with T = 1 and no level,
//     the tail) reads. The tail runs after the last barrier, one chain a
//     window: the doublings on its first four threads, then the add.
//     The add of a level, the tail and a doubling run out of line, the
//     chain's words passed by their 32-bit shared address, so that the
//     kernel's loop keeps few values across the multiplies (more than 16
//     spilled; PERF.md).
// The wrapper sizes both grids (cuzk/kernels.py `pbpr_full_geometry`):
// stage 1 as many blocks as the lanes take; the scans never more blocks
// than msm_pbpr_full_limits reports resident with this kernel's shared
// memory, each chain striding over several adds where a level has more.
// A launch the device refuses returns its cudaError_t and the wrapper
// raises: there is no second path.
// Layouts: buckets (3, L, Wp, B) int16; out (3, L, Wp) int32; exchange
// (2 arrays, 3, L, 2 Wp T) int16, point (h Wp + w) T + t for half h
// (0: m, 1: g), window w, lane t.
#include <cooperative_groups.h>

#include <cstring>

#include "padd_lane.cuh"
#include "pbpr_lane.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;   // threads a block of the scan kernel
constexpr int kWarps = kThreads / 32;
constexpr int kChainsPerWarp = msm::kPaddLanesPerWarp;
constexpr int kChainsPerBlock = kWarps * kChainsPerWarp;

// ---------------------------------------------------------------------------
// 1. stage 1
// ---------------------------------------------------------------------------

template <int L, int W>
__global__ void __launch_bounds__(msm::kStage1MaxWarps * 32,
                                  msm::stage1_min_blocks(L))
stage1_kernel(const int16_t* __restrict__ buckets, int16_t* __restrict__ xout,
              int Wp, int B, int T, const int32_t* __restrict__ kc,
              const msm::WideConsts<L, W> KW) {
  // m to half 0, g to half 1 of the first exchange array
  const int64_t lanes = (int64_t)Wp * T;
  msm::stage1_block<L, W, int16_t, int16_t>(buckets, xout, xout + lanes,
                                            2 * lanes, Wp, B, T, kc, KW);
}

// ---------------------------------------------------------------------------
// 2. the lane scans and the tail
// ---------------------------------------------------------------------------

template <int L>
constexpr size_t scan_smem_bytes() {
  return (size_t)kChainsPerBlock * msm::PaddLane<L>::STRIDE * sizeof(int32_t);
}

// A chain's words from their shared address.
__device__ __forceinline__ int32_t* words(uint32_t cs) {
  return static_cast<int32_t*>(__cvta_shared_to_generic(cs));
}

// Point f of the exchange array src (one (coordinate, limb) plane of
// `plane` points) into shared p, or infinity: limbs g, g + kAddG, ...
template <int L>
__device__ __forceinline__ void load_point(const int16_t* src, int64_t plane,
                                           int64_t f, bool inf, int32_t* p,
                                           int g, const msm::Consts<L>& K) {
  for (int i = g; i < L; i += msm::kAddG) {
    p[i] = inf ? 0 : __ldcg(src + (int64_t)i * plane + f);
    p[L + i] = inf ? K.one[i] : __ldcg(src + (int64_t)(L + i) * plane + f);
    p[2 * L + i] = inf ? 0 : __ldcg(src + (int64_t)(2 * L + i) * plane + f);
  }
}

// The shared add p1 + p2 of a chain's words into p1, each phase but the
// last ended by a warp barrier; thread g writes limbs g, g + kAddG, ...
// of each coordinate of the sum, so it may store them without one.
template <int L, int W>
__device__ __forceinline__ void chain_add(int32_t* c, int g, unsigned mask,
                                          const msm::Consts<L>& K,
                                          const msm::WideConsts<L, W>& KW) {
  using M = msm::PaddLane<L>;
  using Ph = msm::Phases<L, W>;
  Ph::level1(c + M::P1, c + M::P2, c + M::S, g, KW);
  __syncwarp(mask);
  Ph::mid(c + M::S, g, K);
  __syncwarp(mask);
  Ph::level2(c + M::S, g, KW);
  __syncwarp(mask);
  Ph::finish(c + M::S, g, c + M::P1, K);
}

// Add `it` of a scan level of shift k: the m half's adds first, lanes 0,
// sm, 2 sm, ... window by window, then the g half's with stride sg. The
// level reads exchange array `odd` and writes the other; `masked` on
// phase B's first level. The add and the kernel's loop are apart (out of
// line) so that the loop's state is not live across the multiplies.
template <int L, int W>
__device__ __noinline__ void scan_add(int16_t* xchg, int Wp, int T, int odd,
                                      int k, int sm, int sg, bool masked,
                                      int it, uint32_t cs, int g,
                                      unsigned mask, const msm::Consts<L>& K,
                                      const msm::WideConsts<L, W>& KW) {
  using M = msm::PaddLane<L>;
  int32_t* c = words(cs);
  const int nm = Wp * (T / sm);
  const int h = it >= nm;
  const int stride = h ? sg : sm;
  const int r = h ? it - nm : it;
  const int per = T / stride;
  const int t = r % per * stride;
  const int64_t f = ((int64_t)h * Wp + r / per) * T + t;
  const int64_t plane = 2LL * Wp * T;
  const int16_t* src = xchg + odd * 3 * L * plane;
  int16_t* dst = xchg + (odd ^ 1) * 3 * L * plane;
  load_point<L>(src, plane, f, masked && ((h == 0) == (t == 0)), c + M::P1,
                g, K);
  load_point<L>(src, plane, f + k, t + k >= T || (masked && h == 1),
                c + M::P2, g, K);
  __syncwarp(mask);
  chain_add<L, W>(c, g, mask, K, KW);
  // the limbs it summed; the next add's loads touch only the loading
  // thread's limbs, and the barrier after them guards its products
  for (int i = g; i < L; i += msm::kAddG) {
    for (int row = i; row < 3 * L; row += L)
      dst[(int64_t)row * plane + f] = static_cast<int16_t>(c[M::P1 + row]);
  }
}

// One doubling of a chain's first point in place, on kDblG = 4 of its
// threads, each phase ended by a warp barrier. Out of line, so that the
// tail's loop keeps no operand address of it across the multiplies.
template <int L, int W>
__device__ __noinline__ void chain_dbl(uint32_t cs, int g, unsigned mask,
                                       const msm::Consts<L>& K,
                                       const msm::WideConsts<L, W>& KW) {
  using M = msm::PaddLane<L>;
  int32_t* c = words(cs);
  using D = msm::DblPhases<L, W>;
  const bool dbl = g < msm::kDblG;
  if (dbl) D::level1(c + M::P1, c + M::S, g, KW);
  __syncwarp(mask);
  D::level2(c + M::S, g, K, KW);
  __syncwarp(mask);
  if (dbl) D::mid(c + M::S, g, K);
  __syncwarp(mask);
  if (dbl) D::level3(c + M::P1, c + M::S, g, KW);
  __syncwarp(mask);
  if (dbl) D::finish(c + M::P1, c + M::S, g);
  __syncwarp(mask);
}

// The tail of window w: m lane 0 of src doubled log2(B / T) times, plus
// g lane 0, into out. With T = 1 there was no scan level, and the mask
// reads here.
template <int L, int W>
__device__ __noinline__ void tail(const int16_t* src, int32_t* out, int Wp,
                                  int B, int T, int w, uint32_t cs, int g,
                                  unsigned mask, const msm::Consts<L>& K,
                                  const msm::WideConsts<L, W>& KW) {
  using M = msm::PaddLane<L>;
  int32_t* c = words(cs);
  const int64_t plane = 2LL * Wp * T;
  load_point<L>(src, plane, (int64_t)w * T, T == 1, c + M::P1, g, K);
  __syncwarp(mask);
  for (int d = B / T; d > 1; d >>= 1) chain_dbl<L, W>(cs, g, mask, K, KW);
  load_point<L>(src, plane, ((int64_t)Wp + w) * T, false, c + M::P2, g, K);
  __syncwarp(mask);
  chain_add<L, W>(c, g, mask, K, KW);
  for (int i = g; i < L; i += msm::kAddG) {
    for (int row = i; row < 3 * L; row += L)
      out[(int64_t)row * Wp + w] = c[M::P1 + row];
  }
}

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
scan_kernel(int16_t* xchg, int32_t* out, const int* __restrict__ levels,
            int num_levels, int Wp, int B, int T,
            const int32_t* __restrict__ kc, const msm::WideConsts<L, W> KW) {
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  extern __shared__ int32_t dyn[];
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);            // ends in __syncthreads
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int iw = (threadIdx.x & 31) / msm::kAddG;   // chain within the warp
  const int g = (threadIdx.x & 31) % msm::kAddG;    // thread within it
  const bool chain = iw < kChainsPerWarp;           // the last two: idle
  // the chain's words by their shared address, one register
  const uint32_t c = static_cast<uint32_t>(__cvta_generic_to_shared(
      dyn + (warp * kChainsPerWarp + (chain ? iw : 0)) *
                msm::PaddLane<L>::STRIDE));
  // a warp's chains take adds base + iw, base + pass + iw, ...
  const int first = (blockIdx.x * kWarps + warp) * kChainsPerWarp;
  const int pass = gridDim.x * kChainsPerBlock;
  for (int lv = 0; lv < num_levels; lv++) {
    const int k = __ldg(levels + 3 * lv), sm = __ldg(levels + 3 * lv + 1);
    const int sg = __ldg(levels + 3 * lv + 2);
    const bool masked = 2 * lv == num_levels;   // phase B's first level
    const int items = Wp * (T / sm + T / sg);
    for (int base = first; base < items; base += pass) {
      const int it = base + iw;
      const bool on = chain && it < items;
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      if (on)
        scan_add<L, W>(xchg, Wp, T, lv & 1, k, sm, sg, masked, it, c, g,
                       mask, K, KWs);
    }
    grid.sync();
  }
  // after an even number of levels the sums are back in the first array
  for (int base = first; base < Wp; base += pass) {
    const int w = base + iw;
    const bool on = chain && w < Wp;
    const unsigned mask = __ballot_sync(0xffffffffu, on);
    if (on) tail<L, W>(xchg, out, Wp, B, T, w, c, g, mask, K, KWs);
  }
}

}  // namespace

// The launch limits of the scan kernel on the current device: resident
// blocks an SM with its dynamic shared memory, the SM count, threads a
// block, and threads an add.
extern "C" int msm_pbpr_full_limits(int num_limbs, int limb_bits,
                                    int* blocks_per_sm, int* sms, int* threads,
                                    int* threads_per_add) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *threads = kThreads;
  *threads_per_add = msm::kAddG;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    constexpr size_t smem = scan_smem_bytes<L>();
    rc = cudaFuncSetAttribute(scan_kernel<L, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, scan_kernel<L, W>, kThreads, smem);
  });
  return static_cast<int>(rc);
}

// levels: the (shift, m stride, g stride) table of the scan levels in
// device memory, 3 num_levels ints, an even number (cuzk/kernels.py
// pbpr_scan_levels); 3 L Wp B < 2^31 and even (stage 1 indexes the
// buckets in 32 bits and fetches 4-byte words; the wrapper checks their
// alignment); threads_per_add must be kAddG; stage-1 warps a block (1 to
// kStage1MaxWarps) and blocks from cuzk/kernels.py pbpr_stage1_geometry,
// which must cover the Wp T lanes; scan blocks at most the resident ones
// (the cooperative launch refuses more); wide: host memory, the words of
// msm::WideConsts<L, W>.
extern "C" int msm_pbpr_full(int num_limbs, int limb_bits,
                             const int16_t* buckets, int32_t* out,
                             int16_t* xchg, const int* levels, int num_levels,
                             int Wp, int B, int T, int threads_per_add,
                             int stage1_warps, int stage1_blocks,
                             int scan_blocks, const int32_t* consts,
                             const uint32_t* wide, void* stream) {
  if (num_levels % 2 || Wp < 1 || B < 1 || T < 1 || B % T ||
      (3LL * num_limbs * Wp * B) >> 31 || (3LL * num_limbs * Wp * B) % 2 ||
      threads_per_add != msm::kAddG || stage1_warps < 1 ||
      stage1_warps > msm::kStage1MaxWarps || stage1_blocks < 1 ||
      (int64_t)stage1_blocks * stage1_warps * msm::kStage1LanesPerWarp <
          (int64_t)Wp * T ||
      scan_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    int rc = msm::launch_lanes(stage1_kernel<L, W>, stage1_warps,
                               msm::Stage1Lane<L>::WARP_WORDS, stage1_blocks,
                               s, buckets, xchg, Wp, B, T, consts, KW);
    if (rc != cudaSuccess) return rc;
    constexpr size_t smem = scan_smem_bytes<L>();
    rc = cudaFuncSetAttribute(scan_kernel<L, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
    void* args[] = {&xchg, &out, &levels, &num_levels, &Wp,
                    &B,    &T,   &consts, &KW};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&scan_kernel<L, W>),
        dim3(static_cast<unsigned>(scan_blocks)), dim3(kThreads), args, smem,
        s));
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
