// Exclusive prefix of the C column totals of each window.
//
// Replaces tpu_msm/cuzk/kernels.py `_colprefix_kernel` / `col_prefix`.
// Bound on the H100: depth, not operations. The function is log2 C
// Hillis-Steele levels of Wg * C independent complete adds (12 word-wide
// Montgomery multiplies of mul_wide.cuh each); at the shapes the MSM
// gives it (8192 columns) one level is too little work to fill 132 SMs,
// so the least time is levels x the latency of ONE complete add on a
// warp that has its scheduler to itself, plus what it costs to hand every
// column's point to another lane between levels. Its 1,640 warps are
// three or four to a scheduler, though, and a level takes about twice a
// lone warp's, the products' issue (PERF.md).
// Design: a column is a lane of padd_lane.cuh's shared add: kAddG = 6
// threads of one warp, 5 lanes a warp, kWarps warps a block, the blocks
// spread over the whole card. A level is one add in depth: the add's
// four phases (the six products of level 1, the adds between the levels,
// the six products of level 2, the sum) on the lane's words in shared
// memory (its running point, the fetched point and the add's scratch,
// msm::PaddLane), each phase ended by a warp barrier, every product one
// out-of-line msm::mul_wide. It runs the TPU kernel's levels in the same
// order, so the result is bit-identical: the exclusive shift that brings
// in infinity (folded into level 0, which reads the input at c - 1 and
// c - 2), then shifts 1, 2, 4, ... below C, each combined by
// padd(v[c], v[c - k]) with infinity for c < k; the shared add's operands
// and their order are those of ops/rows.py padd_rows. Between
// levels a lane needs the point of another lane, in general of another
// block: every level writes its points as int16 (exact by the
// (-2^W, 2^(W+1)) limb bound of an add's sum, W <= 13) to an exchange
// array in device memory, which stays in the L2, and a grid-wide barrier
// (cooperative launch, cooperative_groups grid sync) separates the
// levels. The levels alternate between the scratch array and the output
// array so that the last level lands in the output; exchange loads go
// past the L1 (__ldcg), since another SM wrote them. A block moves its
// lanes' points between device and shared memory row by row, each
// (coordinate, limb) row of its lanes' consecutive columns by
// neighbouring threads, with a block barrier on either side of the add.
// The cooperative launch needs every block resident at once. The wrapper
// sizes the grid from the occupancy the launcher reports
// (msm_col_prefix_limits, cuzk/kernels.py `col_prefix_geometry`); with
// more columns than resident lanes each lane strides over several
// columns, fetching its running point from the exchange array as well,
// where a lane that holds one column keeps it in shared memory from one
// level to the next. A launch the device cannot make cooperatively
// returns its cudaError_t and the wrapper raises: there is no second
// path.
// Not built: shuffle and shared-memory exchange for shifts below the
// block's columns, and one launch per level in place of the grid barrier.
// Layouts: out/scratch (3, L, Wg, C) int16; in the same but for the
// stride between its (coordinate, limb) rows, in_stride elements: the
// column totals are read in place from the scan output, row R - 1 of
// (3, L, R, Wg C), whose rows lie R Wg C apart (Wg C where in is a
// contiguous (3, L, Wg, C) array).
#include <cooperative_groups.h>

#include <cstring>

#include "padd_lane.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 2;                  // warps a block
constexpr int kThreads = kWarps * 32;
// columns a block holds at once: kPaddLanesPerWarp (5) a warp
constexpr int kLanes = kWarps * msm::kPaddLanesPerWarp;
// the movers: element (row, lane ll) <-> thread ll + kLanes * (row mod
// kRowStep); the block's last kThreads mod kLanes threads move nothing
constexpr int kRowStep = kThreads / kLanes;

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
colprefix_kernel(const int16_t* in, int64_t in_stride, int16_t* out,
                 int16_t* scratch, int Wg, int C, int levels,
                 const int32_t* __restrict__ kc,
                 const msm::WideConsts<L, W> KW) {
  using M = msm::PaddLane<L>;
  using Ph = msm::Phases<L, W>;
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  __shared__ int32_t lanes[kLanes * M::STRIDE];
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);                  // ends in __syncthreads
  cg::grid_group grid = cg::this_grid();
  const int64_t plane = (int64_t)Wg * C;       // one (coord, limb) plane
  const int64_t span = (int64_t)gridDim.x * kLanes;   // columns at once
  const bool own_one = plane <= span;          // the point stays in P1
  const int ll = threadIdx.x % kLanes;         // the mover's lane
  const int r0 = threadIdx.x / kLanes;         // and first row
  const int lw = (threadIdx.x & 31) / msm::kAddG;   // lane within the warp
  const int g = (threadIdx.x & 31) % msm::kAddG;    // thread within the lane
  const int l = (threadIdx.x >> 5) * msm::kPaddLanesPerWarp + lw;
  const int16_t* src = in;
  int64_t src_stride = in_stride;
  for (int lv = 0; lv < levels; lv++) {
    const int k = 1 << lv;
    int16_t* dst = ((levels - 1 - lv) & 1) ? scratch : out;
    // level 0: v[c] = in[c - 1], v[c - 1] = in[c - 2]; then v[c] and
    // v[c - k] of the level before
    const int off_cur = lv == 0 ? 1 : 0, off_sh = lv == 0 ? 2 : k;
    const bool fetch_cur = lv == 0 || !own_one;
    for (int64_t base = (int64_t)blockIdx.x * kLanes; base < plane;
         base += span) {
      const int nl = static_cast<int>(plane - base < kLanes ? plane - base
                                                            : kLanes);
      const int64_t idx = base + ll;
      const bool mover = r0 < kRowStep && ll < nl;
      if (mover) {
        const int c = static_cast<int>(idx % C);
        int32_t* m = lanes + ll * M::STRIDE;
        for (int row = r0; row < 3 * L; row += kRowStep) {
          const int16_t* s = src + (int64_t)row * src_stride + idx;
          // infinity (0 : one : 0) where the shift leaves the window
          const int32_t inf = row >= L && row < 2 * L ? K.one[row - L] : 0;
          if (fetch_cur)
            m[M::P1 + row] = c < off_cur ? inf : __ldcg(s - off_cur);
          m[M::P2 + row] = c < off_sh ? inf : __ldcg(s - off_sh);
        }
      }
      __syncthreads();
      const bool active = lw < msm::kPaddLanesPerWarp && l < nl;
      const unsigned mask = __ballot_sync(0xffffffffu, active);
      if (active) {
        int32_t* m = lanes + l * M::STRIDE;
        Ph::level1(m + M::P1, m + M::P2, m + M::S, g, KWs);
        __syncwarp(mask);
        Ph::mid(m + M::S, g, K);
        __syncwarp(mask);
        Ph::level2(m + M::S, g, KWs);
        __syncwarp(mask);
        Ph::finish(m + M::S, g, m + M::P1, K);
      }
      __syncthreads();
      if (mover) {
        for (int row = r0; row < 3 * L; row += kRowStep)
          dst[(int64_t)row * plane + idx] =
              static_cast<int16_t>(lanes[ll * M::STRIDE + M::P1 + row]);
      }
      __syncthreads();   // the stores read P1 before the next columns land
    }
    src = dst;
    src_stride = plane;
    if (lv + 1 < levels) grid.sync();
  }
}

}  // namespace

// The launch limits of the kernel on the current device: resident blocks
// of kThreads threads per SM, the SM count, the block size, and the
// threads of one add (kAddG).
extern "C" int msm_col_prefix_limits(int num_limbs, int limb_bits,
                                     int* blocks_per_sm, int* sms,
                                     int* threads, int* threads_per_lane) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *threads = kThreads;
  *threads_per_lane = msm::kAddG;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits,
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, colprefix_kernel<L, W>, kThreads, 0));
  return static_cast<int>(rc);
}

// in_stride: elements between in's (coordinate, limb) rows, at least
// Wg C; levels: max(log2 C, 1); threads_per_lane must be kAddG (the wrapper's
// lane count rests on it); blocks from cuzk/kernels.py
// col_prefix_geometry, at most the resident blocks (the cooperative
// launch refuses more); wide: host memory, the words of
// msm::WideConsts<L, W>.
extern "C" int msm_col_prefix(int num_limbs, int limb_bits, const int16_t* in,
                              int64_t in_stride, int16_t* out,
                              int16_t* scratch, int Wg, int C,
                              int levels, int threads_per_lane, int blocks,
                              const int32_t* consts, const uint32_t* wide,
                              void* stream) {
  if (Wg < 1 || C < 1 || in_stride < (int64_t)Wg * C || levels < 1 ||
      levels > 30 ||
      threads_per_lane != msm::kAddG || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    void* args[] = {&in, &in_stride, &out, &scratch, &Wg, &C, &levels,
                    &consts, &KW};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&colprefix_kernel<L, W>),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
        (cudaStream_t)stream));
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
