// The cross-column stitch of the XLA path's bucket accumulation: the
// flagged inclusive scan of each window's C trailing sums, in the tree
// and operand order of XLA's associative_scan, then the inject of each
// column's exclusive prefix into the first run of a column that goes on
// with the run before it.
//
// Replaces no pallas_call: the counterpart of tpu_msm/cuzk/smvp.py:112-155
// (phase 2 of `bucket_accumulate`: jax.lax.associative_scan over the
// columns and the scatter after it), which XLA compiles into one program
// and which the port ran as one padd_batch launch a level of the
// recursion (21 at C = 2048, 25 at 8192), one more for the inject, and
// the torch slices, selects and copies between them (cuzk/kernels.py
// smvp_stitch_plain, its plain version).
// What it computes, in the plain version's order: column c of window w
// holds the sorted keys k[w, c R .. c R + R - 1]; it goes on with the
// run of column c - 1 (cont) where its first key equals that column's
// last, and holds one run (allsame) where its first and last keys are
// equal. The scan runs over the trailing sums with the flag
// !allsame || !cont, combine(a, b) = (b's point if b is flagged, else
// padd(a, b); a's flag | b's flag), a the earlier element. Where cont
// and (!allsame or the next column does not go on), the bucket of the
// column's first key becomes padd(bucket, P) with P the scan's result
// at c - 1. No two such columns of a window share their first key (the
// columns between would be one run that goes on), so the inject writes
// each bucket once.
// Bound on the H100: depth, not operations. At most about 2 Wg C
// complete adds (12 word-wide multiplies of mul_wide.cuh each) in 2
// log2 C - 1 dependent levels and the inject; at the XLA path's shapes
// (Wg C = 8,192 columns at 2^16 and 2^20) the keys need no scan add at
// all, only the inject: the least time is the chain of dependent adds
// the keys need, each the latency of one add on a warp.
// Design: which pairs of the scan add depends on the keys alone. A pair
// (a, b) of a level adds where b is not flagged, and b's flag is the OR
// of the column flags over the columns its value covers: the interval
// [lo, b], lo = a + 1 (the recursion's element at depth j covers 2^j
// columns, and a's interval ends where b's begins; a >= 0, so column 0,
// which is always flagged, is never b's). A column's flag is clear where
// it goes on with the run before it and holds one run, so with sorted
// keys the pair adds exactly where the key before the interval,
// k[lo R - 1], equals its last, k[(b + 1) R - 1]: one comparison of two
// keys, no flags carried level by level. The
// wrapper's table (cuzk/kernels.py _stitch_schedule, built once per C)
// holds each pair as (a, b, lo, level). One cooperative launch:
//   1. every block decides a share of the Wg x pairs items and ORs the
//      levels that have an add into a 64-bit mask, one word a block;
//   2. one grid barrier; every block ORs all blocks' words, so every
//      block holds the same mask, read past the L1 (__ldcg) from memory
//      the whole grid wrote, and takes the same barriers;
//   3. only where the mask is not 0: the trailing sums copied into the
//      scan array, a barrier, then each level of the mask in XLA's tree
//      and operand order (cuzk/kernels.py smvp_stitch_levels), its adding
//      pairs only, a barrier after each; a level with no add costs no
//      barrier and no pass;
//   4. the inject, its P the scan at c - 1, or the trailing sum at c - 1
//      where no level added (the scan then equals the trailing sums).
// Element e of depth j lives at position (e + 1) 2^j - 1; a level sets
// v[b] = v[a] + v[b] at its adding pairs, and no level reads a position
// it writes. Block 0 writes the mask after the blocks' words, so the
// caller can read which levels ran. An add is a lane of padd_lane.cuh's
// shared add, kAddG = 6 threads of a warp, 5 lanes a warp, 2 warps a
// block, as col_prefix.cu: the block first finds its lanes' items, then
// moves their two points into shared memory row by row, adds, and moves
// the sums out, each step between block barriers; a lane strides over
// the level's items when there are more than resident lanes. The scan
// array stays int32 (its points are complete adds' sums, wider than the
// (-2^W, 2^(W+1)) bound that would let them narrow to int16); its loads
// go past the L1 (__ldcg), since other SMs wrote them. The operands and
// their order are those of ops/rows.py padd_rows, so every limb is the
// plain version's. A launch the device cannot make cooperatively returns
// its cudaError_t and the wrapper raises: there is no second path.
// Layouts: bucket (3, L, Wg, B2) int32, written in place (slot B2 - 1,
// the spare, never); trailing, scan (3, L, Wg, C) int32; keys (Wg, C R)
// int32, sorted in each window; pairs (pairs, 4) int32 (a, b, lo,
// level); starts (levels + 1) int32, each level's first pair; masks
// (blocks + 1) uint64: a word a block, then the mask.
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "padd_lane.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 2;                  // warps a block
constexpr int kThreads = kWarps * 32;
// adds a block runs at once: kPaddLanesPerWarp (5) a warp
constexpr int kLanes = kWarps * msm::kPaddLanesPerWarp;
// the movers: element (row, lane ll) <-> thread ll + kLanes * (row mod
// kRowStep); the block's last kThreads mod kLanes threads move nothing
constexpr int kRowStep = kThreads / kLanes;

// does pair (a, b, lo) add in the window of sorted keys kw? b is not
// flagged: the key before b's columns equals their last (lo = a + 1 >= 1)
__device__ __forceinline__ bool pair_adds(const int32_t* __restrict__ kw,
                                          int4 pr, int R) {
  return kw[(int64_t)pr.z * R - 1] == kw[((int64_t)pr.y + 1) * R - 1];
}

// the OR of v over the block, into every thread (ends in __syncthreads)
__device__ __forceinline__ unsigned long long block_or(
    unsigned long long v, unsigned long long* acc) {
  if (threadIdx.x == 0) *acc = 0;
  __syncthreads();
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu,
                                       static_cast<unsigned>(v >> 32));
  if ((threadIdx.x & 31) == 0 && (lo | hi))
    atomicOr(acc, (static_cast<unsigned long long>(hi) << 32) | lo);
  __syncthreads();
  return *acc;
}

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
stitch_kernel(int32_t* bucket, const int32_t* __restrict__ trailing,
              const int32_t* __restrict__ keys, int32_t* scan,
              unsigned long long* masks, const int4* __restrict__ pairs,
              const int32_t* __restrict__ starts, int Wg, int C, int R,
              int B2, int levels, const int32_t* __restrict__ kc,
              const msm::WideConsts<L, W> KW) {
  using M = msm::PaddLane<L>;
  using Ph = msm::Phases<L, W>;
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  __shared__ int32_t lanes[kLanes * M::STRIDE];
  // each lane's item: its first operand's element (in the scan, or in
  // the bucket at the inject; -1 for no add) and its second's (in the
  // scan, or the trailing sums); the sum goes to the second's element,
  // or to the bucket
  __shared__ int32_t src1[kLanes], src2[kLanes];
  __shared__ unsigned long long acc;
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);                  // ends in __syncthreads
  cg::grid_group grid = cg::this_grid();
  const int64_t F = (int64_t)Wg * C;           // one (coord, limb) plane
  const int64_t FB = (int64_t)Wg * B2;         // and one of the bucket
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t CR = (int64_t)C * R;

  // 1. the levels that hold an add, from the keys alone
  const int npairs = starts[levels];
  unsigned long long mine = 0;
  for (int64_t it = tid; it < (int64_t)Wg * npairs; it += nthreads) {
    const int4 pr = pairs[it % npairs];
    if (pair_adds(keys + (it / npairs) * CR, pr, R)) mine |= 1ull << pr.w;
  }
  mine = block_or(mine, &acc);
  if (threadIdx.x == 0) masks[blockIdx.x] = mine;
  grid.sync();
  // 2. every block the same mask, from every block's word
  unsigned long long active = 0;
#pragma unroll 8
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads)
    active |= __ldcg(masks + i);               // loads issued 8 at once
  __syncthreads();                             // acc read by block_or
  active = block_or(active, &acc);
  if (blockIdx.x == 0 && threadIdx.x == 0) masks[gridDim.x] = active;

  const int64_t span = (int64_t)gridDim.x * kLanes;   // items at once
  const int ll = threadIdx.x % kLanes;         // the mover's lane
  const int r0 = threadIdx.x / kLanes;         // and first row
  const int lw = (threadIdx.x & 31) / msm::kAddG;   // lane within the warp
  const int g = (threadIdx.x & 31) % msm::kAddG;    // thread within the lane
  const int l = (threadIdx.x >> 5) * msm::kPaddLanesPerWarp + lw;
  // 3. the scan from the trailing sums, only where a level adds
  if (active) {
    for (int64_t i = tid; i < 3 * L * F; i += nthreads) scan[i] = trailing[i];
    grid.sync();
  }
  // P of the inject: the scan at c - 1, or the trailing sums if no level
  // added
  const int32_t* prefix = active ? scan : trailing;
  for (int lv = 0; lv <= levels; lv++) {
    const bool inject = lv == levels;
    if (!inject && !((active >> lv) & 1)) continue;
    const int s0 = inject ? 0 : starts[lv];
    const int cnt = inject ? C : starts[lv + 1] - s0;
    const int64_t items = (int64_t)Wg * cnt;
    for (int64_t base = (int64_t)blockIdx.x * kLanes; base < items;
         base += span) {
      const int nl = static_cast<int>(items - base < kLanes ? items - base
                                                             : kLanes);
      if (threadIdx.x < nl) {
        const int64_t it = base + threadIdx.x;
        const int w = static_cast<int>(it / cnt);
        const int i = static_cast<int>(it % cnt);
        const int32_t* kw = keys + (int64_t)w * CR;
        int32_t i1 = -1, i2 = 0;
        if (!inject) {
          const int4 pr = pairs[s0 + i];
          if (pair_adds(kw, pr, R)) {
            i1 = w * C + pr.x;
            i2 = w * C + pr.y;
          }
        } else if (i > 0) {                    // column i of window w
          const int64_t c0 = (int64_t)i * R;
          const int32_t first = kw[c0], last = kw[c0 + R - 1];
          const bool goes_on = i + 1 < C && kw[c0 + R] == last;
          if (kw[c0 - 1] == first && (first != last || !goes_on) &&
              (unsigned)first < (unsigned)(B2 - 1)) {
            i1 = w * B2 + first;
            i2 = w * C + i - 1;                // P: the scan at c - 1
          }
        }
        src1[threadIdx.x] = i1;
        src2[threadIdx.x] = i2;
      }
      __syncthreads();
      if (r0 < kRowStep && ll < nl && src1[ll] >= 0) {
        int32_t* m = lanes + ll * M::STRIDE;
        const int32_t i1 = src1[ll], i2 = src2[ll];
        for (int row = r0; row < 3 * L; row += kRowStep) {
          m[M::P1 + row] = inject ? bucket[row * FB + i1]
                                  : __ldcg(scan + row * F + i1);
          m[M::P2 + row] = inject ? __ldcg(prefix + row * F + i2)
                                  : __ldcg(scan + row * F + i2);
        }
      }
      __syncthreads();
      const bool busy = lw < msm::kPaddLanesPerWarp && l < nl && src1[l] >= 0;
      const unsigned mask = __ballot_sync(0xffffffffu, busy);
      if (busy) {
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
      if (r0 < kRowStep && ll < nl && src1[ll] >= 0) {
        const int32_t* m = lanes + ll * M::STRIDE;
        int32_t* out = inject ? bucket + src1[ll] : scan + src2[ll];
        const int64_t plane = inject ? FB : F;
        for (int row = r0; row < 3 * L; row += kRowStep)
          out[row * plane] = m[M::P1 + row];
      }
      __syncthreads();   // the stores read the lanes before the next items
    }
    if (!inject) grid.sync();
  }
}

}  // namespace

// The launch limits of the kernel on the current device: resident blocks
// of kThreads threads per SM, the SM count, the block size, and the
// threads of one add (kAddG).
extern "C" int msm_smvp_stitch_limits(int num_limbs, int limb_bits,
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
          blocks_per_sm, stitch_kernel<L, W>, kThreads, 0));
  return static_cast<int>(rc);
}

// keys (Wg, C R), sorted in each window; B2 >= 2 bucket slots a window,
// the last the spare; levels: the scan's levels, starts' length less one
// (0 for C = 1); pairs: (starts[levels], 4) int32 (a, b, lo, level);
// masks: blocks + 1 words; threads_per_lane must be kAddG; blocks from
// cuzk/kernels.py smvp_stitch_geometry, at most the resident blocks (the
// cooperative launch refuses more); wide: host memory, the words of
// msm::WideConsts<L, W>.
extern "C" int msm_smvp_stitch(int num_limbs, int limb_bits, int32_t* bucket,
                               const int32_t* trailing, const int32_t* keys,
                               int32_t* scan, void* masks,
                               const int32_t* pairs, const int32_t* starts,
                               int Wg, int C, int R, int B2, int levels,
                               int threads_per_lane, int blocks,
                               const int32_t* consts, const uint32_t* wide,
                               void* stream) {
  if (Wg < 1 || C < 1 || R < 1 || B2 < 2 || levels < 0 || levels > 62 ||
      (int64_t)Wg * C > INT_MAX || (int64_t)Wg * B2 > INT_MAX ||
      threads_per_lane != msm::kAddG || blocks < 1 ||
      reinterpret_cast<uintptr_t>(pairs) % 16 ||
      reinterpret_cast<uintptr_t>(masks) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* mk = static_cast<unsigned long long*>(masks);
  auto* pr = reinterpret_cast<const int4*>(pairs);
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    void* args[] = {&bucket, &trailing, &keys, &scan, &mk, &pr,
                    &starts, &Wg, &C, &R, &B2, &levels, &consts, &KW};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&stitch_kernel<L, W>),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
        (cudaStream_t)stream));
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
