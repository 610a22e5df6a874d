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
// Bound on the H100: depth, not operations. About 2 Wg C complete adds
// (12 word-wide multiplies of mul_wide.cuh each) in 2 log2 C - 1
// dependent levels and the inject; at the XLA path's shapes (Wg C =
// 8,192 columns at 2^16 and 2^20) even the widest level is too little
// work to fill 132 SMs, so the least time is the levels times the
// latency of one add on a warp, as in col_prefix.cu.
// Design: XLA's recursion run in place. Element e of depth j lives at
// position (e + 1) 2^j - 1; a level sets v[b] = combine(v[a], v[b]) on a
// list of (a, b) pairs that the wrapper builds once per C
// (cuzk/kernels.py smvp_stitch_levels: the pairs of depth j going down,
// then the even elements of each depth coming back up), and no level
// reads a position it writes. Where b is flagged its point is the result
// and no add runs; else the flag becomes a's. The levels, and the
// copy-in before them (the trailing sums into the scan array and the
// flags from the keys), are separated by grid-wide barriers of one
// cooperative launch; the inject is one more level after the last
// barrier, its items one a column. An add is a lane of padd_lane.cuh's
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
// int32; flags (Wg, C) int32; pairs (levels' pairs, 2) int32; starts
// (levels + 1) int32, each level's first pair.
#include <cooperative_groups.h>

#include <climits>
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

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
stitch_kernel(int32_t* bucket, const int32_t* __restrict__ trailing,
              const int32_t* __restrict__ keys, int32_t* scan, int32_t* flags,
              const int32_t* __restrict__ pairs,
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
  // scan); the sum goes to the second's element, or to the bucket
  __shared__ int32_t src1[kLanes], src2[kLanes];
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);                  // ends in __syncthreads
  cg::grid_group grid = cg::this_grid();
  const int64_t F = (int64_t)Wg * C;           // one (coord, limb) plane
  const int64_t FB = (int64_t)Wg * B2;         // and one of the bucket

  // copy-in: the scan starts from the trailing sums, each column flagged
  // where it holds more than one run or does not go on with the run of
  // the column before
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = tid; i < 3 * L * F; i += nthreads) scan[i] = trailing[i];
  for (int64_t f = tid; f < F; f += nthreads) {
    const int64_t c0 = (f % C) * R;
    const int32_t* kw = keys + (f / C) * C * R;
    const int32_t first = kw[c0];
    flags[f] = first != kw[c0 + R - 1] || c0 == 0 || kw[c0 - 1] != first;
  }
  grid.sync();

  const int64_t span = (int64_t)gridDim.x * kLanes;   // items at once
  const int ll = threadIdx.x % kLanes;         // the mover's lane
  const int r0 = threadIdx.x / kLanes;         // and first row
  const int lw = (threadIdx.x & 31) / msm::kAddG;   // lane within the warp
  const int g = (threadIdx.x & 31) % msm::kAddG;    // thread within the lane
  const int l = (threadIdx.x >> 5) * msm::kPaddLanesPerWarp + lw;
  for (int lv = 0; lv <= levels; lv++) {
    const bool inject = lv == levels;
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
        int32_t i1 = -1, i2 = 0;
        if (!inject) {
          const int32_t a = w * C + pairs[2 * (s0 + i)];
          const int32_t b = w * C + pairs[2 * (s0 + i) + 1];
          // a flagged b is the result itself: no add, its flag stays set
          if (!__ldcg(flags + b)) {
            flags[b] = __ldcg(flags + a);
            i1 = a;
            i2 = b;
          }
        } else if (i > 0) {                    // column i of window w
          const int32_t* kw = keys + (int64_t)w * C * R;
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
          m[M::P2 + row] = __ldcg(scan + row * F + i2);
        }
      }
      __syncthreads();
      const bool active =
          lw < msm::kPaddLanesPerWarp && l < nl && src1[l] >= 0;
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
      if (r0 < kRowStep && ll < nl && src1[ll] >= 0) {
        const int32_t* m = lanes + ll * M::STRIDE;
        int32_t* out = inject ? bucket + src1[ll] : scan + src2[ll];
        const int64_t plane = inject ? FB : F;
        for (int row = r0; row < 3 * L; row += kRowStep)
          out[row * plane] = m[M::P1 + row];
      }
      __syncthreads();   // the stores read the lanes before the next items
    }
    if (lv < levels) grid.sync();
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

// keys (Wg, C R); B2 >= 2 bucket slots a window, the last the spare;
// levels: the scan's levels, starts' length less one (0 for C = 1);
// threads_per_lane must be kAddG; blocks from cuzk/kernels.py
// smvp_stitch_geometry, at most the resident blocks (the cooperative
// launch refuses more); wide: host memory, the words of
// msm::WideConsts<L, W>.
extern "C" int msm_smvp_stitch(int num_limbs, int limb_bits, int32_t* bucket,
                               const int32_t* trailing, const int32_t* keys,
                               int32_t* scan, int32_t* flags,
                               const int32_t* pairs, const int32_t* starts,
                               int Wg, int C, int R, int B2, int levels,
                               int threads_per_lane, int blocks,
                               const int32_t* consts, const uint32_t* wide,
                               void* stream) {
  if (Wg < 1 || C < 1 || R < 1 || B2 < 2 || levels < 0 || levels > 62 ||
      (int64_t)Wg * C > INT_MAX || (int64_t)Wg * B2 > INT_MAX ||
      threads_per_lane != msm::kAddG || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    void* args[] = {&bucket, &trailing, &keys, &scan, &flags, &pairs,
                    &starts, &Wg, &C, &R, &B2, &levels, &consts, &KW};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&stitch_kernel<L, W>),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
        (cudaStream_t)stream));
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
