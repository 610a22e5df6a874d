// Stage 3's bucket extraction for one window group: the sums G = T + S at
// the bucket-region ends, then bucket b = G_{b+1} - G_b, straight from
// the scan output into the group's slice of the bucket tensor.
//
// Replaces tpu_msm/cuzk/pipeline_pallas.py:292-304, which XLA compiles
// around the Pallas adds: `flat_gather` (:230) of T at the region ends
// and of S at their lanes, `kernels.padd_batch`, `jnp.where` (infinity
// where cnt == 0) and `kernels.psub_batch` of the neighbours; no
// pallas_call of its own. In the port that was nine launches a group
// (two gathers, the add, the select, two slice copies, the subtract and
// a strided copy into the buckets).
// Bound on the H100: operations. (2 B + 1) Wg complete adds (12 word-wide
// Montgomery multiplies each, mul_wide.cuh) against 3 L int16 gathered
// from T and from S at each of the (B + 1) Wg region ends and 3 L int16
// written a bucket: about 0.015 ms a launch at 2^20 (B = 2^15, Wg = 1).
// Design: a block of padd_lane.cuh's lanes (kAddG = 6 threads of one warp
// a lane, 5 lanes a warp, kPaddMaxWarps = 4 warps, so 20 lanes) owns a
// run of J = 19 consecutive buckets b0 .. b0 + J - 1 of one window
// (cuzk/kernels.py `extract_buckets_geometry`).
//  1. Threads 0 .. J read cnt at j = b0 .. b0 + J and keep, in shared
//     memory, p = max(cnt - 1, 0), the lane f = (w mod Wg) C + p / R and
//     the element jt = (p mod R) F + f of the flattened scan output, as
//     cuzk/kernels.py `boundary_lanes` computes them.
//  2. The block gathers T at jt and S at f, a (coordinate, limb) row at a
//     time, into the lanes' shared memory as int32 (a gather: no
//     coalescing to be had; each thread keeps kGather loads in flight
//     before it stores them, so the block waits on device memory about
//     twice, not once an element), and phase A adds them on J + 1 lanes with
//     padd_lane.cuh's phases, the operands and their order those of
//     padd_batch, so G is its bits. The sums go to a G array in shared
//     memory (int32, as the plain version's G), infinity where cnt == 0.
//     Lane 0 is the halo, G_{b0}, which the block before also computes.
//  3. Phase B loads p = G_{l+1} and q = G_l with y -> 4p - y into lane l,
//     as the padd kernel loads q for psub_batch, and adds them on J lanes.
//  4. The block stores the buckets as int16 (a truncating cast, exact by
//     the limb bound, as psub_batch's int16 output), a row at a time:
//     each row's J buckets are consecutive in memory.
// No G leaves the block. The halo lane costs one add in 19 more than the
// 2 B + 1 a window needs.
// Layouts: tbuf (3, L, R, F) int16; S (3, L, F) int16; cnt (Wp, B + 1)
// int32; buckets (3, L, Wp, B) int16, of which the kernel writes windows
// [w0, w0 + Wg).
#include "padd_lane.cuh"

#include <cstring>

namespace {

using namespace msm;

constexpr int kLanes = kPaddMaxWarps * kPaddLanesPerWarp;   // 20
constexpr int kGather = 8;   // gathered elements a thread in flight

// The block's part of the group: its window and first bucket, its G
// lanes (nA) and bucket lanes (nB = nA - 1), and each G lane's gather
// positions and whether its count is 0.
struct Part {
  int wl, b0, nA, nB;
  int jt[kLanes], f[kLanes], zero[kLanes];
};

template <int L>
struct ExtractMem {
  static constexpr int LANE = PaddLane<L>::STRIDE;
  static constexpr int G = 3 * L;                      // a sum's words
  static constexpr int WORDS = kLanes * (LANE + G);    // dynamic, a block
};

template <int L, int W>
__device__ __forceinline__ void add_lanes(int32_t* lanes, int n,
                                          int32_t* gout, const Consts<L>& K,
                                          const WideConsts<L, W>& KW) {
  using M = PaddLane<L>;
  using Ph = Phases<L, W>;
  const int lw = (threadIdx.x & 31) / kAddG;   // lane within the warp
  const int g = (threadIdx.x & 31) % kAddG;    // thread within the lane
  const int l = (threadIdx.x >> 5) * kPaddLanesPerWarp + lw;
  const bool active = lw < kPaddLanesPerWarp && l < n;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (active) {
    int32_t* m = lanes + l * M::STRIDE;
    Ph::level1(m + M::P1, m + M::P2, m + M::S, g, KW);
    __syncwarp(mask);
    Ph::mid(m + M::S, g, K);
    __syncwarp(mask);
    Ph::level2(m + M::S, g, KW);
    __syncwarp(mask);
    Ph::finish(m + M::S, g,
               gout ? gout + l * ExtractMem<L>::G : m + M::P1, K);
  }
}

template <int L, int W>
__global__ void __launch_bounds__(kPaddMaxWarps * 32)
extract_kernel(const int16_t* __restrict__ tbuf,
               const int16_t* __restrict__ sbuf,
               const int32_t* __restrict__ cnt,
               int16_t* __restrict__ buckets, int Wp, int B, int w0, int C,
               int R, int F, int chunks, const int32_t* __restrict__ kc,
               const WideConsts<L, W> KW) {
  using M = PaddLane<L>;
  using X = ExtractMem<L>;
  __shared__ Consts<L> K;
  __shared__ WideConsts<L, W> KWs;
  __shared__ Part part;
  extern __shared__ int32_t smem[];   // lanes [kLanes][LANE], G [kLanes][G]
  int32_t* lanes = smem;
  int32_t* gs = smem + kLanes * X::LANE;
  if (threadIdx.x == 0) {
    KWs = KW;
    part.wl = blockIdx.x / chunks;
    part.b0 = (blockIdx.x % chunks) * (kLanes - 1);
    part.nA = min(kLanes, B + 1 - part.b0);
    part.nB = part.nA - 1;
  }
  load_consts<L>(K, kc);                 // ends in __syncthreads

  // 1. the gather positions of the G lanes
  if (threadIdx.x < part.nA) {
    const int j = part.b0 + threadIdx.x;
    const int c = cnt[(int64_t)(w0 + part.wl) * (B + 1) + j];
    const int p = c > 0 ? c - 1 : 0;
    const int f = part.wl * C + p / R;
    part.f[threadIdx.x] = f;
    part.jt[threadIdx.x] = (p % R) * F + f;
    part.zero[threadIdx.x] = c == 0;
  }
  __syncthreads();

  // 2. gather T and S, kGather elements a thread in flight, then
  // G = T + S on nA lanes
  {
    const int nA = part.nA, total = 3 * L * nA;
    const int64_t RF = (int64_t)R * F;
    for (int i0 = threadIdx.x; i0 < total; i0 += kGather * blockDim.x) {
      int16_t tv[kGather], sv[kGather];
#pragma unroll
      for (int u = 0; u < kGather; u++) {
        const int i = i0 + u * blockDim.x;
        if (i < total) {
          const int l = i % nA, row = i / nA;
          tv[u] = tbuf[row * RF + part.jt[l]];
          sv[u] = sbuf[(int64_t)row * F + part.f[l]];
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; u++) {
        const int i = i0 + u * blockDim.x;
        if (i < total) {
          const int l = i % nA, row = i / nA;
          int32_t* m = lanes + l * M::STRIDE;
          m[M::P1 + row] = tv[u];
          m[M::P2 + row] = sv[u];
        }
      }
    }
  }
  __syncthreads();
  add_lanes<L, W>(lanes, part.nA, gs, K, KWs);
  __syncthreads();
  // cnt == 0: nothing sorts below this boundary, G is infinity
  for (int i = tid_now(); i < 3 * L * part.nA; i += ntid_now()) {
    const int l = i % part.nA, row = i / part.nA;
    if (part.zero[l])
      gs[l * X::G + row] = row >= L && row < 2 * L ? K.one[row - L] : 0;
  }
  __syncthreads();

  // 3. bucket b0 + l = G_{l+1} - G_l on nB lanes
  for (int i = tid_now(); i < 3 * L * part.nB; i += ntid_now()) {
    const int l = i % part.nB, row = i / part.nB;
    int32_t* m = lanes + l * M::STRIDE;
    m[M::P1 + row] = gs[(l + 1) * X::G + row];
    int32_t y = gs[l * X::G + row];
    if (row >= L && row < 2 * L)   // y -> 4p - y, as psub_batch loads q
      y = static_cast<int32_t>(static_cast<uint32_t>(K.kp4[row - L]) -
                               static_cast<uint32_t>(y));
    m[M::P2 + row] = y;
  }
  __syncthreads();
  add_lanes<L, W>(lanes, part.nB, nullptr, K, KWs);
  __syncthreads();

  // 4. the buckets, int16, a row of nB consecutive buckets at a time
  {
    const int nB = part.nB;
    int16_t* out = buckets + (int64_t)(w0 + part.wl) * B + part.b0;
    for (int i = tid_now(); i < 3 * L * nB; i += ntid_now()) {
      const int l = i % nB, row = i / nB;
      out[(int64_t)row * Wp * B + l] =
          static_cast<int16_t>(lanes[l * M::STRIDE + M::P1 + row]);
    }
  }
}

}  // namespace

// One window group: tbuf (3, L, R, F) and S (3, L, F) int16 with
// F = Wg C and R F < 2^31; cnt (Wp, B + 1) int32; buckets (3, L, Wp, B)
// int16, windows [w0, w0 + Wg) written. warps must be kPaddMaxWarps (the
// wrapper's geometry rests on it) and blocks Wg ceil(B / (lanes - 1))
// (cuzk/kernels.py extract_buckets_geometry); wide: host memory, the
// words of msm::WideConsts<L, W>.
extern "C" int msm_extract_buckets(int num_limbs, int limb_bits,
                                   const int16_t* tbuf, const int16_t* sbuf,
                                   const int32_t* cnt, int16_t* buckets,
                                   int Wp, int B, int w0, int Wg, int C,
                                   int R, int warps, int blocks,
                                   const int32_t* consts,
                                   const uint32_t* wide, void* stream) {
  const int chunks = (B + kLanes - 2) / (kLanes - 1);
  if (B < 1 || Wg < 1 || C < 1 || R < 1 || w0 < 0 || w0 + Wg > Wp ||
      (int64_t)R * Wg * C >= (int64_t{1} << 31) ||
      warps != kPaddMaxWarps || (int64_t)blocks != (int64_t)Wg * chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    return msm::launch_lanes(extract_kernel<L, W>, warps,
                             ExtractMem<L>::WORDS / kPaddMaxWarps, blocks, s,
                             tbuf, sbuf, cnt, buckets, Wp, B, w0, C, R,
                             Wg * C, chunks, consts, KW);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
