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
// Design: a persistent grid, as many blocks as are resident on the card
// (msm_extract_buckets_limits; cuzk/kernels.py
// `extract_buckets_geometry`), one wave. A block is kAddWarps warps of
// padd_lane.cuh's lanes (kAddG = 6 threads of one warp a lane, 5 lanes a
// warp: kLanes = 40 lanes) and one loader warp. The group's buckets are
// cut into runs of kRun = 39 consecutive buckets b0 .. b0 + 38 of one
// window (the last run of a window shorter, its lanes masked); block k
// takes runs k, k + blocks, ... and holds the curve's constants in
// shared memory for all of them.
//  - The loader warp reads cnt at the run's j = b0 .. b0 + 39 and keeps
//    p = max(cnt - 1, 0), the lane f = (w mod Wg) C + p / R and the
//    element jt = (p mod R) F + f of the flattened scan output, as
//    cuzk/kernels.py `boundary_lanes` computes them (p / R and the run's
//    window by a multiply and a shift, `FastDiv`), gathers T at jt and S
//    at f, kGather loads a thread in flight, into a staging buffer in
//    shared memory (int16, a (coordinate, limb) row of the 40 lanes at a
//    time), and signals the add warps (named barrier kBarFull). It then
//    waits for them to empty the buffer (kBarEmpty) and gathers the next
//    run while they add this one: the gathers of run k + 1 are in flight
//    during the adds of run k.
//  - The add warps copy the staged run into their lanes (T as p, S as
//    q, int32), release the buffer, and add G_j = T + S on the run's
//    lanes with padd_lane.cuh's phases, the operands and their order
//    those of padd_batch, so G is its bits; the sum goes to the lane's
//    own q words. Lane 0 is the halo, G_{b0}, which the run before also
//    computes (one add in 40 more than the 2 B + 1 a window needs).
//    Then one move: lane l's G (infinity where cnt == 0) is p of
//    bucket l - 1, copied into lane l - 1, and q of bucket l, its y
//    taken as 4p - y in place, as the padd kernel loads q for
//    psub_batch; each element is read and written by one thread, so no
//    barrier splits the move. The lanes add again: bucket b0 + l =
//    G_{l+1} - G_l, on 39 lanes, and the block stores the buckets as
//    int16 (a truncating cast, exact by the limb bound, as psub_batch's
//    int16 output), each row's buckets consecutive in memory.
// The loops are laid out lane by lane, by the compile-time kLanes: no
// run-time division. The add warps meet at named barrier kBarAdd; the
// loader never waits for them but at kBarEmpty. No G leaves the block.
// padd_lane.cuh's add is used as it is.
// Layouts: tbuf (3, L, R, F) int16; S (3, L, F) int16; cnt (Wp, B + 1)
// int32; buckets (3, L, Wp, B) int16, of which the kernel writes windows
// [w0, w0 + Wg).
#include "padd_lane.cuh"

#include <cstring>

namespace {

using namespace msm;

constexpr int kAddWarps = 8;   // cuzk/kernels.py EXTRACT_ADD_WARPS
constexpr int kLanes = kAddWarps * kPaddLanesPerWarp;   // 40
constexpr int kRun = kLanes - 1;                        // buckets a run
constexpr int kAddThreads = kAddWarps * 32;
constexpr int kThreads = kAddThreads + 32;              // and the loader
// the add warps' movers: element (row, lane l) <-> thread
// l + kLanes (row mod kRowStep); the last kAddThreads mod kLanes idle
constexpr int kRowStep = kAddThreads / kLanes;
constexpr int kGather = 8;     // gathered elements a loader thread in flight
// named barriers; 0 is __syncthreads
constexpr int kBarAdd = 1, kBarFull = 2, kBarEmpty = 3;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// x / d = (x m) >> s for 0 <= x < 2^31 (Granlund and Montgomery: m =
// floor(2^(32 + l) / d) + 1 with 2^(l - 1) < d <= 2^l, s = 32 + l;
// cuzk/kernels.py fast_div, which the tests hold).
struct FastDiv {
  unsigned long long m;
  int s;
};

FastDiv fast_div(uint32_t d) {
  int l = 0;
  while ((1ull << l) < d) l++;
  return FastDiv{(1ull << (32 + l)) / d + 1, 32 + l};
}

__device__ __forceinline__ uint32_t div_by(uint32_t x, const FastDiv& f) {
  return static_cast<uint32_t>((x * f.m) >> f.s);
}

// The run the loader staged: T and S at its G lanes' region ends, a
// (coordinate, limb) row at a time, and the run itself.
template <int L>
struct Stage {
  int16_t t[3 * L][kLanes];
  int16_t s[3 * L][kLanes];
  unsigned long long zero;   // bit l: cnt == 0 at G lane l
  int wl, b0, nA;            // window in the group, first bucket, G lanes
};

struct Run {
  unsigned long long zero;
  int wl, b0, nA;
};

// out = p + q on lanes [0, n) of the add warps, p in the lane's P1
// words and q in its P2 words; the sum into the lane's words at `out`
// (P2: the add's scratch no longer reads them when it writes the sum;
// P1).
template <int L, int W>
__device__ __forceinline__ void add_lanes(int32_t* lanes, int n, int out,
                                          const Consts<L>& K,
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
    Ph::finish(m + M::S, g, m + out, K);
  }
}

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const int16_t* __restrict__ tbuf,
               const int16_t* __restrict__ sbuf,
               const int32_t* __restrict__ cnt,
               int16_t* __restrict__ buckets, int Wp, int B, int w0, int C,
               int R, int F, int runs, int rpw, const FastDiv by_r,
               const FastDiv by_rpw, const int32_t* __restrict__ kc,
               const WideConsts<L, W> KW) {
  using M = PaddLane<L>;
  __shared__ Consts<L> K;
  __shared__ WideConsts<L, W> KWs;
  __shared__ Stage<L> st;
  __shared__ Run cur;
  __shared__ int jt_s[kLanes], f_s[kLanes];
  extern __shared__ int32_t lanes[];   // [kLanes][STRIDE]
  if (threadIdx.x == 0) KWs = KW;
  load_consts<L>(K, kc);               // ends in __syncthreads

  if (threadIdx.x >= kAddThreads) {
    // the loader warp: run k + 1 into the staging buffer while the add
    // warps add run k
    const int lane = threadIdx.x & 31;
    const int64_t RF = (int64_t)R * F;
    int k = 0;
    for (int run = blockIdx.x; run < runs; run += gridDim.x, k++) {
      const int wl = static_cast<int>(div_by(run, by_rpw));
      const int b0 = (run - wl * rpw) * kRun;
      const int nA = min(kLanes, B + 1 - b0);
      const int32_t* cw = cnt + (int64_t)(w0 + wl) * (B + 1) + b0;
      unsigned long long zero = 0;
      __syncwarp();   // the last run's gathers have read jt_s and f_s
#pragma unroll
      for (int l0 = 0; l0 < kLanes; l0 += 32) {
        const int l = l0 + lane;
        const bool on = l < nA;
        const int c = on ? cw[l] : 1;
        const uint32_t p = c > 0 ? c - 1 : 0;
        const uint32_t q = div_by(p, by_r);
        const int f = wl * C + static_cast<int>(q);
        if (l < kLanes) {
          f_s[l] = f;
          jt_s[l] = static_cast<int>(p - q * R) * F + f;
        }
        zero |= static_cast<unsigned long long>(
                    __ballot_sync(0xffffffffu, on && c == 0))
                << l0;
      }
      __syncwarp();
      if (k) bar_sync(kBarEmpty, kThreads);
      for (int e0 = lane; e0 < 3 * L * kLanes; e0 += 32 * kGather) {
        int16_t tv[kGather], sv[kGather];
#pragma unroll
        for (int u = 0; u < kGather; u++) {
          const int e = e0 + 32 * u;
          const int row = e / kLanes, l = e % kLanes;
          if (e < 3 * L * kLanes && l < nA) {
            tv[u] = tbuf[row * RF + jt_s[l]];
            sv[u] = sbuf[(int64_t)row * F + f_s[l]];
          }
        }
#pragma unroll
        for (int u = 0; u < kGather; u++) {
          const int e = e0 + 32 * u;
          const int row = e / kLanes, l = e % kLanes;
          if (e < 3 * L * kLanes && l < nA) {
            st.t[row][l] = tv[u];
            st.s[row][l] = sv[u];
          }
        }
      }
      if (lane == 0) {
        st.zero = zero;
        st.wl = wl;
        st.b0 = b0;
        st.nA = nA;
      }
      bar_arrive(kBarFull, kThreads);
    }
    if (k) bar_sync(kBarEmpty, kThreads);   // the last run's release
    return;
  }

  for (int run = blockIdx.x; run < runs; run += gridDim.x) {
    bar_sync(kBarFull, kThreads);
    // the staged run into the lanes: T as p, S as q
    {
      const int t = tid_now(), ll = t % kLanes, r0 = t / kLanes;
      if (r0 < kRowStep) {
        int32_t* m = lanes + ll * M::STRIDE;
        for (int row = r0; row < 3 * L; row += kRowStep) {
          m[M::P1 + row] = st.t[row][ll];
          m[M::P2 + row] = st.s[row][ll];
        }
      }
      if (t == 0) cur = Run{st.zero, st.wl, st.b0, st.nA};
    }
    bar_arrive(kBarEmpty, kThreads);
    bar_sync(kBarAdd, kAddThreads);
    // G_l = T + S into the lane's q words
    add_lanes<L, W>(lanes, cur.nA, M::P2, K, KWs);
    bar_sync(kBarAdd, kAddThreads);
    // lane l's G, infinity where cnt == 0: p of bucket l - 1 into lane
    // l - 1, and q of bucket l with y -> 4p - y in place
    {
      const int t = tid_now(), ll = t % kLanes, r0 = t / kLanes;
      if (r0 < kRowStep && ll < cur.nA) {
        const bool z = (cur.zero >> ll) & 1ull;
        int32_t* m = lanes + ll * M::STRIDE;
        for (int row = r0; row < 3 * L; row += kRowStep) {
          const bool yrow = row >= L && row < 2 * L;
          int32_t v = m[M::P2 + row];
          if (z) v = yrow ? K.one[row - L] : 0;
          if (ll > 0) m[M::P1 + row - M::STRIDE] = v;
          if (yrow)
            v = static_cast<int32_t>(static_cast<uint32_t>(K.kp4[row - L]) -
                                     static_cast<uint32_t>(v));
          m[M::P2 + row] = v;
        }
      }
    }
    bar_sync(kBarAdd, kAddThreads);
    // bucket b0 + l = G_{l+1} - G_l into the lane's p words
    add_lanes<L, W>(lanes, cur.nA - 1, M::P1, K, KWs);
    bar_sync(kBarAdd, kAddThreads);
    // the buckets, int16, a row of consecutive buckets at a time
    {
      const int t = tid_now(), ll = t % kLanes, r0 = t / kLanes;
      if (r0 < kRowStep && ll < cur.nA - 1) {
        int16_t* out = buckets + (int64_t)(w0 + cur.wl) * B + cur.b0 + ll;
        const int32_t* m = lanes + ll * M::STRIDE;
        for (int row = r0; row < 3 * L; row += kRowStep)
          out[(int64_t)row * Wp * B] = static_cast<int16_t>(m[M::P1 + row]);
      }
    }
    bar_sync(kBarAdd, kAddThreads);   // P1 read before the next run lands
  }
}

template <int L>
constexpr size_t lanes_bytes() {
  return (size_t)kLanes * PaddLane<L>::STRIDE * sizeof(int32_t);
}

}  // namespace

// The persistent grid's limits: resident blocks an SM of the kernel at
// (num_limbs, limb_bits), the card's SMs, threads a block and lanes a
// block.
extern "C" int msm_extract_buckets_limits(int num_limbs, int limb_bits,
                                          int* blocks_per_sm, int* sms,
                                          int* threads, int* lanes) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *threads = kThreads;
  *lanes = kLanes;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    constexpr size_t smem = lanes_bytes<L>();
    rc = cudaFuncSetAttribute(extract_kernel<L, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, extract_kernel<L, W>, kThreads, smem);
  });
  return static_cast<int>(rc);
}

// One window group: tbuf (3, L, R, F) and S (3, L, F) int16 with
// F = Wg C and R F < 2^31; cnt (Wp, B + 1) int32; buckets (3, L, Wp, B)
// int16, windows [w0, w0 + Wg) written. threads must be kThreads and
// blocks at most the Wg ceil(B / kRun) runs (cuzk/kernels.py
// extract_buckets_geometry: the resident ones); wide: host memory, the
// words of msm::WideConsts<L, W>.
extern "C" int msm_extract_buckets(int num_limbs, int limb_bits,
                                   const int16_t* tbuf, const int16_t* sbuf,
                                   const int32_t* cnt, int16_t* buckets,
                                   int Wp, int B, int w0, int Wg, int C,
                                   int R, int threads, int blocks,
                                   const int32_t* consts,
                                   const uint32_t* wide, void* stream) {
  const int rpw = (B + kRun - 1) / kRun;
  const int64_t runs = (int64_t)Wg * rpw;
  if (B < 1 || Wg < 1 || C < 1 || R < 1 || w0 < 0 || w0 + Wg > Wp ||
      (int64_t)R * Wg * C >= (int64_t{1} << 31) || threads != kThreads ||
      blocks < 1 || blocks > runs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    constexpr size_t smem = lanes_bytes<L>();
    cudaError_t rc = cudaFuncSetAttribute(
        extract_kernel<L, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    extract_kernel<L, W><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        tbuf, sbuf, cnt, buckets, Wp, B, w0, C, R, Wg * C,
        static_cast<int>(runs), rpw, fast_div(static_cast<uint32_t>(R)),
        fast_div(static_cast<uint32_t>(rpw)), consts, KW);
    return static_cast<int>(cudaGetLastError());
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
