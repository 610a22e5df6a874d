// The row walk of the XLA path's bucket accumulation: every lane walks
// its column of the sorted point stream once, restarts its running sum at
// each bucket run and writes the sum into the run's bucket where the run
// ends.
//
// Replaces no pallas_call: the counterpart of the lax.fori_loop body of
// tpu_msm/cuzk/smvp.py:94-110 (`bucket_accumulate`), which XLA compiles
// into one device loop and which the port ran as a Python loop of torch
// ops, one ops/complete.pmadd (about 6,000 launches at L = 22) a row.
// What it computes, in the plain version's order (cuzk/kernels.py
// smvp_rows_plain): lane f = (w mod Wg) * C + c walks the sorted
// positions c R .. c R + R - 1 of window w. Row r is the point
// idx = pay >> 1, its y folded to 2p - y where pay & 1. At a run start
// (r = 0, or a key other than row r - 1's) the running sum restarts at
// (x, y, Montgomery one); else it becomes pmadd_rows(sum, x, y). Where a
// run ends (the next key in global order differs: row r + 1's; after the
// last row the first key of column c + 1, and -1 after the last column)
// the sum is written into bucket[:, :, w, key]. At the end each lane
// writes its sum into trailing[:, :, w, c], the input of the stitch
// across columns (cuzk/smvp.py).
// Bound on the H100: operations in total (one complete mixed add, 12
// word-wide multiplies of mul_wide.cuh, per stream element, as
// prefix_scan), but depth at the shapes of the XLA path: each lane is a
// chain of R dependent adds (R = 32 at 2^16, 128 at 2^20, on 8,192
// lanes), each step on its lone-warp floor as prefix_scan's.
// Design: prefix_scan's lane (scan_lane.cuh): G threads a lane, G from
// cuzk/kernels.py smvp_rows_geometry (prefix_scan_geometry's rule), the
// lane's state in shared memory, the row of step r + 1 gathered by
// cp.async during step r, the multiplies out of line. What differs: the
// key of step r + 1 is read with its payload, a step ahead; a run start
// takes the row itself in place of the mixed add (the plain version
// computes that add and drops it by a select); a run's sum is written by
// the step after its end, which is the step that knows it starts a new
// run, so no step waits for the next key; and nothing is stored at the
// other steps. Lanes of one warp then branch apart, so every barrier
// holds the lane's own G threads only: a lane reads and writes only its
// own words of shared memory. (A barrier of the whole warp at the top of
// each step, or every lane taking the add's barriers with its
// arithmetic switched off at a restart, as pbpr_lane.cuh's chains do,
// timed no faster on the H100 at 2^16 and 2^20; PERF.md.) A key outside
// [0, B2 - 1) is written nowhere, as the JAX scatter drops its
// out-of-range index; the caller's keys are |digits| <= B = B2 - 2.
// Layouts: rows (n, 2L) int16, aligned to the piece; pay, keys (Wg, n)
// int32 in sorted order; bucket (3, L, Wg, B2) int32, filled with
// infinity by the caller (a slot where no run ends keeps it); trailing
// (3, L, Wg, C) int32.
#include <cstring>

#include "scan_lane.cuh"

namespace {

// the lane of scan_lane.cuh: LaneMem, RowPiece, pmadd_shared, the copies
using namespace msm::scan;

// The lane's running point (X1, Y1, Z1) into the (3, L) column at o,
// element k at o[k * stride]; thread g stores limbs g, g + G, ...
template <int L, int G>
__device__ __forceinline__ void store_point(const int32_t* m, int g,
                                            int32_t* o, int64_t stride) {
  using M = LaneMem<L>;
  for (int i = g; i < L; i += G) {
    o[(int64_t)i * stride] = m[M::X1 + i];
    o[(int64_t)(L + i) * stride] = m[M::Y1 + i];
    o[(int64_t)(2 * L + i) * stride] = m[M::Z1 + i];
  }
}

template <int L, int W, int G>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int16_t* __restrict__ rows, const int32_t* __restrict__ pay,
            const int32_t* __restrict__ keys, int32_t* __restrict__ bucket,
            int32_t* __restrict__ trailing, int Wg, int C, int R, int64_t n,
            int B2, const int32_t* __restrict__ kc,
            const msm::WideConsts<L, W> KW) {
  static_assert(G == 2 || G == 6, "built for 2 or 6 threads a lane");
  constexpr int LPW = 32 / G;          // lanes a warp
  constexpr int LPB = kWarps * LPW;    // lanes a block
  using Piece = typename RowPiece<L>::T;
  constexpr int Q = RowPiece<L>::Q;    // pieces a row
  using M = LaneMem<L>;
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  extern __shared__ int2 dyn[];        // 8-byte aligned
  Piece* rowbuf = reinterpret_cast<Piece*>(dyn);          // [2][LPB][Q]
  // [2][LPB] payloads after the rows
  int32_t* paybuf = reinterpret_cast<int32_t*>(rowbuf + 2 * LPB * Q);
  int32_t* lanes = paybuf + 2 * LPB;                      // [LPB][STRIDE]
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);          // ends in __syncthreads
  const int warp = threadIdx.x >> 5;
  const int lw = (threadIdx.x & 31) / G;   // lane within the warp
  const int g = (threadIdx.x & 31) % G;    // thread within the lane
  const int64_t F = (int64_t)Wg * C;
  const int64_t f = ((int64_t)blockIdx.x * kWarps + warp) * LPW + lw;
  if (lw >= LPW || f >= F) return;
  const unsigned mask = ((1u << G) - 1) << (lw * G);   // the lane's threads
  const int slot = warp * LPW + lw;
  const int64_t wl = f / C, c = f % C;
  const int32_t* p = pay + wl * n + c * (int64_t)R;
  const int32_t* kp = keys + wl * n + c * (int64_t)R;
  const int64_t plane = (int64_t)Wg * B2;  // one (coord, limb) plane
  int32_t* bk = bucket + wl * B2;          // + key: the window's slot
  const Piece* table = reinterpret_cast<const Piece*>(rows);
  int32_t* m = lanes + slot * M::STRIDE;   // the lane's state

  int32_t v = p[0];
  int32_t key = kp[0], prev = -1, next = -1;
  for (int q = g; q < Q; q += G)
    cp_async(&rowbuf[slot * Q + q], table + (int64_t)(v >> 1) * Q + q);
  if (g == 0 && R > 1) cp_async(&paybuf[LPB + slot], p + 1);
  for (int r = 0; r < R; r++) {
    cp_async_wait();
    __syncwarp(mask);
    const bool start = r == 0 || key != prev;
    // the run that ended at row r - 1: its sum into its bucket
    if (start && r > 0 && (unsigned)prev < (unsigned)(B2 - 1))
      store_point<L, G>(m, g, bk + prev, plane);
    // row r has arrived: unpack it, then start the copies of the next
    const int16_t* rb =
        reinterpret_cast<const int16_t*>(rowbuf + ((r & 1) * LPB + slot) * Q);
    const bool neg = v & 1;
    for (int i = g; i < L; i += G) {
      const int32_t xi = rb[i], yr = rb[L + i];
      const int32_t yi = neg ? K.kp2[i] - yr : yr;
      if (start) {                         // restart at (x, y, one)
        m[M::X1 + i] = xi;
        m[M::Y1 + i] = yi;
        m[M::Z1 + i] = K.one[i];
      } else {
        m[M::X2 + i] = xi;
        m[M::Y2 + i] = yi;
        m[M::U + i] = m[M::X1 + i] + m[M::Y1 + i];
        m[M::V + i] = xi + yi;
      }
    }
    if (r + 1 < R) {
      v = paybuf[((r + 1) & 1) * LPB + slot];
      next = kp[r + 1];                    // read now, used at step r + 1
      for (int q = g; q < Q; q += G)
        cp_async(&rowbuf[(((r + 1) & 1) * LPB + slot) * Q + q],
                 table + (int64_t)(v >> 1) * Q + q);
      if (g == 0 && r + 2 < R)
        cp_async(&paybuf[(r & 1) * LPB + slot], p + r + 2);
    }
    __syncwarp(mask);
    if (!start)
      pmadd_shared<L, W, G, false>(m, g, mask, nullptr, 0, K, KWs);
    prev = key;
    key = next;
  }
  __syncwarp(mask);
  // the last row's run ends unless the next column goes on with its key
  const int32_t after = c + 1 < C ? kp[R] : -1;
  if (prev != after && (unsigned)prev < (unsigned)(B2 - 1))
    store_point<L, G>(m, g, bk + prev, plane);
  store_point<L, G>(m, g, trailing + f, F);
}

template <int L, int W, int G>
int launch(const int16_t* rows, const int32_t* pay, const int32_t* keys,
           int32_t* bucket, int32_t* trailing, int Wg, int C, int R,
           int64_t n, int B2, int64_t shared_bytes, const int32_t* consts,
           const msm::WideConsts<L, W>& KW, cudaStream_t stream) {
  constexpr size_t smem = scan_smem_bytes<L, G>();
  // the caller's reckoning (cuzk/kernels.py prefix_scan_smem) must agree
  if (shared_bytes != static_cast<int64_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      rows_kernel<L, W, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t lanes = kWarps * (32 / G);
  const int64_t F = (int64_t)Wg * C;
  const unsigned blocks = static_cast<unsigned>((F + lanes - 1) / lanes);
  rows_kernel<L, W, G><<<blocks, kThreads, smem, stream>>>(
      rows, pay, keys, bucket, trailing, Wg, C, R, n, B2, consts, KW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n = C R; B2 >= 2 bucket slots a window; threads_per_lane: G, 2 or 6;
// any other value is refused, as is a shared_bytes other than the
// block's scan_smem_bytes<L, G>; wide: host memory, the words of
// msm::WideConsts<L, W>.
extern "C" int msm_smvp_rows(int num_limbs, int limb_bits, const int16_t* rows,
                             const int32_t* pay, const int32_t* keys,
                             int32_t* bucket, int32_t* trailing, int Wg, int C,
                             int R, int64_t n, int B2, int threads_per_lane,
                             int64_t shared_bytes, const int32_t* consts,
                             const uint32_t* wide, void* stream) {
  if (Wg < 1 || C < 1 || R < 1 || n != (int64_t)C * R || B2 < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    if (threads_per_lane == 2)
      return launch<L, W, 2>(rows, pay, keys, bucket, trailing, Wg, C, R, n,
                             B2, shared_bytes, consts, KW, s);
    if (threads_per_lane == 6)
      return launch<L, W, 6>(rows, pay, keys, bucket, trailing, Wg, C, R, n,
                             B2, shared_bytes, consts, KW, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
