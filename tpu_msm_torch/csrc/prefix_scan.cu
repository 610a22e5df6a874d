// Running prefix sums of the sorted, sign-folded point stream.
//
// Replaces tpu_msm/cuzk/kernels.py `_scan_kernel` / `prefix_scan`, and
// folds in the row gather and relayout that pipeline_pallas.py runs
// around it (`group_body`, :265-274).
// Bound on the H100: operations in total (one complete mixed add, 12
// word-wide Montgomery multiplies of mul_wide.cuh, 315 int32 multiply
// and multiply-add halves each at L = 22, per stream element, against
// 4 L bytes of gathered row and 6 L bytes of int16 output), but depth at
// the shapes the MSM gives it: each lane is a chain of R dependent adds,
// and the schedule's F = Wg * C lanes (8192) are 512 warps at G = 2, one
// a warp scheduler, each step on its lone-warp floor; at G = 6 they are
// 1,639 warps, up to four a scheduler, whose products' issue is longer
// (PERF.md).
// Design: G threads of one warp per lane f = (w mod Wg) * C + c; the lane
// walks the R rows of its column (the lane of scan_lane.cuh, which
// smvp_rows.cu shares). The 12 multiplies of the mixed add
// fall into two levels of six that do not depend on each other. The
// lane's state (running point, row, operands and products, 19 segments)
// lives in shared memory; thread g computes products g, g + G, ... of a
// level with msm::mul_wide (out of line, the word constants in shared
// memory) on pointers into it, and limbs g, g + G, ... of every add
// between the levels, with a warp barrier after each phase. Each
// product takes the operands of ops/rows.py pmadd_rows in the same
// order, and mul_wide is its mont_mul_rows bit for bit on every pair of
// operands, so the result is bit-identical to pmadd_rows whatever G is.
// State in shared memory also keeps the threads' stack frames empty: with
// the state copied into every thread (an earlier form of this kernel)
// more than four warps an SM overflowed the L1 with local memory and
// G = 6 ran seven times slower than G = 2 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md has the times). The kernel is built for G = 2 and
// G = 6. G = 1 (the mixed add on a point in the thread, the
// one-thread-a-lane kernel this replaces, with the gather ahead) and
// G = 3 were built and timed too on the 12-bit multiply, were the
// fastest at no lane count, and were taken out; G = 3 again on the
// word-wide one, fastest only at BN254_S13 on 131,072 lanes (by 3 %),
// and taken out again; PERF.md keeps their times.
// The launcher takes G from the wrapper, which picks it from the lane
// count, the SM count and L (cuzk/kernels.py `prefix_scan_geometry`).
// With G = 6 a warp holds 5 lanes and its last two threads exit at once.
// The lane's words are 19 segments of L | 1 words, an odd count, so the
// threads of a lane that touch the same limb of different segments hit
// different banks: with segments of L = 32 words (BLS12_377_S12) all
// six threads of a G = 6 lane hit one bank, and the scan ran 1.5 times
// as long at 8,192 lanes (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// The gather runs ahead of the arithmetic: the 4 L-byte row of step r + 1
// and the payload of step r + 2 are copied to shared memory by cp.async
// (pieces shared out among the lane's threads: 8 bytes where L is even,
// 4 where it is odd, as at BN254_S13's L = 21, whose 84-byte rows are no
// whole number of 8-byte pieces) before the add of step r starts, so the
// random read is not in the chain. The 3 L int16 stores of a step are
// shared out among the lane's threads too.
// Per step: the sorted payload idx << 1 | sign, the int16 (x, y) row of
// point idx from the points-major table, the sign (y -> 2p - y), the
// mixed add, T written as int16. Layouts (see cuzk/pipeline_cuda.py):
//   rows (n, 2L) int16, aligned to the piece; pay (Wg, n) int32;
//   out (3, L, R, Wg * C) int16.
#include <cstring>

#include "scan_lane.cuh"

namespace {

// the lane of scan_lane.cuh: LaneMem, RowPiece, pmadd_shared, the copies
using namespace msm::scan;

template <int L, int W, int G>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int16_t* __restrict__ rows, const int32_t* __restrict__ pay,
            int16_t* __restrict__ out, int Wg, int C, int R, int64_t n,
            const int32_t* __restrict__ kc, const msm::WideConsts<L, W> KW) {
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
  const bool active = lw < LPW && f < F;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (!active) return;
  const int slot = warp * LPW + lw;
  const int64_t wl = f / C, c = f % C;
  const int32_t* p = pay + wl * n + c * (int64_t)R;
  const int64_t stride = (int64_t)R * F;   // one (coord, limb) plane
  const Piece* table = reinterpret_cast<const Piece*>(rows);
  int32_t* m = lanes + slot * M::STRIDE;   // the lane's state
  for (int i = g; i < L; i += G) {         // the running point: infinity
    m[M::X1 + i] = 0;
    m[M::Y1 + i] = K.one[i];
    m[M::Z1 + i] = 0;
  }

  int32_t v = p[0];
  for (int q = g; q < Q; q += G)
    cp_async(&rowbuf[slot * Q + q], table + (int64_t)(v >> 1) * Q + q);
  if (g == 0 && R > 1) cp_async(&paybuf[LPB + slot], p + 1);
  for (int r = 0; r < R; r++) {
    cp_async_wait();
    __syncwarp(mask);
    // row r has arrived: unpack it, then start the copies of the next
    const int16_t* rb =
        reinterpret_cast<const int16_t*>(rowbuf + ((r & 1) * LPB + slot) * Q);
    const bool neg = v & 1;
    for (int i = g; i < L; i += G) {
      const int32_t xi = rb[i], yr = rb[L + i];
      const int32_t yi = neg ? K.kp2[i] - yr : yr;
      m[M::X2 + i] = xi;
      m[M::Y2 + i] = yi;
      m[M::U + i] = m[M::X1 + i] + m[M::Y1 + i];
      m[M::V + i] = xi + yi;
    }
    if (r + 1 < R) {
      v = paybuf[((r + 1) & 1) * LPB + slot];
      for (int q = g; q < Q; q += G)
        cp_async(&rowbuf[(((r + 1) & 1) * LPB + slot) * Q + q],
                 table + (int64_t)(v >> 1) * Q + q);
      if (g == 0 && r + 2 < R)
        cp_async(&paybuf[(r & 1) * LPB + slot], p + r + 2);
    }
    __syncwarp(mask);
    pmadd_shared<L, W, G, true>(m, g, mask, out + (int64_t)r * F + f, stride,
                                K, KWs);
  }
}

template <int L, int W, int G>
int launch(const int16_t* rows, const int32_t* pay, int16_t* out, int Wg,
           int C, int R, int64_t n, int64_t shared_bytes,
           const int32_t* consts, const msm::WideConsts<L, W>& KW,
           cudaStream_t stream) {
  // G = 2 keeps 64 lanes a block: above the 48 KB a kernel gets unasked
  constexpr size_t smem = scan_smem_bytes<L, G>();
  // the caller's reckoning (cuzk/kernels.py prefix_scan_smem) must agree
  if (shared_bytes != static_cast<int64_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      scan_kernel<L, W, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int64_t lanes = kWarps * (32 / G);
  const int64_t F = (int64_t)Wg * C;
  const unsigned blocks = static_cast<unsigned>((F + lanes - 1) / lanes);
  scan_kernel<L, W, G><<<blocks, kThreads, smem, stream>>>(
      rows, pay, out, Wg, C, R, n, consts, KW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// threads_per_lane: G, 2 or 6; any other value is refused, as is a
// shared_bytes other than the block's scan_smem_bytes<L, G>; wide: host
// memory, the words of msm::WideConsts<L, W>.
extern "C" int msm_prefix_scan(int num_limbs, int limb_bits, const int16_t* rows,
                               const int32_t* pay, int16_t* out, int Wg, int C,
                               int R, int64_t n, int threads_per_lane,
                               int64_t shared_bytes, const int32_t* consts,
                               const uint32_t* wide, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    if (threads_per_lane == 2)
      return launch<L, W, 2>(rows, pay, out, Wg, C, R, n, shared_bytes,
                             consts, KW, s);
    if (threads_per_lane == 6)
      return launch<L, W, 6>(rows, pay, out, Wg, C, R, n, shared_bytes,
                             consts, KW, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
