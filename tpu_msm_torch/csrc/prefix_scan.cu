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
// walks the R rows of its column. The 12 multiplies of the mixed add
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
#include <type_traits>

#include "mul_wide.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void cp_async(int2* smem, const int2* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's words of shared memory, which its G threads share: the
// running point, the row of this step, and the operands and products of
// the two levels of multiplies, 19 segments of L limbs. Offsets in int32
// words. A segment takes S = L | 1 words, an odd count, so the G
// threads of a lane, which read and write different segments at the
// same limb, fall on different banks (with S = L = 32, BLS12_377_S12's,
// all six on one), and the lane stride is odd too.
template <int L>
struct LaneMem {
  static constexpr int S = L | 1;                       // segment
  static constexpr int X1 = 0, Y1 = S, Z1 = 2 * S;      // running point
  static constexpr int X2 = 3 * S, Y2 = 4 * S;          // row, sign applied
  static constexpr int U = 5 * S, V = 6 * S;            // x1 + y1, x2 + y2
  static constexpr int P = 7 * S;                       // six products
  static constexpr int T = 13 * S;                      // t3 t4 t1 yz z3 t0
  static constexpr int WORDS = 19 * S;
  static constexpr int STRIDE = WORDS | 1;   // odd: lanes on distinct banks
};

// Operands of product j of level 1, in the order of pmadd_rows:
// x1 x2, y1 y2, (x1 + y1)(x2 + y2), y2 z1, x2 z1, z1 b3m.
template <int L>
__device__ __forceinline__ int level1_a(int j) {
  using M = LaneMem<L>;
  switch (j) {
    case 0: return M::X1;
    case 1: return M::Y1;
    case 2: return M::U;
    case 3: return M::Y2;
    case 4: return M::X2;
    default: return M::Z1;
  }
}

template <int L>
__device__ __forceinline__ int level1_b(int j) {
  using M = LaneMem<L>;
  switch (j) {
    case 0: return M::X2;
    case 1: return M::Y2;
    case 2: return M::V;
    default: return M::Z1;      // j = 5 takes b3m from the constants
  }
}

// Level 2 multiplies t3 t1, t4 yz, t1 z3, yz t0, z3 t4, t0 t3; T holds
// t3 t4 t1 yz z3 t0, so product j is T[j] * T[level2_b(j)].
__device__ __forceinline__ int level2_b(int j) {
  switch (j) {
    case 0: return 2;
    case 1: return 3;
    case 2: return 4;
    case 3: return 5;
    case 4: return 1;
    default: return 0;
  }
}

// One step of a lane that G threads share: pmadd_rows on the lane's
// shared memory `m`, the six word-wide multiplies of each level and the
// limbs of every add shared out among the threads. Ends with the new
// point in m and its int16 limbs stored to `o` (element k at
// o[k * stride]); the caller synchronises the warp before the next step
// reads m.
template <int L, int W, int G>
__device__ __forceinline__ void pmadd_shared(int32_t* m, int g, unsigned mask,
                                             int16_t* o, int64_t stride,
                                             const msm::Consts<L>& K,
                                             const msm::WideConsts<L, W>& KW) {
  using M = LaneMem<L>;
  constexpr int S = M::S;
#pragma unroll
  for (int k = 0; k < 6 / G; k++) {
    const int j = g + k * G;
    msm::mul_wide<L, W>(m + level1_a<L>(j),
                        j == 5 ? K.b3m : m + level1_b<L>(j),
                        m + M::P + j * S, KW);
  }
  __syncwarp(mask);
  for (int i = g; i < L; i += G) {
    const int32_t* P = m + M::P + i;
    const int32_t m0 = P[0], m1 = P[S], m2 = P[2 * S];
    const int32_t m3 = P[3 * S], m4 = P[4 * S], m5 = P[5 * S];
    int32_t* T = m + M::T + i;
    T[0] = m2 - (m0 + m1) + K.kp4[i];               // t3
    T[S] = m3 + m[M::Y1 + i];                       // t4
    T[2 * S] = m1 - m5 + K.kp2[i];                  // t1
    T[3 * S] = (m4 + m[M::X1 + i]) * K.b3;          // yz
    T[4 * S] = m1 + m5;                             // z3
    T[5 * S] = m0 * 3;                              // t0
  }
  __syncwarp(mask);
#pragma unroll
  for (int k = 0; k < 6 / G; k++) {
    const int j = g + k * G;
    msm::mul_wide<L, W>(m + M::T + j * S, m + M::T + level2_b(j) * S,
                        m + M::P + j * S, KW);
  }
  __syncwarp(mask);
  for (int i = g; i < L; i += G) {
    const int32_t* P = m + M::P + i;
    const int32_t x3 = P[0] - P[S] + K.kp2[i];
    const int32_t y3 = P[2 * S] + P[3 * S];
    const int32_t z3 = P[4 * S] + P[5 * S];
    m[M::X1 + i] = x3;
    m[M::Y1 + i] = y3;
    m[M::Z1 + i] = z3;
    o[(int64_t)i * stride] = static_cast<int16_t>(x3);
    o[(int64_t)(L + i) * stride] = static_cast<int16_t>(y3);
    o[(int64_t)(2 * L + i) * stride] = static_cast<int16_t>(z3);
  }
}

// The piece of a row that one cp.async copies: 8 bytes (two x or y
// limbs of int16 pairs) where the 4 L-byte row is a whole number of
// them, else 4. Q pieces a row.
template <int L>
struct RowPiece {
  using T = typename std::conditional<L % 2 == 0, int2, int32_t>::type;
  static constexpr int Q = 4 * L / static_cast<int>(sizeof(T));
};

// Bytes of dynamic shared memory of a block: the double-buffered rows
// and payloads of its lanes, then their states. The launch refuses a
// caller whose count (cuzk/kernels.py `prefix_scan_smem`) differs.
template <int L, int G>
constexpr size_t scan_smem_bytes() {
  constexpr int LPB = kWarps * (32 / G);
  return 2 * LPB * RowPiece<L>::Q * sizeof(typename RowPiece<L>::T) +
         2 * LPB * sizeof(int32_t) +
         LPB * LaneMem<L>::STRIDE * sizeof(int32_t);
}

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
    pmadd_shared<L, W, G>(m, g, mask, out + (int64_t)r * F + f, stride, K,
                          KWs);
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
