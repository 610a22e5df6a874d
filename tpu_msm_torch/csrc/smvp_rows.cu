// The row walk of the XLA path's bucket accumulation: the runs of equal
// keys down each column of the sorted point stream, each summed in row
// order and written into its bucket where it ends.
//
// Replaces no pallas_call: the counterpart of the lax.fori_loop body of
// tpu_msm/cuzk/smvp.py:94-110 (`bucket_accumulate`), which XLA compiles
// into one device loop and which the port ran as a Python loop of torch
// ops, one ops/complete.pmadd (about 6,000 launches at L = 22) a row.
// What it computes, in the plain version's order (cuzk/kernels.py
// smvp_rows_plain): column c of window w is the sorted positions
// c R .. c R + R - 1. Row r is the point idx = pay >> 1, its y folded to
// 2p - y where pay & 1. At a run start (r = 0, or a key other than row
// r - 1's) the running sum restarts at (x, y, Montgomery one); else it
// becomes pmadd_rows(sum, x, y). Where a run ends (the next key in global
// order differs: row r + 1's; after the last row the first key of
// column c + 1, and -1 after the last column) the sum is written into
// bucket[:, :, w, key]. The sum after each column's last row goes into
// trailing[:, :, w, c], the input of the stitch across columns
// (cuzk/smvp.py).
// Bound on the H100: operations (one complete mixed add, 12 word-wide
// multiplies of mul_wide.cuh, per stream element but a run's first in
// its column, as prefix_scan). Since a run restarts from its own first
// point, the runs of a column do not depend on each other: the chain of
// dependent adds the keys need is the longest run inside one column (58
// rows at the 2^20 shape, R = 128), not R; but at the XLA path's shapes
// (8,192 columns a group on 132 SMs) the card already runs at its
// throughput with a lane a column (a form whose lanes split the columns
// into segments of their runs was tried and dropped: no shape of the
// port's paths took it; PERF.md).
// Design: a lane a column, walking its R rows in order. The lane is
// prefix_scan's (scan_lane.cuh: six threads a lane, its words in shared
// memory, the multiplies out of line) on the shorter RunMem layout, a
// block one warp of five lanes, so that a group's columns spread over
// the SMs a warp at a time. Its steps are as in prefix_scan: the row of
// the next step gathered by cp.async into the other half of a double
// buffer, and the key and payload after it loaded a step ahead, while
// this step adds. A run start takes the row in place of the mixed add
// (the plain version computes that add and drops it by a select); a
// run's sum is written at its last row, where the next key in global
// order differs. The lanes of a warp walk the same rows in step by
// themselves; every barrier holds the lane's own threads only, since a
// lane reads and writes only its own words of shared memory. A key
// outside [0, B2 - 1) is written nowhere, as the JAX scatter drops its
// out-of-range index; the caller's keys are |digits| <= B = B2 - 2.
// Layouts: rows (n, 2L) int16, aligned to the piece; pay, keys (Wg, n)
// int32 in sorted order; bucket (3, L, Wg, B2) int32, filled with
// infinity by the caller (a slot where no run ends keeps it); trailing
// (3, L, Wg, C) int32.
#include <cstring>

#include "scan_lane.cuh"

namespace {

// the lane of scan_lane.cuh: RunMem, RowPiece, pmadd_shared, the copies
using namespace msm::scan;

// The lane's running point (X1, Y1, Z1) into the (3, L) column at o,
// element k at o[k * stride]; thread g stores limbs g, g + G, ...
template <int L, int G>
__device__ __forceinline__ void store_point(const int32_t* m, int g,
                                            int32_t* o, int64_t stride) {
  using M = RunMem<L>;
  for (int i = g; i < L; i += G) {
    o[(int64_t)i * stride] = m[M::X1 + i];
    o[(int64_t)(L + i) * stride] = m[M::Y1 + i];
    o[(int64_t)(2 * L + i) * stride] = m[M::Z1 + i];
  }
}

// A lane is kG = 6 threads of a warp, two levels of the add's products
// deep (G = 2, six deep, ran slower at the shapes tried), and a block is
// one warp of kLanes = 5 lanes (its last two threads idle). The bytes of
// dynamic shared memory of a block: the double-buffered rows of its
// lanes, then their states. The launch refuses a caller whose count
// (cuzk/kernels.py `smvp_rows_smem`) differs.
constexpr int kG = 6;
constexpr int kLanes = 32 / kG;

template <int L>
constexpr size_t rows_smem_bytes() {
  return 2 * kLanes * RowPiece<L>::Q * sizeof(typename RowPiece<L>::T) +
         kLanes * RunMem<L>::STRIDE * sizeof(int32_t);
}

// At most 128 registers a thread up to L = 22, so that 16 blocks (80
// lanes) fit an SM; at L = 30 and 32 no cap (ptxas takes 204 and 128
// there without spills, where a cap of 128 spilled).
template <int L, int W>
__global__ void __launch_bounds__(32, L <= 22 ? 16 : 1)
rows_kernel(const int16_t* __restrict__ rows, const int32_t* __restrict__ pay,
            const int32_t* __restrict__ keys, int32_t* __restrict__ bucket,
            int32_t* __restrict__ trailing, int Wg, int C, int R, int64_t n,
            int B2, const int32_t* __restrict__ kc,
            const msm::WideConsts<L, W> KW) {
  constexpr int G = kG;
  using Piece = typename RowPiece<L>::T;
  constexpr int Q = RowPiece<L>::Q;    // pieces a row
  using M = RunMem<L>;
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  extern __shared__ int2 dyn[];        // 8-byte aligned
  Piece* rowbuf = reinterpret_cast<Piece*>(dyn);          // [2][kLanes][Q]
  int32_t* lanes = reinterpret_cast<int32_t*>(rowbuf + 2 * kLanes * Q);
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);          // ends in __syncthreads
  const int lw = threadIdx.x / G;      // lane of the block, one warp
  const int g = threadIdx.x % G;       // thread within the lane
  const int64_t F = (int64_t)Wg * C;
  const int64_t f = (int64_t)blockIdx.x * kLanes + lw;   // the column
  if (lw >= kLanes || f >= F) return;
  const unsigned mask = ((1u << G) - 1) << (lw * G);   // the lane's threads
  const int64_t wl = f / C, c = f % C;
  const int32_t* p = pay + wl * n + c * (int64_t)R;
  const int32_t* kp = keys + wl * n + c * (int64_t)R;
  const int64_t plane = (int64_t)Wg * B2;  // one (coord, limb) plane
  int32_t* bk = bucket + wl * B2;          // + key: the window's slot
  const Piece* table = reinterpret_cast<const Piece*>(rows);
  int32_t* m = lanes + lw * M::STRIDE;     // the lane's state
  // the key after row r: row r + 1's; after the last row the next
  // column's first key, -1 after the last column
  const bool more_cols = c + 1 < C;
  auto key_after = [&](int r) {
    return (r + 1 < R || more_cols) ? kp[r + 1] : -1;
  };

  // row 0's payload and row copy; the key and payload after it
  int32_t v = p[0];
  for (int q = g; q < Q; q += G)
    cp_async(&rowbuf[lw * Q + q], table + (int64_t)(v >> 1) * Q + q);
  int32_t key = kp[0], knext = key_after(0);
  int32_t vnext = R > 1 ? p[1] : 0;
  bool start = true;
  for (int r = 0; r < R; r++) {
    const int32_t khere = key, kafter = knext;
    cp_async_wait();
    __syncwarp(mask);
    // row r has arrived: unpack it
    const int16_t* rb =
        reinterpret_cast<const int16_t*>(rowbuf + ((r & 1) * kLanes + lw) * Q);
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
    // the next row's copy and, a step ahead, the key and payload after it
    if (r + 1 < R) {
      v = vnext;
      for (int q = g; q < Q; q += G)
        cp_async(&rowbuf[(((r + 1) & 1) * kLanes + lw) * Q + q],
                 table + (int64_t)(v >> 1) * Q + q);
      key = kafter;
      knext = key_after(r + 1);
      vnext = r + 2 < R ? p[r + 2] : 0;
    }
    __syncwarp(mask);
    if (!start)
      pmadd_shared<L, W, G, false, M>(m, g, mask, nullptr, 0, K, KWs);
    // the run ends at row r where the next key in global order differs
    if (kafter != khere && (unsigned)khere < (unsigned)(B2 - 1))
      store_point<L, G>(m, g, bk + khere, plane);
    start = kafter != khere;
  }
  store_point<L, G>(m, g, trailing + f, F);
}

template <int L, int W>
int launch(const int16_t* rows, const int32_t* pay, const int32_t* keys,
           int32_t* bucket, int32_t* trailing, int Wg, int C, int R,
           int64_t n, int B2, int blocks, int64_t shared_bytes,
           const int32_t* consts, const msm::WideConsts<L, W>& KW,
           cudaStream_t stream) {
  constexpr size_t smem = rows_smem_bytes<L>();
  // the caller's reckoning (cuzk/kernels.py smvp_rows_geometry) must
  // agree: a lane a column, kLanes a block
  const int64_t F = (int64_t)Wg * C;
  if (shared_bytes != static_cast<int64_t>(smem) ||
      blocks != (F + kLanes - 1) / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = cudaFuncSetAttribute(
      rows_kernel<L, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rows_kernel<L, W><<<static_cast<unsigned>(blocks), 32, smem, stream>>>(
      rows, pay, keys, bucket, trailing, Wg, C, R, n, B2, consts, KW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n = C R; B2 >= 2 bucket slots a window; blocks: ceil(Wg C / 5), a lane
// a column; any other value is refused, as is a shared_bytes other than
// the block's rows_smem_bytes<L>; wide: host memory, the words of
// msm::WideConsts<L, W>.
extern "C" int msm_smvp_rows(int num_limbs, int limb_bits, const int16_t* rows,
                             const int32_t* pay, const int32_t* keys,
                             int32_t* bucket, int32_t* trailing, int Wg, int C,
                             int R, int64_t n, int B2, int blocks,
                             int64_t shared_bytes, const int32_t* consts,
                             const uint32_t* wide, void* stream) {
  if (Wg < 1 || C < 1 || R < 1 || n != (int64_t)C * R || B2 < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    return launch<L, W>(rows, pay, keys, bucket, trailing, Wg, C, R, n, B2,
                        blocks, shared_bytes, consts, KW, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
