// The lane of the row walks: G threads of one warp share a lane that
// walks the R rows of one column of the sorted point stream, one
// complete mixed add (ops/rows.py pmadd_rows) a row. prefix_scan.cu
// stores every running sum; smvp_rows.cu restarts at each bucket run and
// stores the sum at its end.
//
// The 12 multiplies of the mixed add fall into two levels of six that do
// not depend on each other. The lane's state (running point, row,
// operands and products, 19 segments) lives in shared memory; thread g
// computes products g, g + G, ... of a level with msm::mul_wide (out of
// line, the word constants in shared memory) on pointers into it, and
// limbs g, g + G, ... of every add between the levels, with a warp
// barrier after each phase. Each product takes the operands of
// pmadd_rows in the same order, and mul_wide is its mont_mul_rows bit for
// bit on every pair of operands, so the sum is bit-identical to
// pmadd_rows whatever G is. The gather of the next row runs ahead by
// cp.async (RowPiece). prefix_scan lays the lane out as LaneMem,
// smvp_rows as the shorter RunMem.
#pragma once

#include <type_traits>

#include "mul_wide.cuh"

namespace msm {
namespace scan {

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

// The same words in 14 segments: the six of T take the places of z1, the
// row and the sums, which no phase reads once level 1 is done, and one
// segment more. pmadd_shared's phases keep it race-free: level 1 reads
// them all before its barrier; the adds read only P, x1 and y1 and write
// T; level 2 reads T and writes P; the last phase reads P and writes the
// point. 14 segments let two blocks of 64 lanes share an SM where
// LaneMem's 19 take one.
template <int L>
struct RunMem {
  static constexpr int S = L | 1;
  static constexpr int X1 = 0, Y1 = S;
  static constexpr int T = 2 * S;                       // t3 t4 t1 yz z3 t0
  static constexpr int Z1 = 2 * S, X2 = 3 * S, Y2 = 4 * S;
  static constexpr int U = 5 * S, V = 6 * S;
  static constexpr int P = 8 * S;                       // six products
  static constexpr int WORDS = 14 * S;
  static constexpr int STRIDE = WORDS | 1;
};

// Operands of product j of level 1, in the order of pmadd_rows:
// x1 x2, y1 y2, (x1 + y1)(x2 + y2), y2 z1, x2 z1, z1 b3m.
template <class M>
__device__ __forceinline__ int level1_a(int j) {
  switch (j) {
    case 0: return M::X1;
    case 1: return M::Y1;
    case 2: return M::U;
    case 3: return M::Y2;
    case 4: return M::X2;
    default: return M::Z1;
  }
}

template <class M>
__device__ __forceinline__ int level1_b(int j) {
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
// shared memory `m` (U and V already hold x1 + y1 and x2 + y2), the six
// word-wide multiplies of each level and the limbs of every add shared
// out among the threads, a barrier of `mask` after each phase. Ends with
// the new point in m and, with kStore, its int16 limbs stored to `o`
// (element k at o[k * stride]); the caller synchronises the threads of
// `mask` before the next step reads m. M: the lane's layout, LaneMem or
// RunMem.
template <int L, int W, int G, bool kStore, class M = LaneMem<L>>
__device__ __forceinline__ void pmadd_shared(int32_t* m, int g, unsigned mask,
                                             int16_t* o, int64_t stride,
                                             const Consts<L>& K,
                                             const WideConsts<L, W>& KW) {
  constexpr int S = M::S;
#pragma unroll
  for (int k = 0; k < 6 / G; k++) {
    const int j = g + k * G;
    mul_wide<L, W>(m + level1_a<M>(j), j == 5 ? K.b3m : m + level1_b<M>(j),
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
    mul_wide<L, W>(m + M::T + j * S, m + M::T + level2_b(j) * S,
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
    if constexpr (kStore) {
      o[(int64_t)i * stride] = static_cast<int16_t>(x3);
      o[(int64_t)(L + i) * stride] = static_cast<int16_t>(y3);
      o[(int64_t)(2 * L + i) * stride] = static_cast<int16_t>(z3);
    }
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
// and payloads of its lanes, then their states. The launches refuse a
// caller whose count (cuzk/kernels.py `prefix_scan_smem`) differs.
template <int L, int G>
constexpr size_t scan_smem_bytes() {
  constexpr int LPB = kWarps * (32 / G);
  return 2 * LPB * RowPiece<L>::Q * sizeof(typename RowPiece<L>::T) +
         2 * LPB * sizeof(int32_t) +
         LPB * LaneMem<L>::STRIDE * sizeof(int32_t);
}

}  // namespace scan
}  // namespace msm
