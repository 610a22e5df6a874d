// A complete projective add shared by kAddG threads of one warp, on
// points and scratch in shared memory, with the word-wide multiply: the add of
// padd_batch.cu, globalize.cu and pbpr_stage1.cu.
//
// The add (RCB Algorithm 7, Field::padd) runs in four phases, and the
// caller puts a warp barrier after each: the six independent products
// of level 1 (x1 x2, y1 y2, z1 z2, (x1 + y1)(x2 + y2), (y1 + z1)(y2 +
// z2), (x1 + z1)(x2 + z2)), the adds between the levels, the six
// products of level 2 (t3 t1, t4 yz, t1 z3, yz t0, z3 t4, t0 t3), the
// sum. kAddG = 6 threads share an add: thread g takes product g of a
// level and limbs g, g + kAddG, ... of the adds (3 threads an add, two
// products a thread, were timed too in pbpr_stage1.cu: slower at both
// of its shapes; PERF.md). The operands and their order are those of
// pbpr_full.cu's Shared::padd_level1/mid/level2/finish, so the sum is
// bit-identical to Field::padd and to ops/rows.py padd_rows. Each
// product is one call of msm::mul_wide, out of line: cicc (CUDA 12.8)
// failed on many inlined multiplies, and the threads of a warp that
// reach the call together stay converged.
//
// Below the add: the lanes of a one-shot batch add, out = p + q over n
// lanes (padd_batch.cu, globalize.cu). A lane is one add, kAddG threads
// of one warp, 5 lanes a warp (the last two threads idle), 1 to
// kPaddMaxWarps warps a block (cuzk/kernels.py `padd_batch_geometry`).
// The block first loads its lanes' limbs into shared memory: each
// (coordinate, limb) row of its lanes is contiguous in device memory, so
// the loads are coalesced (plain loads: an int16 element is narrower
// than cp.async's 4 bytes, and nothing overlaps them in a one-shot
// launch). The sums go back to shared memory, and the block stores them
// row by row in the requested dtype (plain truncating casts, exact by
// the limb bound), coalesced.
#pragma once

#include "mul_wide.cuh"

namespace msm {

constexpr int kAddG = 6;   // threads of one warp that share an add

// An add's scratch in int32 words: the six products of a level (P) and
// the six operands of level 2 (T).
template <int L>
struct AddScratch {
  static constexpr int P = 0, T = 6 * L, WORDS = 12 * L;
};

template <int L, int W>
struct Phases {
  using S = AddScratch<L>;
  using WC = WideConsts<L, W>;

  // Level 1 of p1 + p2 into s, product g by thread g. The thread of a
  // product of sums writes the two sums itself, where the product goes
  // and where level 2's operand of the same index goes, which no other
  // product of the level reads: so p2 may lie in s's T[0, 3 L).
  static __device__ __forceinline__ void level1(const int32_t* p1,
                                                const int32_t* p2, int32_t* s,
                                                int g, const WC& KW) {
    for (int j = g; j < 6; j += kAddG) {
      int32_t* o = s + S::P + j * L;
      const int32_t* a = p1 + j * L;
      const int32_t* b = p2 + j * L;
      if (j >= 3) {
        const int u = j == 4 ? L : 0;          // x + y, y + z, x + z
        const int v = j == 3 ? L : 2 * L;
        int32_t* t = s + S::T + j * L;
        for (int i = 0; i < L; i++) {
          o[i] = p1[u + i] + p1[v + i];
          t[i] = p2[u + i] + p2[v + i];
        }
        a = o;
        b = t;
      }
      mul_wide<L, W>(a, b, o, KW);
    }
  }

  // T = t3 t4 t1 yz z3 t0 from the products.
  static __device__ __forceinline__ void mid(int32_t* s, int g,
                                             const Consts<L>& K) {
    for (int i = g; i < L; i += kAddG) {
      const int32_t* P = s + S::P + i;
      int32_t* T = s + S::T + i;
      const int32_t m0 = P[0], m1 = P[L], m2 = P[2 * L];
      const int32_t m3 = P[3 * L], m4 = P[4 * L], m5 = P[5 * L];
      const int32_t t2 = m2 * K.b3;
      T[0] = m3 - (m0 + m1) + K.kp4[i];                   // t3
      T[L] = m4 - (m1 + m2) + K.kp4[i];                   // t4
      T[2 * L] = m1 - t2 + K.kpb3x2[i];                   // t1
      T[3 * L] = (m5 - (m0 + m2) + K.kp4[i]) * K.b3;      // yz
      T[4 * L] = m1 + t2;                                 // z3
      T[5 * L] = m0 * 3;                                  // t0
    }
  }

  // t3 t1, t4 yz, t1 z3, yz t0, z3 t4, t0 t3 into P, as level 1 shares
  // them out.
  static __device__ __forceinline__ void level2(int32_t* s, int g,
                                                const WC& KW) {
    for (int j = g; j < 6; j += kAddG) {
      const int b = j < 4 ? j + 2 : 5 - j;   // T index of the second operand
      mul_wide<L, W>(s + S::T + j * L, s + S::T + b * L, s + S::P + j * L,
                     KW);
    }
  }

  // The sum (x3, y3, z3) into out, which may be p1's words.
  static __device__ __forceinline__ void finish(const int32_t* s, int g,
                                                int32_t* out,
                                                const Consts<L>& K) {
    for (int i = g; i < L; i += kAddG) {
      const int32_t* P = s + S::P + i;
      out[i] = P[0] - P[L] + K.kp2[i];
      out[L + i] = P[2 * L] + P[3 * L];
      out[2 * L + i] = P[4 * L] + P[5 * L];
    }
  }
};

// ---------------------------------------------------------------------------
// the lanes of a one-shot batch add
// ---------------------------------------------------------------------------

constexpr int kPaddMaxWarps = 4;   // warps a block at most; the wrapper picks
constexpr int kPaddLanesPerWarp = 32 / kAddG;

// A lane's int32 words, which its kAddG threads share: p1, then the
// add's scratch. p2 sits in the scratch's T[0, 3 L) until level 1 has
// read it, the sum in p1's words until the block stores it.
template <int L>
struct PaddLane {
  static constexpr int P1 = 0, S = 3 * L, P2 = S + AddScratch<L>::T;
  static constexpr int WORDS = S + AddScratch<L>::WORDS;   // 15 L
  static constexpr int STRIDE = WORDS | 1;   // odd: lanes on distinct banks
};

// The block's lanes of out = p + q over n lanes; p, q and out are
// (3, L, lanes), each (coordinate, limb) row of p and out n elements
// long. Without kWrapQ (padd_batch) q's rows are too, and lane f reads q
// at f; with it (globalize, the per-column prefix S broadcast over the
// rows) q's rows are nq elements long, and lane f reads q at f mod nq,
// taken in 32 bits (the entry refuses n >= 2^32: no 64-bit division,
// whose code would cost registers). negate: q.y -> 4p - y in Tin as it
// loads, as pneg_stacked computes it (psub_batch). Every thread of the
// block calls it (it holds __syncthreads).
template <int L, int W, typename Tin, typename Tout, bool kWrapQ>
__device__ __forceinline__ void padd_block(const Tin* __restrict__ p,
                                           const Tin* __restrict__ q,
                                           Tout* __restrict__ out, int64_t n,
                                           int64_t nq, int negate,
                                           const int32_t* __restrict__ kc,
                                           const WideConsts<L, W> KW) {
  constexpr int LPW = kPaddLanesPerWarp;
  using M = PaddLane<L>;
  using Ph = Phases<L, W>;
  __shared__ Consts<L> K;
  __shared__ WideConsts<L, W> KWs;
  extern __shared__ int32_t lanes[];     // [lanes a block][STRIDE]
  if (threadIdx.x == 0) KWs = KW;
  load_consts<L>(K, kc);                 // ends in __syncthreads

  const int lpb = (blockDim.x >> 5) * LPW;
  const int64_t f0 = (int64_t)blockIdx.x * lpb;
  const int nl = static_cast<int>(n - f0 < lpb ? n - f0 : lpb);
  // element (row, lane l) <-> thread l + lpb * (row mod rstep)
  const int rstep = blockDim.x / lpb;
  const int ll = threadIdx.x % lpb;
  const int r0 = threadIdx.x / lpb;
  const bool mover = r0 < rstep && ll < nl;
  const int64_t f = f0 + ll;
  if (mover) {
    const int64_t fq = kWrapQ ? static_cast<uint32_t>(f) %
                                    static_cast<uint32_t>(nq)
                              : f;
    int32_t* m = lanes + ll * M::STRIDE;
    for (int row = r0; row < 3 * L; row += rstep) {
      m[M::P1 + row] = static_cast<int32_t>(p[(int64_t)row * n + f]);
      Tin y = q[(int64_t)row * nq + fq];
      if (negate && row >= L && row < 2 * L)   // y -> 4p - y in Tin
        y = static_cast<Tin>(static_cast<uint32_t>(K.kp4[row - L]) -
                             static_cast<uint32_t>(static_cast<int32_t>(y)));
      m[M::P2 + row] = static_cast<int32_t>(y);
    }
  }
  __syncthreads();

  const int lw = (threadIdx.x & 31) / kAddG;   // lane within the warp
  const int g = (threadIdx.x & 31) % kAddG;    // thread within the lane
  const int l = (threadIdx.x >> 5) * LPW + lw;
  const bool active = lw < LPW && l < nl;
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
    for (int row = r0; row < 3 * L; row += rstep)
      out[(int64_t)row * n + f] =
          static_cast<Tout>(lanes[ll * M::STRIDE + M::P1 + row]);
  }
}

// Launch a batch-add kernel on `warps` warps a block, with its lanes'
// shared memory; the launch's cudaError_t.
template <int L, typename... Params, typename... Args>
int launch_padd_lanes(void (*kernel)(Params...), int warps, int blocks,
                      cudaStream_t stream, Args... args) {
  const size_t smem = (size_t)warps * kPaddLanesPerWarp *
                      PaddLane<L>::STRIDE * sizeof(int32_t);
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// fn(Tin{}, Tout{}) for element widths in_bits and out_bits, each 16 or
// 32; cudaErrorInvalidValue for any other.
template <typename Fn>
int dispatch_widths(int in_bits, int out_bits, Fn fn) {
  if (in_bits == 16 && out_bits == 16) return fn(int16_t{}, int16_t{});
  if (in_bits == 16 && out_bits == 32) return fn(int16_t{}, int32_t{});
  if (in_bits == 32 && out_bits == 16) return fn(int32_t{}, int16_t{});
  if (in_bits == 32 && out_bits == 32) return fn(int32_t{}, int32_t{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace msm
