// Stage 1 of the parallel bucket-points reduction (cuZK Alg. 4), the
// lanes of one block: the stage 1 of pbpr_stage1.cu and of pbpr_full.cu.
//
// A lane (window w, slice t) walks the Bt = B / T buckets
// t Bt + Bt - 1 - j, j = 0 .. Bt - 1, from the top down, with
// m += bucket; g += m, both from infinity, in the plain version's order
// (cuzk/kernels.py pbpr_stage1_plain). A lane is 2 kAddG = 12 threads of
// one warp, 6 for the m add and 6 for the g add, 2 lanes a warp (its
// last 8 threads idle; 6 threads a lane, 3 a chain, 5 lanes a warp, was
// built and timed too: level at the 2^16 shapes and 1.3 times as slow
// at 2^20, with fewer warps an SM to hide the multiply's latency;
// PERF.md). The g add of step j needs m_j and g_(j-1); the m add of step
// j + 1 needs only m_j: so both run at once, and the lane is Bt + 1
// steps deep, not 2 Bt. Each add runs padd_lane.cuh's four phases with a
// warp barrier after each (thread g of a chain takes product g of a
// level). The lane's state lives in shared memory (m, g, two bucket
// buffers, and the scratch of the two adds: 36 L words, an odd stride),
// so the threads' stack frames stay empty. The next bucket comes in by
// cp.async while a step computes. Neighbouring lanes read buckets Bt
// apart: not coalesced, and a small part of a step. An int32 element is
// fetched as its own word, an int16 one as the 4-byte word that holds it
// (the wrapper checks the alignment and that 3 L Wp B is even, so the
// last word lies inside the tensor) and unpacked in place. Element
// indices are 32-bit (the entries refuse 3 L Wp B >= 2^31): with 64-bit
// ones the loop's state no longer fit beside the multiply in 64
// registers, and spilled. A block is 1 to kStage1MaxWarps warps
// (cuzk/kernels.py `pbpr_stage1_geometry`, which keeps every lane
// resident at once where the card holds them); at the end it stores m
// and g row by row through shared memory, coalesced, in the caller's
// element type (plain truncating casts: int16 is exact by the
// (-2^W, 2^(W+1)) limb bound of an add's sum, W <= 13).
#pragma once

#include "padd_lane.cuh"

namespace msm {

// warps a block at most; the wrapper picks
constexpr int kStage1MaxWarps = 4;
constexpr int kStage1LaneThreads = 2 * kAddG;   // the m add's, the g add's
constexpr int kStage1LanesPerWarp = 32 / kStage1LaneThreads;

// Registers a thread at most: the geometry's residency counts on it
// (cuzk/kernels.py `pbpr_stage1_registers`), and the kernels'
// __launch_bounds__ hold ptxas to it. 64 keep the 8,192 lanes of the
// 2^20 MSM at L <= 22 in one wave on 132 SMs (72 would take two); at
// L = 30 and 32 the lanes' shared memory holds no more than 21 warps an
// SM, which 96 registers also allow (128 would take a wave more at the
// 2^16 MSM), and 64 and 80 spilled there (PERF.md).
__host__ __device__ constexpr int stage1_registers(int L) {
  return L <= 22 ? 64 : 96;
}

__host__ __device__ constexpr int stage1_min_blocks(int L) {
  return 65536 / (kStage1MaxWarps * 32 * stage1_registers(L));
}

// A lane's words: m, g, the two buffers of bucket words, and the scratch
// of the m add and of the g add.
template <int L>
struct Stage1Lane {
  static constexpr int M = 0, G = 3 * L, BK = 6 * L;
  static constexpr int SM = 12 * L, SG = SM + AddScratch<L>::WORDS;
  static constexpr int WORDS = SG + AddScratch<L>::WORDS;   // 36 L
  static constexpr int STRIDE = WORDS | 1;   // odd: lanes on distinct banks
  static constexpr int WARP_WORDS = kStage1LanesPerWarp * STRIDE;
};

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bucket element e: the word fetched for it, and its value from that word.
template <typename Tin>
struct Fetch;

template <>
struct Fetch<int32_t> {
  static __device__ __forceinline__ const int32_t* word(const int32_t* b,
                                                        int e) {
    return b + e;
  }
  static __device__ __forceinline__ int32_t value(int32_t v, int) {
    return v;
  }
};

template <>
struct Fetch<int16_t> {
  static __device__ __forceinline__ const int32_t* word(const int16_t* b,
                                                        int e) {
    return reinterpret_cast<const int32_t*>(b) + (e >> 1);
  }
  static __device__ __forceinline__ int32_t value(int32_t v, int e) {
    return (e & 1) ? static_cast<int16_t>(v >> 16) : static_cast<int16_t>(v);
  }
};

// The block's lanes of stage 1 over (3, L, Wp, B) buckets: m of lane f
// to m_out[(c L + i) * row + f], g to g_out likewise. Every thread of
// the block calls it (it holds __syncthreads).
template <int L, int W, typename Tin, typename Tout>
__device__ __forceinline__ void stage1_block(const Tin* __restrict__ buckets,
                                             Tout* __restrict__ m_out,
                                             Tout* __restrict__ g_out,
                                             int64_t row, int Wp, int B,
                                             int T,
                                             const int32_t* __restrict__ kc,
                                             const WideConsts<L, W> KW) {
  constexpr int Q = kStage1LaneThreads;
  constexpr int LPW = kStage1LanesPerWarp;
  using LM = Stage1Lane<L>;
  using Ph = Phases<L, W>;
  using Fe = Fetch<Tin>;
  __shared__ Consts<L> K;
  __shared__ WideConsts<L, W> KWs;
  extern __shared__ int32_t lanes[];     // [lanes a block][STRIDE]
  if (threadIdx.x == 0) KWs = KW;
  load_consts<L>(K, kc);                 // ends in __syncthreads

  const int64_t nlanes = (int64_t)Wp * T;
  const int lpb = (blockDim.x >> 5) * LPW;
  const int64_t f0 = (int64_t)blockIdx.x * lpb;
  const int nl = static_cast<int>(nlanes - f0 < lpb ? nlanes - f0 : lpb);
  const int lw = (threadIdx.x & 31) / Q;   // lane within the warp
  const int q = (threadIdx.x & 31) % Q;    // thread within the lane
  const int l = (threadIdx.x >> 5) * LPW + lw;
  const bool active = lw < LPW && l < nl;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (active) {
    int32_t* lm = lanes + l * LM::STRIDE;
    const int f = static_cast<int>(f0) + l;
    const int w = f / T, t = f % T;
    const int Bt = B / T;
    const int plane = Wp * B;
    const int top = w * B + t * Bt + Bt - 1;
    strided<L, Q>(q, [&](int i) {          // m = g = infinity
      lm[LM::M + i] = lm[LM::G + i] = 0;
      lm[LM::M + L + i] = lm[LM::G + L + i] = K.one[i];
      lm[LM::M + 2 * L + i] = lm[LM::G + 2 * L + i] = 0;
    });
    // element k of bucket top - j is buckets[k * plane + top - j]; this
    // thread fetches and unpacks k = q, q + Q, ...
    strided<3 * L, Q>(q, [&](int k) {
      cp_async4(lm + LM::BK + k, Fe::word(buckets, k * plane + top));
    });
    const int chain = q / kAddG;           // 0: the m add, 1: the g add
    const int g = q % kAddG;
    int32_t* sc = lm + (chain == 0 ? LM::SM : LM::SG);
    int32_t* acc = lm + (chain == 0 ? LM::M : LM::G);
    for (int j = 0; j <= Bt; j++) {
      int32_t* bk = lm + LM::BK + (j & 1) * 3 * L;
      if (j < Bt) {
        cp_async_wait_all();
        strided<3 * L, Q>(q, [&](int k) {
          bk[k] = Fe::value(bk[k], k * plane + top - j);
        });
        if (j + 1 < Bt) {
          int32_t* nxt = lm + LM::BK + ((j + 1) & 1) * 3 * L;
          strided<3 * L, Q>(q, [&](int k) {
            cp_async4(nxt + k, Fe::word(buckets, k * plane + top - j - 1));
          });
        }
      }
      __syncwarp(mask);
      // the m add of step j (m_j = m_(j-1) + bucket_j) and the g add of
      // step j - 1 (g_(j-1) = g_(j-2) + m_(j-1)) read m before either
      // writes
      const bool on = chain == 0 ? j < Bt : j > 0;
      const int32_t* p2 = chain == 0 ? bk : lm + LM::M;
      if (on) Ph::level1(acc, p2, sc, g, KWs);
      __syncwarp(mask);
      if (on) Ph::mid(sc, g, K);
      __syncwarp(mask);
      if (on) Ph::level2(sc, g, KWs);
      __syncwarp(mask);
      if (on) Ph::finish(sc, g, acc, K);
    }
  }
  __syncthreads();

  // m then g, row by row: element (r, lane ll) <-> thread ll + lpb *
  // (r mod rstep); m and g are a lane's first 6 L words. The indices are
  // read again (tid_now).
  const int t = tid_now(), nt = ntid_now(), lpb_s = (nt >> 5) * LPW;
  const int ll = t % lpb_s, r0 = t / lpb_s, rstep = nt / lpb_s;
  const int64_t f = (int64_t)ctaid_now() * lpb_s + ll;
  if (r0 < rstep && f < nlanes) {
    for (int r = r0; r < 6 * L; r += rstep) {
      Tout* out = r < 3 * L ? m_out : g_out;
      out[(int64_t)(r % (3 * L)) * row + f] =
          static_cast<Tout>(lanes[ll * LM::STRIDE + r]);
    }
  }
}

}  // namespace msm
