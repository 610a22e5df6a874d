// The whole parallel bucket-points reduction (cuZK Alg. 4) of each window.
//
// Replaces tpu_msm/cuzk/kernels.py `_pbpr_full_kernel` / `pbpr_full`.
// Bound on the H100: operations in total (per window 2 B complete adds
// in stage 1, T log2 T + 3 (T - 1) in the two lane scans, log2(B/T)
// doublings and one add, against 6 L bytes read per bucket), but depth
// at the shapes the MSM gives it: each lane of stage 1 is a chain of
// 2 Bt dependent adds (Bt = B / T), and the scans are 2 log2 T levels.
// What the kernel computes, in the TPU kernel's order (kernels.py
// :656-754): stage 1, slice t of Bt buckets walked from its top down
// with m += bucket; g += m; phase A, a suffix Hillis-Steele scan over the
// T lanes of m and g (lane t += lane t + k, infinity past the end); the
// mask (m lane 0 -> infinity, g lanes > 0 -> infinity); phase B, the same
// scan again; log2(Bt) doublings of m lane 0; G_w = g lane 0 + that.
// Every add and doubling is the same Field::mul on the same operands in
// the same order as Field::padd / Field::pdbl, so the output is
// bit-identical to the plain version.
// Design, two launches:
//  1. Stage 1, an ordinary launch over every SM: one lane (window, slice)
//     per 2 kG threads of a warp, Wp T lanes in all, in blocks of one
//     warp (kStage1Threads: one, two and four warps a block were timed
//     level at the MSM's shapes, PERF.md; one spreads the lanes most
//     evenly over the SMs). The lane's state (m,
//     g, the next bucket, and the operands and products of two adds, 36 L
//     words) lives in shared memory, so the threads' stack frames stay
//     empty. The g add of step j needs m_j and g_(j-1); the m add of step
//     j + 1 needs only m_j: so both run at once, kG threads each, and the
//     lane is Bt + 1 steps deep, not 2 Bt. A complete add has two levels
//     of six independent multiplies (x1 x2, y1 y2, z1 z2 and three
//     products of sums; then t3 t1, t4 yz, t1 z3, yz t0, z3 t4, t0 t3);
//     each of the kG threads takes every kG-th product of a level and
//     every kG-th limb of the adds between the levels, with a warp
//     barrier after each phase (the pattern of prefix_scan.cu). The next
//     bucket's words come in by cp.async while the step computes.
//     Neighbouring lanes read buckets Bt apart: not coalesced, and a
//     small part of a step. A 2-byte element is fetched as the 4-byte
//     word that holds it (the wrapper checks the alignment; 3 L Wp B is
//     even, so the last word lies inside the tensor).
//  2. The two scans and the tail, ONE cooperative launch (the pattern of
//     col_prefix.cu): each level is a set of independent adds spread over
//     the whole grid, kG threads an add with its state in shared memory,
//     and a grid-wide barrier after each level. Points pass between
//     levels as int16 (exact, see store_pt) through two exchange arrays
//     in device memory, read past the L1 (__ldcg). The levels come from
//     the wrapper as a table in device memory, (shift k, m lane stride,
//     g lane stride) a level, phase A then phase B (`pbpr_scan_levels` in
//     cuzk/kernels.py, the one place that decides them): a level computes
//     the lanes of each half that are multiples of its stride, only the
//     sums that a later step reads. The mask is applied where phase B's
//     first level (or, with T = 1 and no level, the tail) reads. The
//     tail runs after the last barrier, one add-chain per window: the
//     doublings in three levels of multiplies, then the add.
// The wrapper sizes both grids (cuzk/kernels.py `pbpr_full_geometry`):
// stage 1 as many blocks as the lanes take; the scans never more blocks
// than msm_pbpr_full_limits reports resident with this kernel's shared
// memory, each chain striding over several adds where a level has more.
// A launch the device refuses returns its cudaError_t and the wrapper
// raises: there is no second path.
// Layouts: buckets (3, L, Wp, B) int16; out (3, L, Wp) int32; exchange
// (2 arrays, 3, L, 2 Wp T) int16, point (h Wp + w) T + t for half h
// (0: m, 1: g), window w, lane t.
#include <cooperative_groups.h>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;   // threads a block of the scan kernel
constexpr int kWarps = kThreads / 32;
constexpr int kStage1Threads = 32;   // threads a block of stage 1
constexpr int kG = 2;           // threads of one warp per complete add

__device__ __forceinline__ void cp_async(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The words of one add that kG threads share: the six products of a
// level (P) and the six operands of level 2 (T). Offsets in int32 words.
template <int L>
struct AddMem {
  static constexpr int P = 0, T = 6 * L, WORDS = 12 * L;
};

// Field::padd and Field::pdbl in phases, on points and scratch in shared
// memory. Thread g (0 .. kG-1) of the add takes products g, g + kG, ...
// and limbs g, g + kG, ...; the caller puts a warp barrier between
// phases. Each product is a single call site, so the threads of a warp
// stay converged in Field::mul.
template <int L, int W>
struct Shared {
  using F = msm::Field<L, W>;
  using A = AddMem<L>;

  // Level 1 of padd(p1, p2): x1 x2, y1 y2, z1 z2, (x1 + y1)(x2 + y2),
  // (y1 + z1)(y2 + z2), (x1 + z1)(x2 + z2) into P. The thread of a
  // product of sums writes the two sums itself, where the product goes
  // and where level 2's operand of the same index goes; no other product
  // of the level reads either. p2 may lie in T[0, 3 L).
  static __device__ __forceinline__ void padd_level1(const int32_t* p1,
                                                     const int32_t* p2,
                                                     int32_t* s, int g,
                                                     const msm::Consts<L>& K) {
    for (int j = g; j < 6; j += kG) {
      int32_t* o = s + A::P + j * L;
      const int32_t* a = p1 + j * L;
      const int32_t* b = p2 + j * L;
      if (j >= 3) {
        const int u = j == 4 ? L : 0;          // x + y, y + z, x + z
        const int v = j == 3 ? L : 2 * L;
        int32_t* t = s + A::T + j * L;
        for (int i = 0; i < L; i++) {
          o[i] = p1[u + i] + p1[v + i];
          t[i] = p2[u + i] + p2[v + i];
        }
        a = o;
        b = t;
      }
      F::mul(a, b, o, K);
    }
  }

  // The adds between the levels: T = t3 t4 t1 yz z3 t0 from the products.
  static __device__ __forceinline__ void padd_mid(int32_t* s, int g,
                                                  const msm::Consts<L>& K) {
    for (int i = g; i < L; i += kG) {
      const int32_t* P = s + A::P + i;
      int32_t* T = s + A::T + i;
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

  // Level 2: t3 t1, t4 yz, t1 z3, yz t0, z3 t4, t0 t3 into P.
  static __device__ __forceinline__ void padd_level2(int32_t* s, int g,
                                                     const msm::Consts<L>& K) {
    for (int j = g; j < 6; j += kG) {
      const int b = j < 4 ? j + 2 : 5 - j;   // T index of the second operand
      F::mul(s + A::T + j * L, s + A::T + b * L, s + A::P + j * L, K);
    }
  }

  // The sum: element (c L + i) of the result at out[(c L + i) * stride].
  template <typename T>
  static __device__ __forceinline__ void padd_finish(const int32_t* s, int g,
                                                     T* out, int64_t stride,
                                                     const msm::Consts<L>& K) {
    for (int i = g; i < L; i += kG) {
      const int32_t* P = s + A::P + i;
      out[(int64_t)i * stride] = static_cast<T>(P[0] - P[L] + K.kp2[i]);
      out[(int64_t)(L + i) * stride] = static_cast<T>(P[2 * L] + P[3 * L]);
      out[(int64_t)(2 * L + i) * stride] = static_cast<T>(P[4 * L] + P[5 * L]);
    }
  }

  // pdbl(p) in three levels: P0..P3 = y y, y z, z z, x y; P4 = (z z) b3m;
  // T0..T2 = 8 (y y), y y - 3 P4 + 6p, y y + P4; then T3 = P4 T0,
  // T4 = P1 T0, T5 = T1 T2, P5 = T1 P3; the result (2 P5, T3 + T5, T4).
  static __device__ __forceinline__ void pdbl_level1(const int32_t* p,
                                                     int32_t* s, int g,
                                                     const msm::Consts<L>& K) {
    for (int j = g; j < 4; j += kG) {
      const int32_t* a = p + (j == 3 ? 0 : j == 2 ? 2 * L : L);
      const int32_t* b = p + (j == 0 || j == 3 ? L : 2 * L);
      F::mul(a, b, s + A::P + j * L, K);
    }
  }

  static __device__ __forceinline__ void pdbl_level2(int32_t* s, int g,
                                                     const msm::Consts<L>& K) {
    if (g == 0) F::mul(s + A::P + 2 * L, K.b3m, s + A::P + 4 * L, K);
  }

  static __device__ __forceinline__ void pdbl_mid(int32_t* s, int g,
                                                  const msm::Consts<L>& K) {
    for (int i = g; i < L; i += kG) {
      const int32_t a = s[A::P + i], e = s[A::P + 4 * L + i];
      int32_t* T = s + A::T + i;
      T[0] = a * 8;
      T[L] = a - e * 3 + K.kp6[i];
      T[2 * L] = a + e;
    }
  }

  static __device__ __forceinline__ void pdbl_level3(int32_t* s, int g,
                                                     const msm::Consts<L>& K) {
    int32_t* P = s + A::P;
    int32_t* T = s + A::T;
    for (int j = g; j < 4; j += kG) {
      const int32_t* a = j == 0 ? P + 4 * L : j == 1 ? P + L : T + L;
      const int32_t* b = j < 2 ? T : j == 2 ? T + 2 * L : P + 3 * L;
      int32_t* o = j == 3 ? P + 5 * L : T + (3 + j) * L;
      F::mul(a, b, o, K);
    }
  }

  static __device__ __forceinline__ void pdbl_finish(const int32_t* s, int g,
                                                     int32_t* out) {
    for (int i = g; i < L; i += kG) {
      const int32_t* P = s + A::P + i;
      const int32_t* T = s + A::T + i;
      out[i] = P[5 * L] * 2;
      out[L + i] = T[3 * L] + T[5 * L];
      out[2 * L + i] = T[4 * L];
    }
  }
};

template <int L>
__device__ __forceinline__ void set_inf(int32_t* p, int g,
                                        const msm::Consts<L>& K, int step) {
  for (int i = g; i < L; i += step) {
    p[i] = 0;
    p[L + i] = K.one[i];
    p[2 * L + i] = 0;
  }
}

// ---------------------------------------------------------------------------
// 1. stage 1
// ---------------------------------------------------------------------------

// A lane's words: m, g, the double buffer of raw bucket words, and the
// scratch of the m add and of the g add (the m add's p2, the bucket,
// sits in the first 3 L words of its T).
template <int L>
struct LaneMem {
  static constexpr int M = 0, G = 3 * L, BK = 6 * L;
  static constexpr int SM = 12 * L, SG = SM + AddMem<L>::WORDS;
  static constexpr int WORDS = SG + AddMem<L>::WORDS;
  static constexpr int STRIDE = WORDS | 1;   // odd: lanes on distinct banks
};

constexpr int kLaneThreads = 2 * kG;
constexpr int kLanesPerWarp = 32 / kLaneThreads;

template <int L>
constexpr size_t stage1_smem_bytes() {
  return (size_t)(kStage1Threads / 32) * kLanesPerWarp * LaneMem<L>::STRIDE *
         sizeof(int32_t);
}

template <int L, int W>
__global__ void __launch_bounds__(kStage1Threads)
stage1_kernel(const int16_t* __restrict__ buckets, int16_t* __restrict__ xout,
              int Wp, int B, int T, const int32_t* __restrict__ kc) {
  constexpr int Q = kLaneThreads;
  constexpr int LPW = kLanesPerWarp;
  using LM = LaneMem<L>;
  using S = Shared<L, W>;
  __shared__ msm::Consts<L> K;
  extern __shared__ int32_t dyn[];
  msm::load_consts<L>(K, kc);
  const int warp = threadIdx.x >> 5;
  const int lw = (threadIdx.x & 31) / Q;
  const int q = (threadIdx.x & 31) % Q;
  const int chain = q / kG;          // 0: the m add, 1: the g add
  const int g = q % kG;
  const int64_t lanes = (int64_t)Wp * T;
  const int64_t f =
      ((int64_t)blockIdx.x * (kStage1Threads / 32) + warp) * LPW + lw;
  const bool active = f < lanes;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (!active) return;
  int32_t* lm = dyn + (warp * LPW + lw) * LM::STRIDE;
  const int w = static_cast<int>(f / T), t = static_cast<int>(f % T);
  const int Bt = B / T;
  const int64_t plane = (int64_t)Wp * B;
  const int64_t top = (int64_t)w * B + (int64_t)t * Bt + Bt - 1;
  const int32_t* words = reinterpret_cast<const int32_t*>(buckets);
  set_inf<L>(lm + LM::M, q, K, Q);
  set_inf<L>(lm + LM::G, q, K, Q);
  // element k of bucket top - j is buckets[k * plane + top - j]; this
  // thread copies and unpacks k = q, q + Q, ...
  for (int k = q; k < 3 * L; k += Q)
    cp_async(lm + LM::BK + k, words + (((int64_t)k * plane + top) >> 1));

  int32_t* sc = lm + (chain == 0 ? LM::SM : LM::SG);
  int32_t* acc = lm + (chain == 0 ? LM::M : LM::G);
  const int32_t* p2 = chain == 0 ? sc + AddMem<L>::T : lm + LM::M;
  for (int j = 0; j <= Bt; j++) {
    if (j < Bt) {
      cp_async_wait();
      const int32_t* buf = lm + LM::BK + (j & 1) * 3 * L;
      int32_t* bk = lm + LM::SM + AddMem<L>::T;
      for (int k = q; k < 3 * L; k += Q) {
        const int32_t v = buf[k];
        bk[k] = (((int64_t)k * plane + top - j) & 1)
                    ? static_cast<int16_t>(v >> 16)
                    : static_cast<int16_t>(v);
      }
      if (j + 1 < Bt) {
        int32_t* nxt = lm + LM::BK + ((j + 1) & 1) * 3 * L;
        for (int k = q; k < 3 * L; k += Q)
          cp_async(nxt + k, words + (((int64_t)k * plane + top - j - 1) >> 1));
      }
    }
    __syncwarp(mask);
    // the m add of step j (m_j = m_(j-1) + bucket) and the g add of step
    // j - 1 (g_(j-1) = g_(j-2) + m_(j-1)) read m before either writes
    const bool on = chain == 0 ? j < Bt : j > 0;
    if (on) S::padd_level1(acc, p2, sc, g, K);
    __syncwarp(mask);
    if (on) S::padd_mid(sc, g, K);
    __syncwarp(mask);
    if (on) S::padd_level2(sc, g, K);
    __syncwarp(mask);
    if (on) S::padd_finish(sc, g, acc, 1, K);
  }
  __syncwarp(mask);
  // m to half 0, g to half 1 of the first exchange array
  const int64_t P = 2 * lanes;
  for (int k = q; k < 3 * L; k += Q) {
    xout[(int64_t)k * P + f] = static_cast<int16_t>(lm[LM::M + k]);
    xout[(int64_t)k * P + lanes + f] = static_cast<int16_t>(lm[LM::G + k]);
  }
}

// ---------------------------------------------------------------------------
// 2. the lane scans and the tail
// ---------------------------------------------------------------------------

// An add's words: its first point and its scratch (the second point sits
// in the first 3 L words of the scratch's T).
template <int L>
struct ItemMem {
  static constexpr int P1 = 0, S = 3 * L;
  static constexpr int WORDS = S + AddMem<L>::WORDS;
  static constexpr int STRIDE = WORDS | 1;
};

constexpr int kItemsPerWarp = 32 / kG;
constexpr int kItemsPerBlock = kWarps * kItemsPerWarp;

template <int L>
constexpr size_t scan_smem_bytes() {
  return (size_t)kItemsPerBlock * ItemMem<L>::STRIDE * sizeof(int32_t);
}

// Point f of the exchange array src (one (coordinate, limb) plane of
// `plane` points) into shared p, or infinity: limbs g, g + kG, ...
template <int L>
__device__ __forceinline__ void load_point(const int16_t* src, int64_t plane,
                                           int64_t f, bool inf, int32_t* p,
                                           int g, const msm::Consts<L>& K) {
  if (inf) {
    set_inf<L>(p, g, K, kG);
    return;
  }
  for (int i = g; i < L; i += kG) {
    p[i] = __ldcg(src + (int64_t)i * plane + f);
    p[L + i] = __ldcg(src + (int64_t)(L + i) * plane + f);
    p[2 * L + i] = __ldcg(src + (int64_t)(2 * L + i) * plane + f);
  }
}

// Add `it` of a scan level of shift k: the m half's adds first, lanes 0,
// sm, 2 sm, ... window by window, then the g half's with stride sg. The
// level reads exchange array `odd` and writes the other; `masked` on
// phase B's first level. The add and the kernel's loop are apart (out of
// line) so that the loop's state is not live across the multiplies: in
// one function it spilled to the stack.
template <int L, int W>
__device__ __noinline__ void scan_add(int16_t* xchg, int Wp, int T, int odd,
                                      int k, int sm, int sg, bool masked,
                                      int it, int32_t* p1, int g,
                                      unsigned mask, const msm::Consts<L>& K) {
  using S = Shared<L, W>;
  int32_t* sc = p1 + ItemMem<L>::S;
  int32_t* p2 = sc + AddMem<L>::T;
  const int nm = Wp * (T / sm);
  const int h = it >= nm;
  const int stride = h ? sg : sm;
  const int r = h ? it - nm : it;
  const int per = T / stride;
  const int t = r % per * stride;
  const int64_t f = ((int64_t)h * Wp + r / per) * T + t;
  const int64_t plane = 2LL * Wp * T;
  const int16_t* src = xchg + odd * 3 * L * plane;
  int16_t* dst = xchg + (odd ^ 1) * 3 * L * plane;
  load_point<L>(src, plane, f, masked && ((h == 0) == (t == 0)), p1, g, K);
  load_point<L>(src, plane, f + k, t + k >= T || (masked && h == 1), p2, g,
                K);
  __syncwarp(mask);
  S::padd_level1(p1, p2, sc, g, K);
  __syncwarp(mask);
  S::padd_mid(sc, g, K);
  __syncwarp(mask);
  S::padd_level2(sc, g, K);
  __syncwarp(mask);
  S::padd_finish(sc, g, dst + f, plane, K);
  __syncwarp(mask);
}

// The tail of window w: m lane 0 of src doubled log2(B / T) times, plus
// g lane 0, into out. With T = 1 there was no scan level, and the mask
// reads here.
template <int L, int W>
__device__ __noinline__ void tail(const int16_t* src, int32_t* out, int Wp,
                                  int B, int T, int w, int32_t* p1, int g,
                                  unsigned mask, const msm::Consts<L>& K) {
  using S = Shared<L, W>;
  int32_t* sc = p1 + ItemMem<L>::S;
  int32_t* p2 = sc + AddMem<L>::T;
  const int64_t plane = 2LL * Wp * T;
  load_point<L>(src, plane, (int64_t)w * T, T == 1, p1, g, K);
  __syncwarp(mask);
  for (int d = B / T; d > 1; d >>= 1) {
    S::pdbl_level1(p1, sc, g, K);
    __syncwarp(mask);
    S::pdbl_level2(sc, g, K);
    __syncwarp(mask);
    S::pdbl_mid(sc, g, K);
    __syncwarp(mask);
    S::pdbl_level3(sc, g, K);
    __syncwarp(mask);
    S::pdbl_finish(sc, g, p1);
    __syncwarp(mask);
  }
  load_point<L>(src, plane, ((int64_t)Wp + w) * T, false, p2, g, K);
  __syncwarp(mask);
  S::padd_level1(p1, p2, sc, g, K);
  __syncwarp(mask);
  S::padd_mid(sc, g, K);
  __syncwarp(mask);
  S::padd_level2(sc, g, K);
  __syncwarp(mask);
  S::padd_finish(sc, g, out + w, Wp, K);
}

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
scan_kernel(int16_t* xchg, int32_t* out, const int* __restrict__ levels,
            int num_levels, int Wp, int B, int T,
            const int32_t* __restrict__ kc) {
  __shared__ msm::Consts<L> K;
  extern __shared__ int32_t dyn[];
  msm::load_consts<L>(K, kc);
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int iw = (threadIdx.x & 31) / kG;
  const int g = (threadIdx.x & 31) % kG;
  int32_t* p1 = dyn + (warp * kItemsPerWarp + iw) * ItemMem<L>::STRIDE;
  // a warp's chains take adds base + iw, base + pass + iw, ...
  const int first = (blockIdx.x * kWarps + warp) * kItemsPerWarp;
  const int pass = gridDim.x * kItemsPerBlock;
  for (int lv = 0; lv < num_levels; lv++) {
    const int k = __ldg(levels + 3 * lv), sm = __ldg(levels + 3 * lv + 1);
    const int sg = __ldg(levels + 3 * lv + 2);
    const bool masked = 2 * lv == num_levels;   // phase B's first level
    const int items = Wp * (T / sm + T / sg);
    for (int base = first; base < items; base += pass) {
      const int it = base + iw;
      const unsigned mask = __ballot_sync(0xffffffffu, it < items);
      if (it < items)
        scan_add<L, W>(xchg, Wp, T, lv & 1, k, sm, sg, masked, it, p1, g,
                       mask, K);
    }
    grid.sync();
  }
  // after an even number of levels the sums are back in the first array
  for (int base = first; base < Wp; base += pass) {
    const int w = base + iw;
    const unsigned mask = __ballot_sync(0xffffffffu, w < Wp);
    if (w < Wp) tail<L, W>(xchg, out, Wp, B, T, w, p1, g, mask, K);
  }
}

}  // namespace

// The launch limits of the scan kernel on the current device: resident
// blocks an SM with its dynamic shared memory, the SM count, threads a
// block, and threads an add.
extern "C" int msm_pbpr_full_limits(int num_limbs, int limb_bits,
                                    int* blocks_per_sm, int* sms, int* threads,
                                    int* threads_per_add) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *threads = kThreads;
  *threads_per_add = kG;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    constexpr size_t smem = scan_smem_bytes<L>();
    rc = cudaFuncSetAttribute(scan_kernel<L, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, scan_kernel<L, W>, kThreads, smem);
  });
  return static_cast<int>(rc);
}

// levels: the (shift, m stride, g stride) table of the scan levels in
// device memory, 3 num_levels ints, an even number (cuzk/kernels.py
// pbpr_scan_levels).
extern "C" int msm_pbpr_full(int num_limbs, int limb_bits, const int16_t* buckets,
                             int32_t* out, int16_t* xchg, const int* levels,
                             int num_levels, int Wp, int B, int T,
                             int stage1_blocks, int scan_blocks,
                             const int32_t* consts, void* stream) {
  if (num_levels % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaSuccess;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    constexpr size_t smem1 = stage1_smem_bytes<L>();
    constexpr size_t smem2 = scan_smem_bytes<L>();
    rc = cudaFuncSetAttribute(stage1_kernel<L, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem1));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    stage1_kernel<L, W><<<static_cast<unsigned>(stage1_blocks),
                          kStage1Threads, smem1, s>>>(buckets, xchg, Wp, B,
                                                      T, consts);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaFuncSetAttribute(scan_kernel<L, W>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem2));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    void* args[] = {&xchg,  &out, &levels, &num_levels,
                    &Wp,    &B,   &T,      &consts};
    rc = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&scan_kernel<L, W>),
        dim3(static_cast<unsigned>(scan_blocks)), dim3(kThreads), args, smem2,
        s);
  });
  return static_cast<int>(rc);
}
