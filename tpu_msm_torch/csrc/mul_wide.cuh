// Word-wide Montgomery multiply on the S12 signed-lazy limb format: the
// multiply of every kernel in this directory.
//
// What it computes is what ops/rows.py mont_mul_rows computes on W-bit
// limbs: it ripples both operands to canonical limbs (values a, b in
// [0, 2^(L W))), finds the unique M in [0, 2^(L W)) with a b + M p = 0
// mod 2^(L W), and returns (a b + M p) / 2^(L W) mod 2^(L W) as
// canonical limbs. Any exact REDC with the same R = 2^(L W) finds the
// same M, so it returns the same limbs. This one ripples the operands
// as Field::canon does, packs them into N = ceil(L W / 32) 32-bit words
// and runs CIOS (coarsely integrated operand scanning) on the words:
//   for i < N:  t += a * b[i];
//               if i < NF: m = t[0] n0 mod 2^32, t = (t + m p) / 2^32
//   then        m = t[0] n0 mod 2^RB,  t = (t + m p) / 2^RB
// with NF = floor(L W / 32) whole words and RB = L W - 32 NF bits left,
// n0 = -p^-1 mod 2^32. Where L W is a multiple of 32 (RB = 0), NF = N:
// every row reduces a whole word and the last step does not exist. The
// result is unpacked to W-bit limbs; bits at and above L W are dropped,
// as mont_mul_rows's final ripple drops them. So it is mont_mul_rows
// bit for bit for every pair of operands, lazy limbs or not
// (tests/test_torch_mul_wide.py replays these words in Python against
// it, tests/test_torch_mul_chain.py runs the asm blocks below).
// Each row's additions are PTX carry chains (`Chain`), each one asm
// block of mad.lo.cc / madc.hi.cc / madc.lo.cc and addc on two
// accumulators, so a 32 x 32-bit product is one 64-bit multiply-add
// into an aligned register pair with the carry in the flag: no
// instruction apart adds a carry (the 64-bit multiply-adds of C++ that
// this replaces took one or two IADD3 beside each), and no word moves
// between pairs (a form on one accumulator, its even and odd products
// one word apart, took a move for every third instruction; PERF.md has
// the instruction counts).
//
// Words N, NF, RB: BN254_S12 (L W = 264) 9, 8, 8; BN254_S13 (273) 9, 8,
// 17; BLS12_377_S12 (384) 12, 12, 0; BLS12_377_S13 (390) 13, 12, 6;
// TINY62 (72) 3, 2, 8.
// Each 32 x 32-bit product is a .lo and a .hi half: 2 N^2 halves for
// a b, and (NF + [RB > 0])(1 + 2 NP) for the m digits and m p, with NP =
// NF words of p. That is 315 int32 multiply and multiply-add
// instructions at L = 22 and 588 at BLS12_377_S12 (chip_smoke.py
// `mul_wide_mads`) against the 12-bit limbs' 1,012 and 2,112
// multiply-adds.
// Needs p < 2^(32 NF): the wrapper checks the curve (cuzk/kernels.py
// `_wide_consts_host`). Then t < a + p after each reduction. With RB >
// 0, a < 2^(L W) <= 2^(32 N - 1) and t fits N + 1 words throughout.
// With RB = 0 a may reach 2^(32 N): t < 2^(32 N + 1) between rows, up to
// 2^(32 N + 33) within one, so t keeps a word more.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "field.cuh"

namespace msm {

template <int L, int W>
struct Wide {
  static constexpr int BITS = L * W;
  static constexpr int N = (BITS + 31) / 32;   // words of an operand
  static constexpr int NF = BITS / 32;         // whole words reduced
  static constexpr int RB = BITS - 32 * NF;    // bits reduced at the end
  static constexpr int NP = NF;                // words of p
};

// The kernel parameter struct: passed by value, so it sits in the
// constant bank. Laid out as cuzk/kernels.py `_wide_consts_host` builds
// it: the words of p, n0 = -p^-1 mod 2^32, the words of R^2 mod p.
template <int L, int W>
struct WideConsts {
  uint32_t p[Wide<L, W>::NP];
  uint32_t n0;
  uint32_t r2[Wide<L, W>::N];
};

// The carry chains of the CIOS rows, each one asm block: the carry flag
// lives only within a block. t is kept as two accumulators of 32-bit
// words, t = E + 2^32 O, so that every product x y is a 64-bit
// multiply-add into an aligned pair of words (2 k, 2 k + 1) of one of
// them, which ptxas fuses into one IMAD.WIDE.X on a register pair:
//   t += x y for a row  ->  E += (x's even words) y, O += (x's odd words) y
// (x = a and y = b[i] for a product row, x = p and y = m for a
// reduction row). After a reduction E[0] is zero, and the division by
// 2^32 is a renaming that keeps every pair aligned:
//   t / 2^32 = (O + E[1]) + 2^32 (E >> 64),  so  E' = O, O' = E >> 64,
// and E[1] is added to E'[0] at the head of the next row's O chain
// (A = 1), whose first carry (weight 2^32, O's lowest) it becomes. One
// merge chain at the end gives t = E + 2^32 O. A chain of K pairs adds
// x[k] y at words 2 k, 2 k + 1 of its accumulator U, then carries on
// through R more words. Its operands, as MSM_MW_OUT and MSM_MW_IN list
// them: %0 .. %13 the words of U (kChainT, the most any profile needs),
// %14 the word e0 (E'[0], for A = 1), %15 .. %21 the multiplicand words
// x (kChainX), %22 the multiplier y, %23 the word xw added to e0. Every
// chain's last carry is zero: t < a + p before each row, and each
// accumulator is sized for that bound (tests/test_torch_mul_chain.py
// runs these blocks on a carry flag, their operands bound as these lists
// bind them, and checks it).
constexpr int kChainT = 14;
constexpr int kChainX = 7;

template <int K, int R, int A>
struct Chain;

template <int N, int Z>
struct Merge;

#define MSM_MW_P0 "mad.lo.cc.u32 %0, %15, %22, %0;\n\t" \
                  "madc.hi.cc.u32 %1, %15, %22, %1;\n\t"
#define MSM_MW_Q0 "madc.lo.cc.u32 %0, %15, %22, %0;\n\t" \
                  "madc.hi.cc.u32 %1, %15, %22, %1;\n\t"
#define MSM_MW_P1 "madc.lo.cc.u32 %2, %16, %22, %2;\n\t" \
                  "madc.hi.cc.u32 %3, %16, %22, %3;\n\t"
#define MSM_MW_P2 "madc.lo.cc.u32 %4, %17, %22, %4;\n\t" \
                  "madc.hi.cc.u32 %5, %17, %22, %5;\n\t"
#define MSM_MW_P3 "madc.lo.cc.u32 %6, %18, %22, %6;\n\t" \
                  "madc.hi.cc.u32 %7, %18, %22, %7;\n\t"
#define MSM_MW_P4 "madc.lo.cc.u32 %8, %19, %22, %8;\n\t" \
                  "madc.hi.cc.u32 %9, %19, %22, %9;\n\t"
#define MSM_MW_P5 "madc.lo.cc.u32 %10, %20, %22, %10;\n\t" \
                  "madc.hi.cc.u32 %11, %20, %22, %11;\n\t"
#define MSM_MW_P6 "madc.lo.cc.u32 %12, %21, %22, %12;\n\t" \
                  "madc.hi.cc.u32 %13, %21, %22, %13;\n\t"
#define MSM_MW_C(n) "addc.cc.u32 %" #n ", %" #n ", 0;\n\t"
#define MSM_MW_A "add.cc.u32 %14, %14, %23;\n\t"

#define MSM_MW_OUT                                                           \
  "+r"(U[0]), "+r"(U[1]), "+r"(U[2]), "+r"(U[3]), "+r"(U[4]), "+r"(U[5]),    \
      "+r"(U[6]), "+r"(U[7]), "+r"(U[8]), "+r"(U[9]), "+r"(U[10]),           \
      "+r"(U[11]), "+r"(U[12]), "+r"(U[13]), "+r"(e0)
#define MSM_MW_IN                                                            \
  "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),          \
      "r"(x[6]), "r"(y), "r"(xw)

#define MSM_MW_CHAIN(K, R, A, TEXT)                                          \
  template <>                                                                \
  struct Chain<K, R, A> {                                                    \
    static __device__ __forceinline__ void run(uint32_t (&U)[kChainT],       \
                                               const uint32_t (&x)[kChainX], \
                                               uint32_t y, uint32_t& e0,     \
                                               uint32_t xw) {                \
      asm volatile(TEXT : MSM_MW_OUT : MSM_MW_IN);                           \
    }                                                                        \
  };
// E += 2^32 O (Z = 0), or E += 2^32 O + xw (Z = 1), through word N of E;
// operands %0 .. %13 E, %14 .. %26 O, %27 xw.
#define MSM_MW_MERGE(N, Z, TEXT)                                             \
  template <>                                                                \
  struct Merge<N, Z> {                                                       \
    static __device__ __forceinline__ void run(uint32_t (&U)[kChainT],       \
                                               const uint32_t (&O)[kChainT], \
                                               uint32_t xw) {                \
      asm volatile(TEXT                                                      \
                   : "+r"(U[0]), "+r"(U[1]), "+r"(U[2]), "+r"(U[3]),         \
                     "+r"(U[4]), "+r"(U[5]), "+r"(U[6]), "+r"(U[7]),         \
                     "+r"(U[8]), "+r"(U[9]), "+r"(U[10]), "+r"(U[11]),       \
                     "+r"(U[12]), "+r"(U[13])                                \
                   : "r"(O[0]), "r"(O[1]), "r"(O[2]), "r"(O[3]), "r"(O[4]),  \
                     "r"(O[5]), "r"(O[6]), "r"(O[7]), "r"(O[8]), "r"(O[9]),  \
                     "r"(O[10]), "r"(O[11]), "r"(O[12]), "r"(xw));           \
    }                                                                        \
  };

// The chains the profiles take, (N, NP): a product row (N + 1) / 2 pairs
// into E and N / 2 into O (the latter with the shift's add), a reduction
// row NP / 2 into each.
// TINY62 (3, 2)
MSM_MW_CHAIN(2, 0, 0, MSM_MW_P0 MSM_MW_P1)
MSM_MW_CHAIN(1, 1, 1, MSM_MW_A MSM_MW_Q0 MSM_MW_C(2))
MSM_MW_CHAIN(1, 2, 0, MSM_MW_P0 MSM_MW_C(2) MSM_MW_C(3))
MSM_MW_CHAIN(1, 1, 0, MSM_MW_P0 MSM_MW_C(2))
MSM_MW_MERGE(3, 0, "add.cc.u32 %1, %1, %14;\n\t"
                   "addc.cc.u32 %2, %2, %15;\n\t"
                   "addc.cc.u32 %3, %3, %16;\n\t")
// BN254_S12 and BN254_S13 (9, 8)
MSM_MW_CHAIN(5, 0, 0, MSM_MW_P0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3 MSM_MW_P4)
MSM_MW_CHAIN(4, 1, 1, MSM_MW_A MSM_MW_Q0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3
             MSM_MW_C(8))
MSM_MW_CHAIN(4, 2, 0, MSM_MW_P0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3 MSM_MW_C(8)
             MSM_MW_C(9))
MSM_MW_CHAIN(4, 1, 0, MSM_MW_P0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3 MSM_MW_C(8))
MSM_MW_MERGE(9, 0, "add.cc.u32 %1, %1, %14;\n\t"
                   "addc.cc.u32 %2, %2, %15;\n\t"
                   "addc.cc.u32 %3, %3, %16;\n\t"
                   "addc.cc.u32 %4, %4, %17;\n\t"
                   "addc.cc.u32 %5, %5, %18;\n\t"
                   "addc.cc.u32 %6, %6, %19;\n\t"
                   "addc.cc.u32 %7, %7, %20;\n\t"
                   "addc.cc.u32 %8, %8, %21;\n\t"
                   "addc.cc.u32 %9, %9, %22;\n\t")
// BLS12_377_S13 (13, 12) and BLS12_377_S12 (12, 12)
MSM_MW_CHAIN(7, 0, 0, MSM_MW_P0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3 MSM_MW_P4
             MSM_MW_P5 MSM_MW_P6)
MSM_MW_CHAIN(6, 1, 1, MSM_MW_A MSM_MW_Q0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3
             MSM_MW_P4 MSM_MW_P5 MSM_MW_C(12))
MSM_MW_CHAIN(6, 2, 0, MSM_MW_P0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3 MSM_MW_P4
             MSM_MW_P5 MSM_MW_C(12) MSM_MW_C(13))
MSM_MW_CHAIN(6, 1, 0, MSM_MW_P0 MSM_MW_P1 MSM_MW_P2 MSM_MW_P3 MSM_MW_P4
             MSM_MW_P5 MSM_MW_C(12))
MSM_MW_MERGE(13, 0, "add.cc.u32 %1, %1, %14;\n\t"
                    "addc.cc.u32 %2, %2, %15;\n\t"
                    "addc.cc.u32 %3, %3, %16;\n\t"
                    "addc.cc.u32 %4, %4, %17;\n\t"
                    "addc.cc.u32 %5, %5, %18;\n\t"
                    "addc.cc.u32 %6, %6, %19;\n\t"
                    "addc.cc.u32 %7, %7, %20;\n\t"
                    "addc.cc.u32 %8, %8, %21;\n\t"
                    "addc.cc.u32 %9, %9, %22;\n\t"
                    "addc.cc.u32 %10, %10, %23;\n\t"
                    "addc.cc.u32 %11, %11, %24;\n\t"
                    "addc.cc.u32 %12, %12, %25;\n\t"
                    "addc.cc.u32 %13, %13, %26;\n\t")
MSM_MW_MERGE(12, 1, "add.cc.u32 %0, %0, %27;\n\t"
                    "addc.cc.u32 %1, %1, %14;\n\t"
                    "addc.cc.u32 %2, %2, %15;\n\t"
                    "addc.cc.u32 %3, %3, %16;\n\t"
                    "addc.cc.u32 %4, %4, %17;\n\t"
                    "addc.cc.u32 %5, %5, %18;\n\t"
                    "addc.cc.u32 %6, %6, %19;\n\t"
                    "addc.cc.u32 %7, %7, %20;\n\t"
                    "addc.cc.u32 %8, %8, %21;\n\t"
                    "addc.cc.u32 %9, %9, %22;\n\t"
                    "addc.cc.u32 %10, %10, %23;\n\t"
                    "addc.cc.u32 %11, %11, %24;\n\t"
                    "addc.cc.u32 %12, %12, %25;\n\t")

template <int L, int W>
struct MulWide {
  using D = Wide<L, W>;
  static constexpr int N = D::N, NF = D::NF, NP = D::NP, RB = D::RB;

  // Field::canon's ripple, then limb i at bit W i of the words.
  static __device__ __forceinline__ void pack(const int32_t* a,
                                              uint32_t (&w)[N]) {
    int32_t c[L];
    Field<L, W>::canon(a, c);
#pragma unroll
    for (int k = 0; k < N; k++) w[k] = 0;
#pragma unroll
    for (int i = 0; i < L; i++) {
      const int bit = W * i, k = bit >> 5, off = bit & 31;
      const uint32_t limb = static_cast<uint32_t>(c[i]);
      w[k] |= limb << off;
      if (off + W > 32) w[k + 1] |= limb >> (32 - off);
    }
  }

  // pack()'s words of b one at a time, in order (`next(i)` for i = 0, 1,
  // ...): word i from the canonical limbs (Field::canon's ripple) that
  // start in it and the high bits of the one that straddles into it, so
  // that no more than that limb is kept from one word to the next. The
  // multiply takes b this way, a word a row, to keep b's N words out of
  // the registers that the row holds.
  struct Stream {
    const int32_t* b;
    int32_t carry;
    uint32_t high;
    __device__ __forceinline__ uint32_t next(int i) {
      uint32_t w = high;
      high = 0;
#pragma unroll
      for (int j = 0; j < L; j++) {
        const int bit = W * j, off = bit & 31;
        if ((bit >> 5) != i) continue;
        const int32_t s = b[j] + carry;
        const uint32_t limb = static_cast<uint32_t>(s & Field<L, W>::MASK);
        carry = s >> W;
        w |= limb << off;
        if (off + W > 32) high = limb >> (32 - off);
      }
      return w;
    }
  };

  // Limb i from bits W i .. W i + W - 1; bits at and above L W are left.
  static __device__ __forceinline__ void unpack(const uint32_t (&w)[N],
                                                int32_t* out) {
#pragma unroll
    for (int i = 0; i < L; i++) {
      const int bit = W * i, k = bit >> 5, off = bit & 31;
      uint32_t v = w[k] >> off;
      if (off + W > 32) v |= w[k + 1] << (32 - off);
      out[i] = static_cast<int32_t>(v & ((1u << W) - 1));
    }
  }

  // r = (a b + M p) / 2^(L W), its low N words: the REDC above on
  // t = E + 2^32 O (Chain and Merge above).
  // b's words come from b.next(i), one a row, in order.
  template <typename B>
  static __device__ __forceinline__ void mont(const uint32_t (&a)[N], B& b,
                                              uint32_t (&r)[N],
                                              const WideConsts<L, W>& K) {
    static_assert(NP % 2 == 0 && (RB > 0 ? N + 1 : N + 2) <= kChainT &&
                      (N + 1) / 2 <= kChainX,
                  "the chains take an even NP and at most 14 words of E");
    static_assert(RB > 0 ? N % 2 == 1 : N % 2 == 0,
                  "a product row's even pairs end at E's top word");
    // the even and the odd words of a and of p, the chains' multiplicands
    uint32_t E[kChainT] = {}, O[kChainT] = {};
    uint32_t ae[kChainX] = {}, ao[kChainX] = {};
    uint32_t pe[kChainX] = {}, po[kChainX] = {};
#pragma unroll
    for (int j = 0; j < N; j++) {
      if (j & 1) ao[j >> 1] = a[j];
      else ae[j >> 1] = a[j];
    }
#pragma unroll
    for (int j = 0; j < NP; j++) {
      if (j & 1) po[j >> 1] = K.p[j];
      else pe[j >> 1] = K.p[j];
    }
    uint32_t x = 0;   // the word the last division left to add to E[0]
    uint32_t none = 0;   // e0 of the chains that take none (A = 0)
#pragma unroll
    for (int i = 0; i < N; i++) {
      // t += a b[i]; with RB > 0 E has N + 1 words and O N, with RB = 0
      // one more each
      const uint32_t bi = b.next(i);
      Chain<N / 2, 1, 1>::run(O, ao, bi, E[0], x);
      Chain<(N + 1) / 2, (RB > 0 ? 0 : 2), 0>::run(E, ae, bi, none, 0);
      if (i < NF) {
        // t = (t + m p) / 2^32: E[0] cancels, then E' = O, O' = E >> 64,
        // and E[1] waits in x
        const uint32_t m = E[0] * K.n0;
        Chain<NP / 2, 2, 0>::run(E, pe, m, none, 0);
        Chain<NP / 2, 1, 0>::run(O, po, m, none, 0);
        x = E[1];
#pragma unroll
        for (int k = 0; k < kChainT; k++) {
          const uint32_t e = k + 2 < kChainT ? E[k + 2] : 0;
          E[k] = O[k];
          O[k] = e;
        }
      }
    }
    if constexpr (RB > 0) {
      // the last RB bits: t = (t + m p) / 2^RB
      const uint32_t m = (E[0] * K.n0) & ((1u << RB) - 1);
      Chain<NP / 2, 2, 0>::run(E, pe, m, none, 0);
      Chain<NP / 2, 1, 0>::run(O, po, m, none, 0);
      Merge<N, 0>::run(E, O, 0);
#pragma unroll
      for (int k = 0; k < N; k++)
        r[k] = (E[k] >> RB) | (E[k + 1] << (32 - RB));
    } else {
      // every word reduced: E[N], the bits at and above L W, is dropped
      Merge<N, 1>::run(E, O, x);
#pragma unroll
      for (int k = 0; k < N; k++) r[k] = E[k];
    }
  }
};

// The multiply out of line, for kernels that call it from more than one
// place: L int32 limbs in and out and the word constants, all in shared
// memory, by their 32-bit shared addresses (a caller keeps no 64-bit
// pointer live for it). One copy of the code a kernel (cicc failed on
// many inlined multiplies), and the threads of a warp that reach it
// together stay converged. out may alias a or b: both are read before
// out is written.
template <int L, int W>
__device__ __noinline__ void mul_wide_shared(uint32_t a, uint32_t b,
                                             uint32_t out, uint32_t k) {
  using M = MulWide<L, W>;
  const auto at = [](uint32_t s) {
    return static_cast<int32_t*>(__cvta_shared_to_generic(s));
  };
  // the words in registers, read once
  const WideConsts<L, W> Kr =
      *reinterpret_cast<const WideConsts<L, W>*>(at(k));
  uint32_t aw[M::N], rw[M::N];
  M::pack(at(a), aw);
  typename M::Stream bs{at(b), 0, 0};
  M::mont(aw, bs, rw, Kr);
  M::unpack(rw, at(out));
}

// mul_wide_shared on pointers into shared memory.
template <int L, int W>
__device__ __forceinline__ void mul_wide(const int32_t* a, const int32_t* b,
                                         int32_t* out,
                                         const WideConsts<L, W>& K) {
  const auto s = [](const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
  };
  mul_wide_shared<L, W>(s(a), s(b), s(out), s(&K));
}

}  // namespace msm
