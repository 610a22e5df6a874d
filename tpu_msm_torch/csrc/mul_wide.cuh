// Word-wide Montgomery multiply on the S12 signed-lazy limb format.
//
// The multiply of encode_mont.cu and padd_batch.cu. Field::mul
// (field.cuh) works on W-bit limbs: it ripples both operands to
// canonical limbs (values a, b in [0, 2^(L W))), builds one W-bit digit
// at a time the unique M in [0, 2^(L W)) with a b + M p = 0 mod
// 2^(L W), and returns (a b + M p) / 2^(L W) mod 2^(L W) as canonical
// limbs. Any exact REDC with the same R = 2^(L W) finds the same M, so
// it returns the same limbs. This one ripples the operands as
// Field::canon does, packs them into N = ceil(L W / 32) 32-bit words and
// runs CIOS (coarsely integrated operand scanning) on the words:
//   for i < N:  t += a * b[i];
//               if i < NF: m = t[0] n0 mod 2^32, t = (t + m p) / 2^32
//   then        m = t[0] n0 mod 2^RB,  t = (t + m p) / 2^RB
// with NF = floor(L W / 32) whole words and RB = L W - 32 NF bits left,
// n0 = -p^-1 mod 2^32. Where L W is a multiple of 32 (RB = 0), NF = N:
// every row reduces a whole word and the last step does not exist. The
// result is unpacked to W-bit limbs; bits at and above L W are dropped,
// as the old final ripple drops them. So it is Field::mul bit for bit
// for every pair of operands, lazy limbs or not
// (tests/test_torch_mul_wide.py replays these words in Python against
// ops/rows.py mont_mul_rows).
//
// Words N, NF, RB: BN254_S12 (L W = 264) 9, 8, 8; BN254_S13 (273) 9, 8,
// 17; BLS12_377_S12 (384) 12, 12, 0; BLS12_377_S13 (390) 13, 12, 6;
// TINY62 (72) 3, 2, 8.
// Each 32 x 32-bit product is one 64-bit multiply-add, a .lo and a .hi
// half: 2 N^2 halves for a b, and (NF + [RB > 0])(1 + 2 NP) for the m
// digits and m p, with NP = NF words of p. That is 315 int32 multiply
// and multiply-add instructions at L = 22 and 588 at BLS12_377_S12
// (chip_smoke.py `mul_wide_mads`) against Field::mul's 1,012 and 2,112
// multiply-adds.
// Needs p < 2^(32 NF): the wrapper checks the curve (cuzk/kernels.py
// `_wide_consts_host`). Then t < a + p after each reduction. With RB >
// 0, a < 2^(L W) <= 2^(32 N - 1) and t fits N + 1 words throughout.
// With RB = 0 a may reach 2^(32 N): t < 2^(32 N + 1) between rows, up to
// 2^(32 N + 33) within one, so t keeps a word more (TOP = N + 1).
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
  static constexpr int TOP = RB > 0 ? N : N + 1;   // top word of t
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

  // r = (a b + M p) / 2^(L W), its low N words: the REDC above.
  static __device__ __forceinline__ void mont(const uint32_t (&a)[N],
                                              const uint32_t (&b)[N],
                                              uint32_t (&r)[N],
                                              const WideConsts<L, W>& K) {
    constexpr int TOP = D::TOP;
    uint32_t t[TOP + 1];
#pragma unroll
    for (int k = 0; k <= TOP; k++) t[k] = 0;
#pragma unroll
    for (int i = 0; i < N; i++) {
      // t += a b[i]; with RB > 0, t < 2^(32 N) before, so the top carry
      // fills t[N]; with RB = 0, t[N] <= 1 before, and the carry goes on
      // into t[N + 1]
      uint32_t c = 0;
#pragma unroll
      for (int j = 0; j < N; j++) {
        const uint64_t s = static_cast<uint64_t>(a[j]) * b[i] + t[j] + c;
        t[j] = static_cast<uint32_t>(s);
        c = static_cast<uint32_t>(s >> 32);
      }
      if constexpr (RB > 0) {
        t[N] = c;
      } else {
        const uint64_t s = static_cast<uint64_t>(t[N]) + c;
        t[N] = static_cast<uint32_t>(s);
        t[N + 1] = static_cast<uint32_t>(s >> 32);
      }
      if (i < NF) {
        // t = (t + m p) / 2^32, the low word cancelled
        const uint32_t m = t[0] * K.n0;
        uint64_t s = static_cast<uint64_t>(m) * K.p[0] + t[0];
        c = static_cast<uint32_t>(s >> 32);
#pragma unroll
        for (int j = 1; j < NP; j++) {
          s = static_cast<uint64_t>(m) * K.p[j] + t[j] + c;
          t[j - 1] = static_cast<uint32_t>(s);
          c = static_cast<uint32_t>(s >> 32);
        }
#pragma unroll
        for (int j = NP; j <= TOP; j++) {
          s = static_cast<uint64_t>(t[j]) + c;
          t[j - 1] = static_cast<uint32_t>(s);
          c = static_cast<uint32_t>(s >> 32);
        }
        t[TOP] = c;
      }
    }
    if constexpr (RB > 0) {
      // the last RB bits: t = (t + m p) / 2^RB
      const uint32_t m = (t[0] * K.n0) & ((1u << RB) - 1);
      uint32_t c = 0;
#pragma unroll
      for (int j = 0; j < NP; j++) {
        const uint64_t s = static_cast<uint64_t>(m) * K.p[j] + t[j] + c;
        t[j] = static_cast<uint32_t>(s);
        c = static_cast<uint32_t>(s >> 32);
      }
#pragma unroll
      for (int j = NP; j <= N; j++) {
        const uint64_t s = static_cast<uint64_t>(t[j]) + c;
        t[j] = static_cast<uint32_t>(s);
        c = static_cast<uint32_t>(s >> 32);
      }
#pragma unroll
      for (int k = 0; k < N; k++)
        r[k] = (t[k] >> RB) | (t[k + 1] << (32 - RB));
    } else {
      // every word reduced: t[N], the bits at and above L W, is dropped
#pragma unroll
      for (int k = 0; k < N; k++) r[k] = t[k];
    }
  }
};

// The multiply out of line, for kernels that call it from more than one
// place: Field::mul's signature with the word constants (in shared
// memory) in place of Consts<L>. One copy of the code a kernel, and the
// threads of a warp that reach it together stay converged. out may
// alias a or b: both are read before out is written.
template <int L, int W>
__device__ __noinline__ void mul_wide(const int32_t* a, const int32_t* b,
                                      int32_t* out,
                                      const WideConsts<L, W>& K) {
  using M = MulWide<L, W>;
  const WideConsts<L, W> Kr = K;   // the words in registers, read once
  uint32_t aw[M::N], bw[M::N], rw[M::N];
  M::pack(a, aw);
  M::pack(b, bw);
  M::mont(aw, bw, rw, Kr);
  M::unpack(rw, out);
}

}  // namespace msm
