// The GLV scalar split on 32-bit words: what cuzk/kernels.py
// `split_scalars` computes on 16-bit halfwords, for one scalar.
//
// For a scalar k < 2^256 (16 halfwords, 8 words):
//   c_j = (k g_j + 2^271) >> 272           (M_SHIFT = 272), j = 1, 2
//   k1  = k - c1 a1 - c2 a2               mod 2^192
//   k2  = -(c1 b1 + c2 b2)                mod 2^192
// in two's complement; the sign is bit 191 and the magnitude the two's
// complement where it is set. The halfword version keeps the product
// k g in 16 + 10 halfwords and c in 9, its top halfwords of k dropped by
// the slice to 12; these are the same integers: k g + 2^271 < 2^416 for
// g < 2^159 (the wrapper checks the curve), so c < 2^144 fits 5 words,
// and c a mod 2^192 is the low 6 words of the product. So the words
// here are the halfwords there, two a word, bit for bit
// (tests/test_torch_glv_kernel.py builds this header with g++ and
// holds it against split_scalars).
//
// No PTX and nothing of the CUDA runtime: the same code compiles for the
// card (glv_apply.cu) and for the host (the test).
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define MSM_HD __host__ __device__ __forceinline__
#else
#define MSM_HD inline
#endif

namespace msm {

constexpr int kGlvK = 8;   // words of a scalar
constexpr int kGlvG = 5;   // words of a Babai multiplier g_j < 2^159
constexpr int kGlvC = 5;   // words of c_j < 2^144
constexpr int kGlvB = 6;   // words of the lattice combination, mod 2^192

// The split's constants, laid out as cuzk/kernels.py `_glv_split_words`
// builds them: g1, g2, then a1, a2, b1, b2 mod 2^192.
struct GlvSplit {
  uint32_t g1[kGlvG], g2[kGlvG];
  uint32_t a1[kGlvB], a2[kGlvB], b1[kGlvB], b2[kGlvB];
};

// c = (k g + 2^271) >> 272: the product in 13 words, 2^271 (bit 15 of
// word 8) added with its carry rippled to the top, then words 8 .. 12
// shifted down by 16 bits.
MSM_HD void glv_babai(const uint32_t (&k)[kGlvK], const uint32_t (&g)[kGlvG],
                      uint32_t (&c)[kGlvC]) {
  constexpr int T = kGlvK + kGlvG;
  uint32_t t[T] = {};
#pragma unroll
  for (int i = 0; i < kGlvK; i++) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < kGlvG; j++) {
      const uint64_t s = static_cast<uint64_t>(k[i]) * g[j] + t[i + j] + carry;
      t[i + j] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
    t[i + kGlvG] = static_cast<uint32_t>(carry);
  }
  uint64_t s = static_cast<uint64_t>(t[8]) + (1u << 15);
  t[8] = static_cast<uint32_t>(s);
#pragma unroll
  for (int i = 9; i < T; i++) {
    s = static_cast<uint64_t>(t[i]) + (s >> 32);
    t[i] = static_cast<uint32_t>(s);
  }
#pragma unroll
  for (int j = 0; j < kGlvC; j++)
    c[j] = (t[8 + j] >> 16) | (9 + j < T ? t[9 + j] << 16 : 0u);
}

// x -= c a mod 2^192: the product's low 6 words, each row's carry into
// the word above dropped at the top, then a borrow ripple.
MSM_HD void glv_sub_mul(uint32_t (&x)[kGlvB], const uint32_t (&c)[kGlvC],
                        const uint32_t (&a)[kGlvB]) {
  uint32_t r[kGlvB] = {};
#pragma unroll
  for (int i = 0; i < kGlvC; i++) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; i + j < kGlvB; j++) {
      const uint64_t s = static_cast<uint64_t>(c[i]) * a[j] + r[i + j] + carry;
      r[i + j] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kGlvB; j++) {
    const uint64_t d = static_cast<uint64_t>(x[j]) - r[j] - borrow;
    x[j] = static_cast<uint32_t>(d);
    borrow = static_cast<uint32_t>(d >> 63);
  }
}

// Two's complement sign (bit 191) and magnitude, in place.
MSM_HD bool glv_sign_mag(uint32_t (&x)[kGlvB]) {
  const bool neg = (x[kGlvB - 1] >> 31) != 0;
  if (neg) {
    uint32_t carry = 1;
#pragma unroll
    for (int j = 0; j < kGlvB; j++) {
      const uint64_t s = static_cast<uint64_t>(~x[j]) + carry;
      x[j] = static_cast<uint32_t>(s);
      carry = static_cast<uint32_t>(s >> 32);
    }
  }
  return neg;
}

// k -> (neg1, |k1|, neg2, |k2|), the magnitudes as 6 words each.
MSM_HD void glv_split(const uint32_t (&k)[kGlvK], const GlvSplit& C,
                      bool& neg1, uint32_t (&m1)[kGlvB], bool& neg2,
                      uint32_t (&m2)[kGlvB]) {
  uint32_t c1[kGlvC], c2[kGlvC];
  glv_babai(k, C.g1, c1);
  glv_babai(k, C.g2, c2);
#pragma unroll
  for (int j = 0; j < kGlvB; j++) {
    m1[j] = k[j];   // k mod 2^192: the top words dropped on purpose
    m2[j] = 0;
  }
  glv_sub_mul(m1, c1, C.a1);
  glv_sub_mul(m1, c2, C.a2);
  glv_sub_mul(m2, c1, C.b1);
  glv_sub_mul(m2, c2, C.b2);
  neg1 = glv_sign_mag(m1);
  neg2 = glv_sign_mag(m2);
}

}  // namespace msm
