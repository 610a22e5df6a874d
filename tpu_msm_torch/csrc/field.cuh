// The signed-lazy limb format's constants and canonical ripple, shared by
// the MSM kernels, and the dispatch on the profiles they are built for.
//
// Limbs are int32_t of W bits in the S12 signed-lazy format of
// tpu_msm_torch/ops/rows.py (the port of tpu_msm/ops/rows.py); every
// kernel's arithmetic is the word-wide multiply of mul_wide.cuh on
// canonical limbs, and the adds between its products are int32 limb
// adds in the plain version's order, so every kernel is bit-identical to
// its plain PyTorch version. Ledger notes the code relies on:
//  - `>>` is an arithmetic shift of a SIGNED value: canon propagates
//    borrows through it (rows.py canon_rows).
//  - No curve constant is written here: p, k*p, R mod p, R^2 and 3b*R
//    arrive in a small device array built by cuzk/kernels.py, laid out
//    as `Consts<L>`, and each kernel copies it into shared memory first.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace msm {

// Flat int32 layout of the constants array (cuzk/kernels.py _consts).
template <int L>
struct Consts {
  int32_t n0;          // -p^-1 mod 2^W
  int32_t b3;          // 3 * b
  int32_t p[L + 1];    // p, one zero limb on top
  int32_t one[L];      // R mod p (Montgomery one)
  int32_t r2[L];       // R^2 mod p
  int32_t b3m[L];      // 3b * R mod p
  int32_t kp2[L];      // 2p
  int32_t kp4[L];      // 4p
  int32_t kp6[L];      // 6p
  int32_t kpb3x2[L];   // (2 * 3b) p
};

// Copy the constants into shared memory. Every thread of the block must
// call it (it ends in __syncthreads).
template <int L>
__device__ inline void load_consts(Consts<L>& dst, const int32_t* src) {
  int32_t* d = reinterpret_cast<int32_t*>(&dst);
  constexpr int N = sizeof(Consts<L>) / sizeof(int32_t);
  for (int i = threadIdx.x; i < N; i += blockDim.x) d[i] = src[i];
  __syncthreads();
}

template <int L, int W>
struct Field {
  static constexpr int32_t MASK = (1 << W) - 1;

  // Full carry ripple -> canonical limbs in [0, 2^W).
  static __device__ __forceinline__ void canon(const int32_t* a, int32_t* out) {
    int32_t c = 0;
#pragma unroll
    for (int i = 0; i < L; i++) {
      int32_t s = a[i] + c;
      out[i] = s & MASK;
      c = s >> W;
    }
  }
};

}  // namespace msm

// Dispatch on the profiles this library is built for: BN254_S12 (L = 22,
// W = 12), BN254_S13 (21, 13), BLS12_377_S12 (32, 12), BLS12_377_S13
// (30, 13) and TINY62 (6, 12). Any other (L, W) returns
// cudaErrorInvalidValue; the Python wrappers refuse it before the call
// (cuzk/kernels.py CUDA_PROFILES).
#define MSM_PROFILE_CASE(L_, W_, LV, WV, ...)                    \
  if ((L_) == (LV) && (W_) == (WV)) {                            \
    constexpr int L = (LV), W = (WV);                            \
    __VA_ARGS__;                                                 \
  } else

#define MSM_DISPATCH_PROFILE(L_, W_, ...)                        \
  do {                                                           \
    MSM_PROFILE_CASE(L_, W_, 22, 12, __VA_ARGS__)                \
    MSM_PROFILE_CASE(L_, W_, 21, 13, __VA_ARGS__)                \
    MSM_PROFILE_CASE(L_, W_, 32, 12, __VA_ARGS__)                \
    MSM_PROFILE_CASE(L_, W_, 30, 13, __VA_ARGS__)                \
    MSM_PROFILE_CASE(L_, W_, 6, 12, __VA_ARGS__) {               \
      return static_cast<int>(cudaErrorInvalidValue);            \
    }                                                            \
  } while (0)
