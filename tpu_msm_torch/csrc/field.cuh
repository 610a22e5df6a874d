// Signed-lazy field and point arithmetic for the MSM kernels.
//
// CUDA twin of tpu_msm_torch/ops/rows.py (itself the port of
// tpu_msm/ops/rows.py): the same int32 operations in the same order, so
// every kernel built on this header is bit-identical to its plain PyTorch
// version. Templated on the limb count L and the limb width W.
//
// Ledger notes the code relies on:
//  - Limbs are int32_t and `>>` is an arithmetic shift of a SIGNED value:
//    canon/fold propagate borrows through it (rows.py canon_rows).
//  - The 12-bit (and 13-bit) products and their deferred sums stay below
//    2^31 under the fold schedule of fold_interval(), so no signed
//    overflow (which would be undefined behaviour) ever happens.
//  - No curve constant is written here: p, k*p, R mod p, R^2, 3b*R and n0
//    arrive in a small device array built by cuzk/kernels.py, laid out as
//    `Consts<L>`, and each kernel copies it into shared memory first.
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

// Iterations between carry folds in the deferred-carry Montgomery loop
// (constants.signed_fold_interval): 63 for W = 12, 15 for W = 13.
__host__ __device__ constexpr int fold_interval(int w) {
  long long per = 2LL * ((1LL << w) - 1) * ((1LL << w) - 1) + (1LL << (w + 6));
  long long v = ((1LL << 31) - (1LL << (w + 2))) / per;
  return v < 1 ? 1 : static_cast<int>(v);
}

// Copy the constants into shared memory. Every thread of the block must
// call it (it ends in __syncthreads).
template <int L>
__device__ inline void load_consts(Consts<L>& dst, const int32_t* src) {
  int32_t* d = reinterpret_cast<int32_t*>(&dst);
  constexpr int N = sizeof(Consts<L>) / sizeof(int32_t);
  for (int i = threadIdx.x; i < N; i += blockDim.x) d[i] = src[i];
  __syncthreads();
}

template <int L>
struct Pt {
  int32_t x[L], y[L], z[L];
};

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

  static __device__ __forceinline__ void add(const int32_t* a, const int32_t* b,
                                             int32_t* out) {
#pragma unroll
    for (int i = 0; i < L; i++) out[i] = a[i] + b[i];
  }

  // a - b + kp (lazy subtract)
  static __device__ __forceinline__ void sub(const int32_t* a, const int32_t* b,
                                             const int32_t* kp, int32_t* out) {
#pragma unroll
    for (int i = 0; i < L; i++) out[i] = a[i] - b[i] + kp[i];
  }

  static __device__ __forceinline__ void smul(const int32_t* a, int32_t c,
                                              int32_t* out) {
#pragma unroll
    for (int i = 0; i < L; i++) out[i] = a[i] * c;
  }

  // Deferred-carry Montgomery multiply (rows.mont_mul_rows): inputs with
  // values in [0, 32p], output canonical limbs with value in [0, 2p).
  static __device__ __noinline__ void mul(const int32_t* a, const int32_t* b,
                                          int32_t* out, const Consts<L>& K) {
    int32_t ac[L], bc[L], t[L + 1];
    canon(a, ac);
    canon(b, bc);
#pragma unroll
    for (int j = 0; j <= L; j++) t[j] = 0;
    constexpr int FOLD = fold_interval(W);
#pragma unroll
    for (int i = 0; i < L; i++) {
      const int32_t bi = bc[i];
#pragma unroll
      for (int j = 0; j < L; j++) t[j] += ac[j] * bi;
      const int32_t m = ((t[0] & MASK) * K.n0) & MASK;
#pragma unroll
      for (int j = 0; j <= L; j++) t[j] += m * K.p[j];
      const int32_t c0 = t[0] >> W;
#pragma unroll
      for (int j = 0; j < L; j++) t[j] = t[j + 1];
      t[L] = 0;
      t[0] += c0;
      if ((i + 1) % FOLD == 0 && (i + 1) < L) {
        // value-preserving mid-loop fold; the top carry is zero
        int32_t prev = t[0] >> W;
        t[0] &= MASK;
#pragma unroll
        for (int j = 1; j <= L; j++) {
          const int32_t cur = t[j] >> W;
          t[j] = (t[j] & MASK) + prev;
          prev = cur;
        }
      }
    }
    int32_t c = 0;
#pragma unroll
    for (int j = 0; j < L; j++) {
      int32_t s = t[j] + c;
      out[j] = s & MASK;
      c = s >> W;
    }
  }

  static __device__ __forceinline__ void set_inf(Pt<L>& p, const Consts<L>& K) {
#pragma unroll
    for (int i = 0; i < L; i++) {
      p.x[i] = 0;
      p.y[i] = K.one[i];
      p.z[i] = 0;
    }
  }

  // RCB Algorithm 7, complete add (rows.padd_rows). `out` may alias.
  static __device__ __noinline__ void padd(const Pt<L>& p1, const Pt<L>& p2,
                                           Pt<L>& out, const Consts<L>& K) {
    int32_t t0[L], t1[L], t2[L], t3[L], t4[L], xz[L], u[L], v[L], s[L];
    int32_t x3[L], y3[L], z3[L];
    mul(p1.x, p2.x, t0, K);
    mul(p1.y, p2.y, t1, K);
    mul(p1.z, p2.z, t2, K);
    add(p1.x, p1.y, u); add(p2.x, p2.y, v); mul(u, v, t3, K);
    add(t0, t1, s); sub(t3, s, K.kp4, t3);
    add(p1.y, p1.z, u); add(p2.y, p2.z, v); mul(u, v, t4, K);
    add(t1, t2, s); sub(t4, s, K.kp4, t4);
    add(p1.x, p1.z, u); add(p2.x, p2.z, v); mul(u, v, xz, K);
    add(t0, t2, s); sub(xz, s, K.kp4, xz);
    smul(t0, 3, t0);
    smul(t2, K.b3, t2);
    add(t1, t2, z3);
    sub(t1, t2, K.kpb3x2, t1);
    int32_t yz[L];
    smul(xz, K.b3, yz);
    mul(t3, t1, u, K); mul(t4, yz, v, K); sub(u, v, K.kp2, x3);
    mul(t1, z3, u, K); mul(yz, t0, v, K); add(u, v, y3);
    mul(z3, t4, u, K); mul(t0, t3, v, K); add(u, v, z3);
#pragma unroll
    for (int i = 0; i < L; i++) {
      out.x[i] = x3[i];
      out.y[i] = y3[i];
      out.z[i] = z3[i];
    }
  }

  // RCB Algorithm 8, complete mixed add with Z2 == 1 (rows.pmadd_rows).
  static __device__ __noinline__ void pmadd(const Pt<L>& p1, const int32_t* x2,
                                            const int32_t* y2, Pt<L>& out,
                                            const Consts<L>& K) {
    int32_t t0[L], t1[L], t2[L], t3[L], t4[L], xz[L], u[L], v[L], s[L];
    int32_t x3[L], y3[L], z3[L], yz[L];
    mul(p1.x, x2, t0, K);
    mul(p1.y, y2, t1, K);
    add(p1.x, p1.y, u); add(x2, y2, v); mul(u, v, t3, K);
    add(t0, t1, s); sub(t3, s, K.kp4, t3);
    mul(y2, p1.z, u, K); add(u, p1.y, t4);
    mul(x2, p1.z, u, K); add(u, p1.x, xz);
    smul(t0, 3, t0);
    mul(p1.z, K.b3m, t2, K);
    add(t1, t2, z3);
    sub(t1, t2, K.kp2, t1);
    smul(xz, K.b3, yz);
    mul(t3, t1, u, K); mul(t4, yz, v, K); sub(u, v, K.kp2, x3);
    mul(t1, z3, u, K); mul(yz, t0, v, K); add(u, v, y3);
    mul(z3, t4, u, K); mul(t0, t3, v, K); add(u, v, z3);
#pragma unroll
    for (int i = 0; i < L; i++) {
      out.x[i] = x3[i];
      out.y[i] = y3[i];
      out.z[i] = z3[i];
    }
  }
};

// A point stored in the stacked layout, coordinate c, limb i, lane f at
// base[(c * L + i) * stride + f], with plain truncating casts: exact for
// int16 by the (-2^W, 2^(W+1)) limb bound of every point result when
// W <= 13.
template <int L, typename T>
__device__ __forceinline__ void store_pt(T* base, int64_t stride, int64_t f,
                                         const Pt<L>& p) {
#pragma unroll
  for (int i = 0; i < L; i++) {
    base[(int64_t)i * stride + f] = static_cast<T>(p.x[i]);
    base[(int64_t)(L + i) * stride + f] = static_cast<T>(p.y[i]);
    base[(int64_t)(2 * L + i) * stride + f] = static_cast<T>(p.z[i]);
  }
}

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
