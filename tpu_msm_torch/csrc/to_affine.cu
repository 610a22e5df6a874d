// Projective to affine, (X : Y : Z) -> (X / Z, Y / Z) and the infinity
// mask, one thread per point.
//
// Replaces the XLA-compiled tpu_msm/ops/inverse.py `to_affine` (no
// pallas_call: XLA fused its loop). Its plain version, ops/inverse.py
// `to_affine_plain`, is a product tree of torch ops and, at its root, a
// Fermat chain of dozens of torch launches a multiply.
// Bound on the H100: operations. A point reads 3 L limbs and writes 2 L
// and a flag, against a chain of about 370 dependent word-wide
// Montgomery multiplies at BN254 (log2 p squarings and popcount(p - 2)
// products) and 560 at BLS12-377. The function needs less: Montgomery's
// trick takes about 6 an element beside one chain for the batch, and
// that is the bound PERF.md holds this kernel to.
// Design: each thread runs its own chain on mul_wide.cuh's multiply,
// inlined, the operands as words in registers:
//   z    = Z * one                (Z's value into [0, 2p) before the
//                                  zero test: a lazy Z of value 2p or 3p
//                                  is infinity too)
//   inf  = z is 0 or p
//   zinv = z^(p - 2)               square-and-multiply over the bits of
//                                  p - 2, from the top, zero to zero
//   x, y = reduce_once(X zinv), reduce_once(Y zinv), zeroed where inf
// Each product's words above L W are dropped, as unpack drops them, so
// every step is rows.py mont_mul_rows bit for bit. The outputs are fully
// reduced, so unique: the chain gives the bits of the plain version's
// product tree (within the limb ledger, X, Y < 4p, where X zinv / R + p
// stays under 2p). The exponent's words come through shared memory, the
// one array the chain indexes at run time.
#include "mul_wide.cuh"

#include <cstring>

namespace {

// The kernel parameter struct, laid out as cuzk/kernels.py
// `_affine_consts_host` builds it.
template <int L, int W>
struct AffineConsts {
  msm::WideConsts<L, W> wide;
  uint32_t one[msm::Wide<L, W>::N];   // R mod p, words
  uint32_t e[msm::Wide<L, W>::N];     // p - 2, words
  int32_t nbits;                      // bits of p - 2
};

template <int L, int W>
struct Affine {
  using M = msm::MulWide<L, W>;
  static constexpr int N = M::N;

  // b's words from registers, in order
  struct Words {
    const uint32_t (&w)[N];
    __device__ __forceinline__ uint32_t next(int i) const { return w[i]; }
  };

  // r = a b / R, its bits at and above L W dropped
  static __device__ __forceinline__ void mul(const uint32_t (&a)[N],
                                             const uint32_t (&b)[N],
                                             uint32_t (&r)[N],
                                             const msm::WideConsts<L, W>& K) {
    Words bw{b};
    M::mont(a, bw, r, K);
    if constexpr (M::RB > 0) r[N - 1] &= (1u << M::RB) - 1;
  }

  static __device__ __forceinline__ uint32_t p_word(
      const msm::WideConsts<L, W>& K, int k) {
    return k < M::NP ? K.p[k] : 0u;
  }

  // the limbs of one coordinate of point f, packed to words
  static __device__ __forceinline__ void load(const int32_t* c, int64_t K,
                                              int64_t f, uint32_t (&w)[N]) {
    int32_t a[L];
#pragma unroll
    for (int i = 0; i < L; i++) a[i] = c[(int64_t)i * K + f];
    M::pack(a, w);
  }

  // reduce_once (r < 2p -> r mod p), zeroed where inf, stored as limbs
  static __device__ __forceinline__ void store(
      uint32_t (&r)[N], bool inf, const msm::WideConsts<L, W>& C,
      int32_t* out, int64_t K, int64_t f) {
    int cmp = 0;
#pragma unroll
    for (int k = N - 1; k >= 0; k--) {
      const uint32_t pk = p_word(C, k);
      if (cmp == 0) cmp = (r[k] > pk) - (r[k] < pk);
    }
    if (cmp >= 0) {
      uint32_t borrow = 0;
#pragma unroll
      for (int k = 0; k < N; k++) {
        const uint64_t d = static_cast<uint64_t>(r[k]) - p_word(C, k) - borrow;
        r[k] = static_cast<uint32_t>(d);
        borrow = static_cast<uint32_t>(d >> 63);
      }
    }
    int32_t a[L];
    M::unpack(r, a);
#pragma unroll
    for (int i = 0; i < L; i++) out[(int64_t)i * K + f] = inf ? 0 : a[i];
  }
};

template <int L, int W>
__global__ void __launch_bounds__(128)
to_affine_kernel(const int32_t* __restrict__ pts, int64_t K,
                 int32_t* __restrict__ ax, int32_t* __restrict__ ay,
                 uint8_t* __restrict__ inf_out, const AffineConsts<L, W> C) {
  using A = Affine<L, W>;
  constexpr int N = A::N;
  __shared__ uint32_t e[N];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; k++) e[k] = C.e[k];
  }
  __syncthreads();
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= K) return;
  const int64_t plane = (int64_t)L * K;

  // z = Z * one, and the zero test on it
  uint32_t z[N], acc[N], r[N];
  A::load(pts + 2 * plane, K, f, acc);
  A::mul(acc, C.one, z, C.wide);
  bool zero = true, isp = true;
#pragma unroll
  for (int k = 0; k < N; k++) {
    zero = zero && z[k] == 0;
    isp = isp && z[k] == A::p_word(C.wide, k);
  }
  const bool inf = zero || isp;

  // zinv = z^(p - 2), left to right from the Montgomery one
#pragma unroll
  for (int k = 0; k < N; k++) acc[k] = C.one[k];
  for (int i = C.nbits - 1; i >= 0; i--) {
    A::mul(acc, acc, r, C.wide);
    if ((e[i >> 5] >> (i & 31)) & 1) {
      A::mul(r, z, acc, C.wide);
    } else {
#pragma unroll
      for (int k = 0; k < N; k++) acc[k] = r[k];
    }
  }

  A::load(pts, K, f, z);
  A::mul(z, acc, r, C.wide);
  A::store(r, inf, C.wide, ax, K, f);
  A::load(pts + plane, K, f, z);
  A::mul(z, acc, r, C.wide);
  A::store(r, inf, C.wide, ay, K, f);
  inf_out[f] = inf;
}

}  // namespace

// pts: (3, L, K) int32, coordinate-major; consts: host memory, `words`
// words of AffineConsts<L, W> in its layout.
extern "C" int msm_to_affine(int num_limbs, int limb_bits, const int32_t* pts,
                             int64_t K, int32_t* ax, int32_t* ay,
                             uint8_t* inf, const uint32_t* consts, int words,
                             void* stream) {
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((K + threads - 1) / threads);
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    AffineConsts<L, W> C;
    if (static_cast<size_t>(words) * sizeof(uint32_t) != sizeof(C))
      return static_cast<int>(cudaErrorInvalidValue);
    std::memcpy(&C, consts, sizeof(C));
    to_affine_kernel<L, W><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pts, K, ax, ay, inf, C);
  });
  return static_cast<int>(cudaGetLastError());
}
