// The GLV split and the doubled point stream, one thread per point.
//
// Replaces the XLA-compiled part of tpu_msm/cuzk/glv.py `apply_glv`
// before its digits (no pallas_call: XLA fused it into the device
// program): `split_scalars`, phi(P) = (beta x, y) and the signs folded
// into y. Its plain version, cuzk/kernels.py `glv_apply_plain`, is some
// hundreds of small torch launches on int64 halfwords.
// Bound on the H100: bytes. A point reads L limbs of x and of y and 16
// scalar halfwords, and writes 2 L limbs of x and of y, 12 halfwords of
// each magnitude and two signs (about 700 B at L = 22), against one
// word-wide Montgomery multiply (315 int32 multiply halves at L = 22)
// and the split's 160 word products.
// Design: one thread per point n, lane-major loads and stores (limb i of
// neighbouring points is contiguous), coalesced. The split is
// glv_split.cuh's word arithmetic on 64-bit accumulators; beta x is
// mul_wide.cuh's multiply inlined, beta R mod p streamed as words from
// the parameter struct, as encode_mont streams R^2; 2p - y is rippled
// limb by limb as rows.py canon_rows ripples it. Bit-identical to
// glv_apply_plain: the same integers, the same multiply.
#include "glv_split.cuh"
#include "mul_wide.cuh"

#include <cstring>

namespace {

// The kernel parameter struct, laid out as cuzk/kernels.py
// `_glv_consts_host` builds it.
template <int L, int W>
struct GlvConsts {
  msm::WideConsts<L, W> wide;
  uint32_t beta[msm::Wide<L, W>::N];   // beta R mod p, words
  int32_t kp2[L];                      // 2p, canonical limbs
  msm::GlvSplit split;
};

template <int L, int W>
__global__ void __launch_bounds__(256)
glv_apply_kernel(const int32_t* __restrict__ xm,
                 const int32_t* __restrict__ ym,
                 const int32_t* __restrict__ hw, int rows, int64_t n,
                 int32_t* __restrict__ x2, int32_t* __restrict__ y2,
                 int32_t* __restrict__ mags, uint8_t* __restrict__ neg1,
                 uint8_t* __restrict__ neg2, const GlvConsts<L, W> K) {
  using M = msm::MulWide<L, W>;
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int64_t n2 = 2 * n;

  // the split: 16-bit halfwords two a word, rows past `rows` zero
  uint32_t k[msm::kGlvK];
#pragma unroll
  for (int j = 0; j < msm::kGlvK; j++) {
    const uint32_t lo = 2 * j < rows ? hw[(int64_t)(2 * j) * n + f] : 0;
    const uint32_t hi = 2 * j + 1 < rows ? hw[(int64_t)(2 * j + 1) * n + f]
                                         : 0;
    k[j] = lo | (hi << 16);
  }
  bool s1, s2;
  uint32_t m1[msm::kGlvB], m2[msm::kGlvB];
  msm::glv_split(k, K.split, s1, m1, s2, m2);
#pragma unroll
  for (int j = 0; j < 2 * msm::kGlvB; j++) {
    const int sh = 16 * (j & 1);
    mags[(int64_t)j * n2 + f] =
        static_cast<int32_t>((m1[j >> 1] >> sh) & 0xFFFF);
    mags[(int64_t)j * n2 + n + f] =
        static_cast<int32_t>((m2[j >> 1] >> sh) & 0xFFFF);
  }
  neg1[f] = s1;
  neg2[f] = s2;

  // x' = [x | beta x]
  int32_t a[L];
#pragma unroll
  for (int i = 0; i < L; i++) {
    a[i] = xm[(int64_t)i * n + f];
    x2[(int64_t)i * n2 + f] = a[i];
  }
  uint32_t aw[M::N], rw[M::N];
  M::pack(a, aw);
  struct {
    const GlvConsts<L, W>& K;
    __device__ __forceinline__ uint32_t next(int i) const { return K.beta[i]; }
  } beta{K};
  M::mont(aw, beta, rw, K.wide);
  M::unpack(rw, a);
#pragma unroll
  for (int i = 0; i < L; i++) x2[(int64_t)i * n2 + n + f] = a[i];

  // y' = [s1 ? 2p - y : y | s2 ? 2p - y : y], 2p - y rippled to
  // canonical limbs
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < L; i++) {
    const int32_t y = ym[(int64_t)i * n + f];
    const int32_t d = K.kp2[i] - y + c;
    const int32_t yn = d & msm::Field<L, W>::MASK;
    c = d >> W;
    y2[(int64_t)i * n2 + f] = s1 ? yn : y;
    y2[(int64_t)i * n2 + n + f] = s2 ? yn : y;
  }
}

template <int L, int W>
int launch(const int32_t* xm, const int32_t* ym, const int32_t* hw, int rows,
           int64_t n, int32_t* x2, int32_t* y2, int32_t* mags, uint8_t* neg1,
           uint8_t* neg2, const uint32_t* consts, int words,
           cudaStream_t stream) {
  GlvConsts<L, W> K;
  if (static_cast<size_t>(words) * sizeof(uint32_t) != sizeof(K))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&K, consts, sizeof(K));
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  glv_apply_kernel<L, W><<<blocks, threads, 0, stream>>>(
      xm, ym, hw, rows, n, x2, y2, mags, neg1, neg2, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: host memory, `words` words of GlvConsts<L, W> in its layout.
// Built for the profiles with an endomorphism: BN254_S12, BN254_S13,
// BLS12_377_S12 and BLS12_377_S13 (TINY62 has none).
extern "C" int msm_glv_apply(int num_limbs, int limb_bits, const int32_t* xm,
                             const int32_t* ym, const int32_t* hw, int rows,
                             int64_t n, int32_t* x2, int32_t* y2,
                             int32_t* mags, uint8_t* neg1, uint8_t* neg2,
                             const uint32_t* consts, int words, void* stream) {
  const auto s = (cudaStream_t)stream;
  if (rows < 0 || rows > 2 * msm::kGlvK)
    return static_cast<int>(cudaErrorInvalidValue);
#define MSM_GLV_CASE(LV, WV)                                                \
  if (num_limbs == (LV) && limb_bits == (WV))                               \
    return launch<LV, WV>(xm, ym, hw, rows, n, x2, y2, mags, neg1, neg2,   \
                          consts, words, s);
  MSM_GLV_CASE(22, 12)
  MSM_GLV_CASE(21, 13)
  MSM_GLV_CASE(32, 12)
  MSM_GLV_CASE(30, 13)
#undef MSM_GLV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
