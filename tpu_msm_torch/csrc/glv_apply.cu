// The GLV split and the doubled point stream, as row-table rows, one
// thread per point.
//
// Replaces the XLA-compiled part of tpu_msm/cuzk/glv.py `apply_glv`
// before its digits (no pallas_call: XLA fused it into the device
// program): `split_scalars`, phi(P) = (beta x, y) and the signs folded
// into y; and the Montgomery encode of the wire limbs before it and the
// (2n, 2L) int16 row table after it (pipeline_pallas.py:141-143 and :258
// on the doubled stream). Its plain
// version, cuzk/kernels.py `glv_rows_plain`, is some hundreds of small
// torch launches on int64 halfwords.
// Bound on the H100: bytes. A point reads L limbs of x and of y (int16
// or int32, as staged) and 16 scalar halfwords (uint16 or int32), and
// writes two 4 L-byte rows, 12 int32 halfwords of each magnitude and two
// signs (about 400 B at L = 22 with int16 wire limbs and uint16
// halfwords), against three word-wide Montgomery multiplies (the encode
// of x and y by R^2, beta x; 315 int32 multiply halves each at L = 22)
// and the split's 160 word products.
// Design: one thread per point n, lane-major loads (limb i of
// neighbouring points is contiguous), coalesced, read in place at either
// width and any row stride. The split is glv_split.cuh's word arithmetic
// on 64-bit accumulators; the encode and beta x are
// mul_wide.cuh's multiply inlined, R^2 and beta R mod p streamed as words
// from the parameter struct, as encode_mont streams R^2; 2p - y is
// rippled limb by limb as rows.py canon_rows ripples it. A block builds
// its rows sign1 P and sign2 phi(P) in shared memory and copies each run
// of rows out contiguously (row_table.cuh): rows [0, n) are the points,
// rows [n, 2n) their images. Bit-identical to glv_rows_plain: the same
// integers, the same multiply.
#include "glv_split.cuh"
#include "mul_wide.cuh"
#include "row_table.cuh"

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

constexpr int kThreads = 128;

// a -> a b R^-1 mod p in place, b's words from b.next(i).
template <int L, int W, typename B>
__device__ __forceinline__ void mul_by(int32_t (&a)[L], B& b,
                                       const msm::WideConsts<L, W>& K) {
  using M = msm::MulWide<L, W>;
  uint32_t aw[M::N], rw[M::N];
  M::pack(a, aw);
  M::mont(aw, b, rw, K);
  M::unpack(rw, a);
}

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
glv_apply_kernel(const void* __restrict__ xs, const void* __restrict__ ys,
                 int limb_bytes, int64_t ldx, int64_t ldy,
                 const void* __restrict__ hw, int hw_bytes, int64_t ldh,
                 int rows, int64_t n, int16_t* __restrict__ table,
                 int32_t* __restrict__ mags, uint8_t* __restrict__ neg1,
                 uint8_t* __restrict__ neg2, const GlvConsts<L, W> K) {
  __shared__ __align__(16) int16_t tile[2][kThreads * 2 * L];
  const int64_t f0 = (int64_t)blockIdx.x * kThreads;
  const int64_t f = f0 + threadIdx.x;
  const int64_t n2 = 2 * n;
  if (f < n) {
    // the split: 16-bit halfwords two a word, rows past `rows` zero
    uint32_t k[msm::kGlvK];
#pragma unroll
    for (int j = 0; j < msm::kGlvK; j++) {
      const uint32_t lo =
          2 * j < rows ? msm::load_halfword(hw, hw_bytes, 2 * j * ldh + f) : 0;
      const uint32_t hi =
          2 * j + 1 < rows
              ? msm::load_halfword(hw, hw_bytes, (2 * j + 1) * ldh + f)
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

    struct {
      const GlvConsts<L, W>& K;
      __device__ __forceinline__ uint32_t next(int i) const {
        return K.wide.r2[i];
      }
    } r2w{K};
    struct {
      const GlvConsts<L, W>& K;
      __device__ __forceinline__ uint32_t next(int i) const {
        return K.beta[i];
      }
    } beta{K};
    int16_t* r1 = tile[0] + threadIdx.x * 2 * L;   // sign1 P
    int16_t* r2 = tile[1] + threadIdx.x * 2 * L;   // sign2 phi(P)
    // x' = [x | beta x]
    int32_t a[L];
#pragma unroll
    for (int i = 0; i < L; i++)
      a[i] = msm::load_limb(xs, limb_bytes, i * ldx + f);
    mul_by<L, W>(a, r2w, K.wide);
#pragma unroll
    for (int i = 0; i < L; i++) r1[i] = static_cast<int16_t>(a[i]);
    mul_by<L, W>(a, beta, K.wide);
#pragma unroll
    for (int i = 0; i < L; i++) r2[i] = static_cast<int16_t>(a[i]);

    // y' = [s1 ? 2p - y : y | s2 ? 2p - y : y], 2p - y rippled to
    // canonical limbs
#pragma unroll
    for (int i = 0; i < L; i++)
      a[i] = msm::load_limb(ys, limb_bytes, i * ldy + f);
    mul_by<L, W>(a, r2w, K.wide);
    int32_t c = 0;
#pragma unroll
    for (int i = 0; i < L; i++) {
      const int32_t y = a[i];
      const int32_t d = K.kp2[i] - y + c;
      const int32_t yn = d & msm::Field<L, W>::MASK;
      c = d >> W;
      r1[L + i] = static_cast<int16_t>(s1 ? yn : y);
      r2[L + i] = static_cast<int16_t>(s2 ? yn : y);
    }
  }
  __syncthreads();
  const int64_t left = n - f0;
  const int nb = left < kThreads ? static_cast<int>(left) : kThreads;
  msm::block_copy_words(reinterpret_cast<int32_t*>(table + f0 * 2 * L),
                        reinterpret_cast<const int32_t*>(tile[0]), nb * L);
  msm::block_copy_words(reinterpret_cast<int32_t*>(table + (n + f0) * 2 * L),
                        reinterpret_cast<const int32_t*>(tile[1]), nb * L);
}

template <int L, int W>
int launch(const void* xs, const void* ys, int limb_bytes, int64_t ldx,
           int64_t ldy, const void* hw, int hw_bytes, int64_t ldh,
           int rows, int64_t n, int16_t* table, int32_t* mags, uint8_t* neg1,
           uint8_t* neg2, const uint32_t* consts, int words,
           cudaStream_t stream) {
  GlvConsts<L, W> K;
  if (static_cast<size_t>(words) * sizeof(uint32_t) != sizeof(K))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&K, consts, sizeof(K));
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  glv_apply_kernel<L, W><<<blocks, kThreads, 0, stream>>>(
      xs, ys, limb_bytes, ldx, ldy, hw, hw_bytes, ldh, rows, n, table,
      mags, neg1, neg2, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs, ys: (L, n) standard-form limbs of limb_bytes (2 or 4), encoded
// here; row i of xs at xs + i ldx elements (ys: ldy). hw: (H, n) halfwords of hw_bytes (2: uint16, 4:
// int32), row i at hw + i ldh, its first `rows` rows read. table: the
// (2n, 2L) int16 rows; mags: (12, 2n) int32; neg1, neg2: (n,) bool.
// consts: host memory, `words` words of GlvConsts<L, W> in its layout.
// Built for the profiles with an endomorphism: BN254_S12, BN254_S13,
// BLS12_377_S12 and BLS12_377_S13 (TINY62 has none).
extern "C" int msm_glv_apply(int num_limbs, int limb_bits, const void* xs,
                             const void* ys, int limb_bytes, int64_t ldx,
                             int64_t ldy, const void* hw,
                             int hw_bytes, int64_t ldh, int rows, int64_t n,
                             int16_t* table, int32_t* mags, uint8_t* neg1,
                             uint8_t* neg2, const uint32_t* consts, int words,
                             void* stream) {
  const auto s = (cudaStream_t)stream;
  if (rows < 0 || rows > 2 * msm::kGlvK || n < 1 ||
      (limb_bytes != 2 && limb_bytes != 4) || (hw_bytes != 2 && hw_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
#define MSM_GLV_CASE(LV, WV)                                                \
  if (num_limbs == (LV) && limb_bits == (WV))                               \
    return launch<LV, WV>(xs, ys, limb_bytes, ldx, ldy, hw,                \
                          hw_bytes, ldh, rows, n, table, mags, neg1, neg2, \
                          consts, words, s);
  MSM_GLV_CASE(22, 12)
  MSM_GLV_CASE(21, 13)
  MSM_GLV_CASE(32, 12)
  MSM_GLV_CASE(30, 13)
#undef MSM_GLV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
