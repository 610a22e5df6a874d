// Montgomery encode: x -> x * R mod p, one thread per lane; and
// encode_rows, the same encode of x and y written as the points' row
// table.
//
// encode_mont replaces tpu_msm/cuzk/kernels.py `_encode_kernel` /
// `encode_mont`.
// Bound on the H100: bytes. Each lane reads L int32 limbs and writes L,
// 8 L bytes, against one word-wide Montgomery multiply by R^2 (315
// int32 multiply and multiply-add halves at L = 22, mul_wide.cuh).
// Design: one thread per lane n (2^20 lanes fill the card), limbs in
// registers; lane-major loads and stores (limb i of neighbouring lanes
// is contiguous) are coalesced. The multiply is mul_wide.cuh's, inlined
// at its call site, with its constants in the kernel parameter struct:
// p, n0 and R^2 come as words from the constant bank, and R^2 is not
// rippled or packed per call. Bit-identical to rows.py to_mont_rows.
//
// encode_rows replaces no pallas_call: it is XLA's part of the JAX
// package's stage 1 around the encode kernel (pipeline_pallas.py:141-143,
// the casts to the kernel's int32, and :258, the (n, 2L) int16 row table
// made from the encoded x and y by a concatenate, a convert and a
// transpose), which the port ran as torch ops over the whole stream.
// Bound on the H100: bytes. A point reads its 2 L wire limbs (int16 or
// int32, as staged) and writes one 4 L-byte row: 176 B at L = 22 with
// int16 limbs, 264 B with int32; two multiplies by R^2 a point.
// Design: encode_mont's thread and multiply, twice, reading the staged
// limbs in place (either width, any row stride, so a pass's slice of a
// larger input needs no copy); the row is built in shared memory and
// the block's rows go out as one contiguous run (row_table.cuh).
// Bit-identical to encode_mont's limbs, cast to int16 (canonical limbs
// below 2^13).
#include "mul_wide.cuh"
#include "row_table.cuh"

#include <cstring>

namespace {

// a (L canonical limbs) -> a R mod p, in place.
template <int L, int W>
__device__ __forceinline__ void encode_limbs(int32_t (&a)[L],
                                             const msm::WideConsts<L, W>& K) {
  using M = msm::MulWide<L, W>;
  uint32_t aw[M::N], rw[M::N];
  M::pack(a, aw);
  struct {
    const msm::WideConsts<L, W>& K;
    __device__ __forceinline__ uint32_t next(int i) const { return K.r2[i]; }
  } r2{K};
  M::mont(aw, r2, rw, K);
  M::unpack(rw, a);
}

template <int L, int W>
__global__ void __launch_bounds__(256)
encode_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ out,
              int64_t n, const msm::WideConsts<L, W> K) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  int32_t a[L];
#pragma unroll
  for (int i = 0; i < L; i++) a[i] = xs[(int64_t)i * n + f];
  encode_limbs<L, W>(a, K);
#pragma unroll
  for (int i = 0; i < L; i++) out[(int64_t)i * n + f] = a[i];
}

constexpr int kRowsThreads = 128;

template <int L, int W>
__global__ void __launch_bounds__(kRowsThreads)
encode_rows_kernel(const void* __restrict__ xs, const void* __restrict__ ys,
                   int bytes, int64_t ldx, int64_t ldy,
                   int16_t* __restrict__ rows, int64_t n,
                   const msm::WideConsts<L, W> K) {
  __shared__ __align__(16) int16_t tile[kRowsThreads * 2 * L];
  const int64_t f0 = (int64_t)blockIdx.x * kRowsThreads;
  const int64_t f = f0 + threadIdx.x;
  if (f < n) {
    int16_t* row = tile + threadIdx.x * 2 * L;
    int32_t a[L];
#pragma unroll
    for (int i = 0; i < L; i++)
      a[i] = msm::load_limb(xs, bytes, i * ldx + f);
    encode_limbs<L, W>(a, K);
#pragma unroll
    for (int i = 0; i < L; i++) row[i] = static_cast<int16_t>(a[i]);
#pragma unroll
    for (int i = 0; i < L; i++)
      a[i] = msm::load_limb(ys, bytes, i * ldy + f);
    encode_limbs<L, W>(a, K);
#pragma unroll
    for (int i = 0; i < L; i++) row[L + i] = static_cast<int16_t>(a[i]);
  }
  __syncthreads();
  const int64_t left = n - f0;
  const int nb = left < kRowsThreads ? static_cast<int>(left) : kRowsThreads;
  msm::block_copy_words(reinterpret_cast<int32_t*>(rows + f0 * 2 * L),
                        reinterpret_cast<const int32_t*>(tile), nb * L);
}

}  // namespace

// wide: host memory, the words of msm::WideConsts<L, W> in its layout.
extern "C" int msm_encode_mont(int num_limbs, int limb_bits, const int32_t* xs,
                               int32_t* out, int64_t n, const uint32_t* wide,
                               void* stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> K;
    std::memcpy(&K, wide, sizeof(K));
    encode_kernel<L, W><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        xs, out, n, K);
  });
  return static_cast<int>(cudaGetLastError());
}

// xs, ys: (L, n) limbs of limb_bytes (2 or 4) each, row i of xs at
// xs + i ldx elements (ys: ldy); rows: the (n, 2L) int16 table, n >= 1.
extern "C" int msm_encode_rows(int num_limbs, int limb_bits, const void* xs,
                               const void* ys, int limb_bytes, int64_t ldx,
                               int64_t ldy, int16_t* rows, int64_t n,
                               const uint32_t* wide, void* stream) {
  if ((limb_bytes != 2 && limb_bytes != 4) || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((n + kRowsThreads - 1) / kRowsThreads);
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> K;
    std::memcpy(&K, wide, sizeof(K));
    encode_rows_kernel<L, W>
        <<<blocks, kRowsThreads, 0, (cudaStream_t)stream>>>(
            xs, ys, limb_bytes, ldx, ldy, rows, n, K);
  });
  return static_cast<int>(cudaGetLastError());
}
