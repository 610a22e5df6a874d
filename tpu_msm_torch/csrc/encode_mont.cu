// Montgomery encode: x -> x * R mod p, one thread per lane.
//
// Replaces tpu_msm/cuzk/kernels.py `_encode_kernel` / `encode_mont`.
// Bound on the H100: bytes. Each lane reads L int32 limbs and writes L,
// 8 L bytes, against one word-wide Montgomery multiply by R^2 (315
// int32 multiply and multiply-add halves at L = 22, mul_wide.cuh).
// Design: one thread per lane n (2^20 lanes fill the card), limbs in
// registers; lane-major loads and stores (limb i of neighbouring lanes
// is contiguous) are coalesced. The multiply is mul_wide.cuh's, inlined
// at its one call site, with its constants in the kernel parameter
// struct: p, n0 and R^2 come as words from the constant bank, and R^2
// is not rippled or packed per call. Bit-identical to rows.py to_mont_rows.
#include "mul_wide.cuh"

#include <cstring>

namespace {

template <int L, int W>
__global__ void __launch_bounds__(256)
encode_kernel(const int32_t* __restrict__ xs, int32_t* __restrict__ out,
              int64_t n, const msm::WideConsts<L, W> K) {
  using M = msm::MulWide<L, W>;
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  int32_t a[L];
#pragma unroll
  for (int i = 0; i < L; i++) a[i] = xs[(int64_t)i * n + f];
  uint32_t aw[M::N], rw[M::N];
  M::pack(a, aw);
  struct {
    const msm::WideConsts<L, W>& K;
    __device__ __forceinline__ uint32_t next(int i) const { return K.r2[i]; }
  } r2{K};
  M::mont(aw, r2, rw, K);
  M::unpack(rw, a);
#pragma unroll
  for (int i = 0; i < L; i++) out[(int64_t)i * n + f] = a[i];
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
