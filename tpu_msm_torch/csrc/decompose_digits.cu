// Signed-digit decomposition of scalars, one thread per scalar.
//
// Replaces tpu_msm/cuzk/kernels.py `_digits_kernel` / `decompose_digits`,
// and XLA's part around it in the JAX package's stage 1: the cast of the
// halfwords to the kernel's int32 and the zero digit rows that pad the
// windows to Wp (pipeline_pallas.py:174-176).
// Bound on the H100: bytes. A scalar reads the halfwords its W windows
// touch (uint16 or int32, as staged) and writes Wp int16 digits with a
// handful of shifts and masks per window.
// Design: one thread walks the W windows of its scalar with the carry in
// a register, exactly as the TPU kernel's unrolled chain, and stores the
// int16 digits directly (|d| <= 2^(s-1) fits), so no int32 digit buffer
// exists; rows W to Wp - 1 are written as zeros by the same thread. The
// halfwords are read in place, either width, any row stride (a pass's
// slice of a larger input needs no copy). Lane-major arrays keep loads
// and stores coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
digits_kernel(const T* __restrict__ hw, int64_t ld, int16_t* __restrict__ out,
              int H, int64_t n, int s, int W, int Wp) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int32_t mask = (1 << s) - 1;
  const int32_t full = 1 << s;
  const int32_t half = 1 << (s - 1);
  int32_t carry = 0;
  for (int w = 0; w < W; w++) {
    const int bit = w * s;
    const int i = bit >> 4, off = bit & 15;
    int32_t val = static_cast<int32_t>(hw[(int64_t)i * ld + f]);
    if (off) {
      val >>= off;
      if (i + 1 < H)
        val |= static_cast<int32_t>(hw[(int64_t)(i + 1) * ld + f])
               << (16 - off);
    }
    val = (val & mask) + carry;
    const bool ge = val >= half;
    out[(int64_t)w * n + f] = static_cast<int16_t>(val - (ge ? full : 0));
    carry = ge ? 1 : 0;
  }
  for (int w = W; w < Wp; w++) out[(int64_t)w * n + f] = 0;
}

}  // namespace

// hw: (H, n) halfwords of hw_bytes each (2: uint16, 4: int32), row i at
// hw + i ld elements; out: (Wp, n) int16, Wp >= W.
extern "C" int msm_decompose_digits(const void* hw, int hw_bytes, int64_t ld,
                                    int16_t* out, int H, int64_t n, int s,
                                    int W, int Wp, void* stream) {
  if ((hw_bytes != 2 && hw_bytes != 4) || Wp < W)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const auto st = (cudaStream_t)stream;
  if (hw_bytes == 2)
    digits_kernel<uint16_t><<<blocks, threads, 0, st>>>(
        static_cast<const uint16_t*>(hw), ld, out, H, n, s, W, Wp);
  else
    digits_kernel<int32_t><<<blocks, threads, 0, st>>>(
        static_cast<const int32_t*>(hw), ld, out, H, n, s, W, Wp);
  return static_cast<int>(cudaGetLastError());
}
