// The points' (n, 2L) int16 row table, as stage 1 writes it: row i is the
// L Montgomery x limbs, then the L y limbs, of point i; 4 L bytes, L
// int32 words, a row. The kernels that write it (encode_rows in
// encode_mont.cu, glv_apply.cu) compute one point a thread, but a
// thread's row is 4 L bytes away from its neighbour's: stored from
// registers, a warp's stores would land 88 B apart at L = 22. So a block
// builds its rows in shared memory and then copies them out as one
// contiguous run of words, neighbouring threads on neighbouring words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace msm {

// Copy `words` int32 words from shared memory to device memory with the
// block's threads, as 16-byte vectors where both ends allow it.
__device__ __forceinline__ void block_copy_words(int32_t* dst,
                                                 const int32_t* src,
                                                 int words) {
  const int t = threadIdx.x, step = blockDim.x;
  if ((words & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = t; i < words / 4; i += step) d[i] = s[i];
  } else {
    for (int i = t; i < words; i += step) dst[i] = src[i];
  }
}

// Element i of a lane-major array of limbs or halfwords whose width is
// given at run time (2 or 4 bytes): int16 and int32 limbs (canonical,
// below 2^13, so either width reads the same value), uint16 and int32
// halfwords (below 2^16).
__device__ __forceinline__ int32_t load_limb(const void* p, int bytes,
                                             int64_t i) {
  return bytes == 2 ? static_cast<int32_t>(static_cast<const int16_t*>(p)[i])
                    : static_cast<const int32_t*>(p)[i];
}

__device__ __forceinline__ uint32_t load_halfword(const void* p, int bytes,
                                                  int64_t i) {
  return bytes == 2 ? static_cast<uint32_t>(static_cast<const uint16_t*>(p)[i])
                    : static_cast<uint32_t>(static_cast<const int32_t*>(p)[i]);
}

}  // namespace msm
