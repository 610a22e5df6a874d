// Batched complete projective doubling.
//
// Replaces tpu_msm/cuzk/kernels.py `_pdbl_kernel` / `pdbl_batch`.
// Bound on the H100: operations. One complete doubling is 9 Montgomery
// multiplies (about 2 L^2 int32 multiply-adds each) against 3 L words in
// and 3 L words out per lane.
// Design: one thread per lane, the point's three coordinates in
// registers, int32 in and out as the TPU kernel. Layout: p, out
// (3, L, F), lane-major and coalesced.
#include "field.cuh"

namespace {

template <int L, int W>
__global__ void __launch_bounds__(128)
pdbl_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ out,
            int64_t F, const int32_t* __restrict__ kc) {
  __shared__ msm::Consts<L> K;
  msm::load_consts<L>(K, kc);
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  msm::Pt<L> a;
  msm::load_pt<L>(p, F, f, a);
  msm::Field<L, W>::pdbl(a, a, K);
  msm::store_pt<L>(out, F, f, a);
}

}  // namespace

extern "C" int msm_pdbl_batch(int num_limbs, int limb_bits, const int32_t* p,
                              int32_t* out, int64_t F, const int32_t* consts,
                              void* stream) {
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((F + threads - 1) / threads);
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits,
      pdbl_kernel<L, W><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          p, out, F, consts));
  return static_cast<int>(cudaGetLastError());
}
