// Stage 1 of the parallel bucket-points reduction (cuZK Alg. 4): the m/g
// running sums of every bucket slice.
//
// Replaces tpu_msm/cuzk/kernels.py `_pbpr_kernel` / `pbpr_stage1`.
// Bound on the H100: operations. Per window 2 B complete adds (12
// Montgomery multiplies each) against 3 L elements read per bucket and
// 6 L words written per slice.
// Design: one thread per (window w, slice t), Wp * T threads in all,
// spread over as many blocks as that takes (no block is tied to a
// window, and nothing crosses threads, so there is no device scratch
// and no barrier after the constants). The thread walks its Bt = B / T
// buckets t*Bt + Bt-1-j, j = 0 .. Bt-1, from the top down, with
// m += bucket; g += m held in registers or local memory, both starting
// at infinity: the first loop of pbpr_full.cu without what follows it,
// the same additions in the same order as the plain version.
// Neighbouring threads read buckets Bt elements apart, so the loads are
// not coalesced; the adds dominate.
// Layouts: buckets (3, L, Wp, B) int16 or int32; m, g (3, L, Wp, T) int32.
#include "field.cuh"

namespace {

template <int L, int W, typename Tin>
__global__ void __launch_bounds__(128)
stage1_kernel(const Tin* __restrict__ buckets, int32_t* __restrict__ m_out,
              int32_t* __restrict__ g_out, int Wp, int B, int T,
              const int32_t* __restrict__ kc) {
  __shared__ msm::Consts<L> K;
  msm::load_consts<L>(K, kc);
  using F = msm::Field<L, W>;
  const int64_t lanes = (int64_t)Wp * T;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lanes) return;
  const int w = static_cast<int>(idx / T);
  const int t = static_cast<int>(idx % T);
  const int Bt = B / T;
  const int64_t bstride = (int64_t)Wp * B;
  const int64_t top = (int64_t)w * B + (int64_t)t * Bt + Bt - 1;
  msm::Pt<L> m, g, s;
  F::set_inf(m, K);
  F::set_inf(g, K);
  for (int j = 0; j < Bt; j++) {
    msm::load_pt<L>(buckets, bstride, top - j, s);
    F::padd(m, s, m, K);
    F::padd(g, m, g, K);
  }
  msm::store_pt<L>(m_out, lanes, idx, m);
  msm::store_pt<L>(g_out, lanes, idx, g);
}

template <int L, int W, typename Tin>
void launch(const void* buckets, int32_t* m_out, int32_t* g_out, int Wp, int B,
            int T, const int32_t* consts, cudaStream_t stream) {
  const int threads = 128;
  const int64_t lanes = (int64_t)Wp * T;
  const unsigned blocks = static_cast<unsigned>((lanes + threads - 1) / threads);
  stage1_kernel<L, W, Tin><<<blocks, threads, 0, stream>>>(
      static_cast<const Tin*>(buckets), m_out, g_out, Wp, B, T, consts);
}

}  // namespace

// in_bits: 16 or 32, the width of the bucket elements.
extern "C" int msm_pbpr_stage1(int num_limbs, int limb_bits, int in_bits,
                               const void* buckets, int32_t* m_out,
                               int32_t* g_out, int Wp, int B, int T,
                               const int32_t* consts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    if (in_bits == 16)
      launch<L, W, int16_t>(buckets, m_out, g_out, Wp, B, T, consts, s);
    else if (in_bits == 32)
      launch<L, W, int32_t>(buckets, m_out, g_out, Wp, B, T, consts, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaGetLastError());
}
