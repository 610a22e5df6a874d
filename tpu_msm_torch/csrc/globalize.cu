// Full-stream globalisation G = T + S: one complete add per stream
// position, the per-lane column prefix S broadcast over the rows.
//
// Replaces tpu_msm/cuzk/kernels.py `_globalize_kernel` / `globalize`.
// Bound on the H100: operations. One complete add (12 Montgomery
// multiplies) per position against 3 L elements read from T and 3 L
// written; S is R times smaller and stays in cache.
// Design: one thread per stream position (r, f). It reads T[:, :, r, f]
// and S[:, :, f] and writes their sum; int16 or int32 inputs widen on
// load and the result leaves in the requested dtype, as padd_batch.cu.
// The TPU kernel's (8, F8) block layout and its aliasing of the output
// onto T are not carried over: the layout is the scan's own, and the
// wrapper allocates the output.
// Layouts: T, out (3, L, R, F); S (3, L, F); lane-major and coalesced.
#include "field.cuh"

namespace {

template <int L, int W, typename Tin, typename Tout>
__global__ void __launch_bounds__(128)
globalize_kernel(const Tin* __restrict__ tbuf, const Tin* __restrict__ sbuf,
                 Tout* __restrict__ out, int64_t n, int64_t F,
                 const int32_t* __restrict__ kc) {
  __shared__ msm::Consts<L> K;
  msm::load_consts<L>(K, kc);
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  msm::Pt<L> a, b;
  msm::load_pt<L>(tbuf, n, idx, a);
  msm::load_pt<L>(sbuf, F, idx % F, b);
  msm::Field<L, W>::padd(a, b, a, K);
  msm::store_pt<L>(out, n, idx, a);
}

template <int L, int W, typename Tin, typename Tout>
void launch(const void* tbuf, const void* sbuf, void* out, int64_t n, int64_t F,
            const int32_t* consts, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  globalize_kernel<L, W, Tin, Tout><<<blocks, threads, 0, stream>>>(
      static_cast<const Tin*>(tbuf), static_cast<const Tin*>(sbuf),
      static_cast<Tout*>(out), n, F, consts);
}

}  // namespace

// n = R * F stream positions; in_bits / out_bits: 16 or 32.
extern "C" int msm_globalize(int num_limbs, int limb_bits, int in_bits,
                             int out_bits, const void* tbuf, const void* sbuf,
                             void* out, int64_t n, int64_t F,
                             const int32_t* consts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    if (in_bits == 16 && out_bits == 16)
      launch<L, W, int16_t, int16_t>(tbuf, sbuf, out, n, F, consts, s);
    else if (in_bits == 16 && out_bits == 32)
      launch<L, W, int16_t, int32_t>(tbuf, sbuf, out, n, F, consts, s);
    else if (in_bits == 32 && out_bits == 16)
      launch<L, W, int32_t, int16_t>(tbuf, sbuf, out, n, F, consts, s);
    else if (in_bits == 32 && out_bits == 32)
      launch<L, W, int32_t, int32_t>(tbuf, sbuf, out, n, F, consts, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  });
  return static_cast<int>(cudaGetLastError());
}
