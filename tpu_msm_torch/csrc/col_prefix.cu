// Exclusive prefix of the C column totals of each window.
//
// Replaces tpu_msm/cuzk/kernels.py `_colprefix_kernel` / `col_prefix`.
// Bound on the H100: depth, not operations. The function is log2 C
// Hillis-Steele levels of Wg * C independent complete adds; at the
// shapes the MSM gives it (8192 columns) one level is far too little
// work to fill 132 SMs, so the least time is levels x the latency of ONE
// complete add on a warp that has its scheduler to itself, plus what it
// costs to hand every column's point to another thread between levels.
// Design: one thread per (window, column), spread over the whole card
// (blocks of 64 threads, so 8192 columns are 256 warps on 128 SMs), each
// holding its running point for the whole kernel. A level is then one
// padd in depth. It runs the TPU kernel's levels in the same order, so
// the result is bit-identical: the exclusive shift that brings in
// infinity (folded into level 0, which reads the input at c - 1 and
// c - 2), then shifts 1, 2, 4, ... below C, each combined by
// padd(v[c], v[c - k]) with infinity for c < k. Between levels a thread
// needs the point of another thread, in general of another block: every
// level writes its points as int16 (exact, see store_pt) to an exchange
// array in device memory, which stays in the L2, and a grid-wide barrier
// (cooperative launch, cooperative_groups grid sync) separates the
// levels. The levels alternate between the scratch array and the output
// array so that the last level lands in the output; exchange loads go
// past the L1 (__ldcg), since another SM wrote them.
// The cooperative launch needs every block resident at once. The wrapper
// sizes the grid from the occupancy the launcher reports
// (msm_col_prefix_limits); with more columns than resident threads each
// thread strides over several columns and keeps them in the exchange
// array. A launch the device cannot make cooperatively returns its
// cudaError_t and the wrapper raises: there is no second path.
// Not built: shuffle and shared-memory exchange for shifts below the warp
// and block size (they would save six of 13 grid barriers at C = 8192),
// and one launch per level in place of the grid barrier.
// Layouts: in/out/scratch (3, L, Wg, C) int16.
#include <cooperative_groups.h>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;

// Column idx - off of the level array `src`, or infinity where the shift
// leaves the window (c < off).
template <int L, int W>
__device__ __forceinline__ void fetch(const int16_t* src, int64_t plane,
                                      int64_t idx, int c, int off,
                                      msm::Pt<L>& p, const msm::Consts<L>& K) {
  if (c < off) {
    msm::Field<L, W>::set_inf(p, K);
    return;
  }
  const int16_t* s = src + idx - off;
#pragma unroll
  for (int i = 0; i < L; i++) {
    p.x[i] = __ldcg(s + (int64_t)i * plane);
    p.y[i] = __ldcg(s + (int64_t)(L + i) * plane);
    p.z[i] = __ldcg(s + (int64_t)(2 * L + i) * plane);
  }
}

template <int L, int W>
__global__ void __launch_bounds__(kThreads)
colprefix_kernel(const int16_t* in, int16_t* out, int16_t* scratch, int Wg,
                 int C, int levels, const int32_t* __restrict__ kc) {
  __shared__ msm::Consts<L> K;
  msm::load_consts<L>(K, kc);
  cg::grid_group grid = cg::this_grid();
  const int64_t plane = (int64_t)Wg * C;       // one (coord, limb) plane
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool own_one = plane <= nthreads;      // the point stays in `cur`
  msm::Pt<L> cur, sh;
  const int16_t* src = in;
  for (int lv = 0; lv < levels; lv++) {
    const int k = 1 << lv;
    int16_t* dst = ((levels - 1 - lv) & 1) ? scratch : out;
    for (int64_t idx = tid; idx < plane; idx += nthreads) {
      const int c = static_cast<int>(idx % C);
      if (lv == 0) {
        // v[c] = in[c - 1], v[c - 1] = in[c - 2]
        fetch<L, W>(in, plane, idx, c, 1, cur, K);
        fetch<L, W>(in, plane, idx, c, 2, sh, K);
      } else {
        if (!own_one) fetch<L, W>(src, plane, idx, c, 0, cur, K);
        fetch<L, W>(src, plane, idx, c, k, sh, K);
      }
      msm::Field<L, W>::padd(cur, sh, cur, K);
      msm::store_pt<L>(dst, plane, idx, cur);
    }
    src = dst;
    if (lv + 1 < levels) grid.sync();
  }
}

}  // namespace

// The launch limits of the kernel on the current device: resident blocks
// of kThreads threads per SM, the SM count, and the block size.
extern "C" int msm_col_prefix_limits(int num_limbs, int limb_bits,
                                     int* blocks_per_sm, int* sms,
                                     int* threads) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *threads = kThreads;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits,
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, colprefix_kernel<L, W>, kThreads, 0));
  return static_cast<int>(rc);
}

extern "C" int msm_col_prefix(int num_limbs, int limb_bits, const int16_t* in,
                              int16_t* out, int16_t* scratch, int Wg, int C,
                              int levels, int blocks, const int32_t* consts,
                              void* stream) {
  void* args[] = {&in, &out, &scratch, &Wg, &C, &levels, &consts};
  cudaError_t rc = cudaSuccess;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits,
      rc = cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(&colprefix_kernel<L, W>),
          dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0,
          (cudaStream_t)stream));
  return static_cast<int>(rc);
}
