// Stage 1 of the parallel bucket-points reduction (cuZK Alg. 4): the m/g
// running sums of every bucket slice.
//
// Replaces tpu_msm/cuzk/kernels.py `_pbpr_kernel` / `pbpr_stage1`.
// What it computes, in the plain version's order: for each lane (window
// w, slice t), the Bt = B / T buckets t Bt + Bt - 1 - j, j = 0 .. Bt - 1,
// from the top down, with m += bucket; g += m, both from infinity.
// Bound on the H100: operations in total (per window 2 B complete adds of
// 12 word-wide Montgomery multiplies, mul_wide.cuh, against 3 L elements
// read per bucket and 6 L words written per slice), but depth at the
// shapes the reduction gives it: 8,192 lanes at 2^20 (Wp = 16, T = 512),
// each a chain of 2 Bt dependent adds. With one thread a lane and the
// points in the thread (the kernel this replaces) each link of that chain
// was one thread's twelve multiplies one after another.
// Design, the stage 1 of pbpr_full.cu on padd_lane.cuh's add: a lane is
// 2 kAddG = 12 threads of one warp, 6 for the m add and 6 for the g add,
// 2 lanes a warp (6 threads a lane, 3 a chain, 5 lanes a warp, was built
// and timed too: level at the 2^16 shapes and 1.3 times as slow at 2^20,
// with fewer warps an SM to hide the multiply's latency; PERF.md). The g
// add of step j needs m_j and g_(j-1); the m add of step j + 1 needs only
// m_j: so both run at once, and the lane is Bt + 1 steps deep, not 2 Bt.
// Each add runs padd_lane.cuh's four phases with a warp barrier after
// each (thread g of a chain takes product g of a level). The
// lane's state lives in shared memory (m, g, two bucket buffers, and the
// scratch of the two adds: 36 L words, an odd stride), so the threads'
// stack frames stay empty. The next bucket comes in by cp.async while a
// step computes. Neighbouring lanes read buckets Bt apart: not
// coalesced, and a small part of a step. An int32 element is fetched as
// its own word, an int16 one as the 4-byte word that holds it (the
// wrapper checks the alignment and that 3 L Wp B is even, so the last
// word lies inside the tensor) and unpacked in place. Element indices
// are 32-bit (the entry refuses 3 L Wp B >= 2^31): with 64-bit ones the
// loop's state no longer fit beside the multiply in 64 registers, and
// spilled. A block is 1 to
// kMaxWarps warps (cuzk/kernels.py `pbpr_stage1_geometry`, which keeps
// every lane resident at once where the card holds them); at the end it
// stores m and g row by row through shared memory, coalesced, as int32.
// Layouts: buckets (3, L, Wp, B) int16 or int32; m, g (3, L, Wp, T) int32.
#include "padd_lane.cuh"

#include <cstring>

namespace {

constexpr int kMaxWarps = 4;   // warps a block at most; the wrapper picks
// Registers a thread at most: the geometry's residency counts on it
// (cuzk/kernels.py PBPR_STAGE1_REGISTERS), and __launch_bounds__ holds
// ptxas to it.
constexpr int kRegisters = 64;
constexpr int kLaneThreads = 2 * msm::kAddG;   // the m add's, the g add's
constexpr int kLanesPerWarp = 32 / kLaneThreads;

__device__ __forceinline__ void cp_async(int32_t* smem, const int32_t* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A lane's words: m, g, the two buffers of bucket words, and the scratch
// of the m add and of the g add.
template <int L>
struct LaneMem {
  static constexpr int M = 0, G = 3 * L, BK = 6 * L;
  static constexpr int SM = 12 * L, SG = SM + msm::AddScratch<L>::WORDS;
  static constexpr int WORDS = SG + msm::AddScratch<L>::WORDS;   // 36 L
  static constexpr int STRIDE = WORDS | 1;   // odd: lanes on distinct banks
};

// Bucket element e: the word fetched for it, and its value from that word.
template <typename Tin>
struct Fetch;

template <>
struct Fetch<int32_t> {
  static __device__ __forceinline__ const int32_t* word(const int32_t* b,
                                                        int e) {
    return b + e;
  }
  static __device__ __forceinline__ int32_t value(int32_t v, int) {
    return v;
  }
};

template <>
struct Fetch<int16_t> {
  static __device__ __forceinline__ const int32_t* word(const int16_t* b,
                                                        int e) {
    return reinterpret_cast<const int32_t*>(b) + (e >> 1);
  }
  static __device__ __forceinline__ int32_t value(int32_t v, int e) {
    return (e & 1) ? static_cast<int16_t>(v >> 16) : static_cast<int16_t>(v);
  }
};

template <int L, int W, typename Tin>
__global__ void __launch_bounds__(kMaxWarps * 32,
                                  65536 / (kMaxWarps * 32 * kRegisters))
stage1_kernel(const Tin* __restrict__ buckets, int32_t* __restrict__ m_out,
              int32_t* __restrict__ g_out, int Wp, int B, int T,
              const int32_t* __restrict__ kc,
              const msm::WideConsts<L, W> KW) {
  constexpr int Q = kLaneThreads;
  constexpr int LPW = kLanesPerWarp;
  using LM = LaneMem<L>;
  using Ph = msm::Phases<L, W>;
  using Fe = Fetch<Tin>;
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  extern __shared__ int32_t lanes[];     // [lanes a block][STRIDE]
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);            // ends in __syncthreads

  const int64_t nlanes = (int64_t)Wp * T;
  const int lpb = (blockDim.x >> 5) * LPW;
  const int64_t f0 = (int64_t)blockIdx.x * lpb;
  const int nl = static_cast<int>(nlanes - f0 < lpb ? nlanes - f0 : lpb);
  const int lw = (threadIdx.x & 31) / Q;   // lane within the warp
  const int q = (threadIdx.x & 31) % Q;    // thread within the lane
  const int l = (threadIdx.x >> 5) * LPW + lw;
  const bool active = lw < LPW && l < nl;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (active) {
    int32_t* lm = lanes + l * LM::STRIDE;
    const int f = static_cast<int>(f0) + l;
    const int w = f / T, t = f % T;
    const int Bt = B / T;
    const int plane = Wp * B;
    const int top = w * B + t * Bt + Bt - 1;
    for (int i = q; i < L; i += Q) {       // m = g = infinity
      lm[LM::M + i] = lm[LM::G + i] = 0;
      lm[LM::M + L + i] = lm[LM::G + L + i] = K.one[i];
      lm[LM::M + 2 * L + i] = lm[LM::G + 2 * L + i] = 0;
    }
    // element k of bucket top - j is buckets[k * plane + top - j]; this
    // thread fetches and unpacks k = q, q + Q, ...
    for (int k = q; k < 3 * L; k += Q)
      cp_async(lm + LM::BK + k, Fe::word(buckets, k * plane + top));
    const int chain = q / msm::kAddG;      // 0: the m add, 1: the g add
    const int g = q % msm::kAddG;
    int32_t* sc = lm + (chain == 0 ? LM::SM : LM::SG);
    int32_t* acc = lm + (chain == 0 ? LM::M : LM::G);
    for (int j = 0; j <= Bt; j++) {
      int32_t* bk = lm + LM::BK + (j & 1) * 3 * L;
      if (j < Bt) {
        cp_async_wait();
        for (int k = q; k < 3 * L; k += Q)
          bk[k] = Fe::value(bk[k], k * plane + top - j);
        if (j + 1 < Bt) {
          int32_t* nxt = lm + LM::BK + ((j + 1) & 1) * 3 * L;
          for (int k = q; k < 3 * L; k += Q)
            cp_async(nxt + k, Fe::word(buckets, k * plane + top - j - 1));
        }
      }
      __syncwarp(mask);
      // the m add of step j (m_j = m_(j-1) + bucket_j) and the g add of
      // step j - 1 (g_(j-1) = g_(j-2) + m_(j-1)) read m before either
      // writes
      const bool on = chain == 0 ? j < Bt : j > 0;
      const int32_t* p2 = chain == 0 ? bk : lm + LM::M;
      if (on) Ph::level1(acc, p2, sc, g, KWs);
      __syncwarp(mask);
      if (on) Ph::mid(sc, g, K);
      __syncwarp(mask);
      if (on) Ph::level2(sc, g, KWs);
      __syncwarp(mask);
      if (on) Ph::finish(sc, g, acc, K);
    }
  }
  __syncthreads();

  // m then g, row by row: element (row, lane ll) <-> thread ll + lpb *
  // (row mod rstep); m and g are a lane's first 6 L words
  const int rstep = blockDim.x / lpb;
  const int ll = threadIdx.x % lpb;
  const int r0 = threadIdx.x / lpb;
  if (r0 < rstep && ll < nl) {
    for (int row = r0; row < 6 * L; row += rstep) {
      int32_t* out = row < 3 * L ? m_out : g_out;
      out[(int64_t)(row % (3 * L)) * nlanes + f0 + ll] =
          lanes[ll * LM::STRIDE + row];
    }
  }
}

template <int L, int W, typename Tin>
int launch(const void* buckets, int32_t* m_out, int32_t* g_out, int Wp,
           int B, int T, int warps, int blocks, const int32_t* consts,
           const msm::WideConsts<L, W>& KW, cudaStream_t stream) {
  const size_t smem = (size_t)warps * kLanesPerWarp * LaneMem<L>::STRIDE *
                      sizeof(int32_t);
  const cudaError_t rc = cudaFuncSetAttribute(
      stage1_kernel<L, W, Tin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  stage1_kernel<L, W, Tin>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
          static_cast<const Tin*>(buckets), m_out, g_out, Wp, B, T, consts,
          KW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_bits: 16 or 32, the width of the bucket elements (16: 4-byte aligned
// and 3 L Wp B even); 3 L Wp B < 2^31; threads_per_chain must be kAddG
// (the wrapper's lane count rests on it); warps a block (1 to kMaxWarps)
// and blocks from cuzk/kernels.py pbpr_stage1_geometry, which must cover
// the Wp T lanes; wide: host memory, the words of msm::WideConsts<L, W>.
extern "C" int msm_pbpr_stage1(int num_limbs, int limb_bits, int in_bits,
                               const void* buckets, int32_t* m_out,
                               int32_t* g_out, int Wp, int B, int T,
                               int threads_per_chain, int warps, int blocks,
                               const int32_t* consts, const uint32_t* wide,
                               void* stream) {
  if (Wp < 1 || B < 1 || T < 1 || B % T || 3LL * num_limbs * Wp * B >> 31 ||
      threads_per_chain != msm::kAddG || warps < 1 || warps > kMaxWarps ||
      blocks < 1 || (int64_t)blocks * warps * kLanesPerWarp < (int64_t)Wp * T ||
      (in_bits != 16 && in_bits != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    if (in_bits == 16 && (3LL * L * Wp * B) % 2)
      return static_cast<int>(cudaErrorInvalidValue);
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    return in_bits == 16
               ? launch<L, W, int16_t>(buckets, m_out, g_out, Wp, B, T, warps,
                                       blocks, consts, KW, s)
               : launch<L, W, int32_t>(buckets, m_out, g_out, Wp, B, T, warps,
                                       blocks, consts, KW, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
