// Batched complete projective add; psub_batch is the same kernel with q
// negated as it loads.
//
// Replaces tpu_msm/cuzk/kernels.py `_padd_kernel` / `padd_batch`, and
// `psub_batch` (its `pneg_stacked` copy of q included).
// Bound on the H100: operations at the main path's widths (32,769
// lanes at 2^20): 12 word-wide Montgomery multiplies (mul_wide.cuh, 315
// int32 multiply and multiply-add halves each at L = 22) against 6 L
// elements in and 3 L out per lane. With one thread a lane and the
// points in the thread (the kernel this replaces) a launch waited on one
// thread's chain of 12 dependent multiplies with 8 warps an SM.
// Design: kG = 6 threads of one warp share a lane, so a thread makes one
// multiply a level (2 threads a lane, three multiplies each, were timed
// too: slower with 32,769 lanes, level with 16,388; PERF.md). The block,
// of 1 to 4 warps (cuzk/kernels.py `padd_batch_geometry`), first loads its
// lanes' limbs into shared memory, each (coordinate, limb) row of its
// lanes contiguous in device memory, so the loads are coalesced (plain
// loads: an int16 element is narrower than cp.async's 4 bytes, and
// nothing overlaps them in a one-shot launch); q.y
// becomes 4p - y there for psub_batch (`negate`), in q's dtype, as
// pneg_stacked computes it. The complete add (RCB Algorithm 7,
// Field::padd) runs in four phases on the lane's shared memory: the six
// independent products of level 1, the adds between the levels, the six
// products of level 2, the sum; thread g takes products g, g + kG, ...
// of a level (one) and limbs g, g + kG, ... of the adds, with a warp
// barrier after
// each phase (the order of pbpr_full.cu's Shared::padd_level1/mid/
// level2/finish, and the same operands in the same order, so the result
// is bit-identical to Field::padd and to padd_rows). The sums go back to
// shared memory, and the block stores them row by row in the requested
// dtype (plain truncating casts, exact by the limb bound), coalesced.
// Layout: p, q, out (3, L, F), lane-major.
#include "mul_wide.cuh"

#include <cstring>

namespace {

constexpr int kMaxWarps = 4;   // warps a block at most; the wrapper picks
constexpr int kG = 6;          // threads a lane, one product of a level each
constexpr int kLanesPerWarp = 32 / kG;   // the last two threads idle

// A lane's int32 words in shared memory, which its kG threads share: p1,
// the six products of a level (P) and the six operands of level 2 (T).
// p2 sits in T[0, 3 L) until level 1 has read it, the sum in p1's words
// until the block stores it.
template <int L>
struct LaneMem {
  static constexpr int P1 = 0, P = 3 * L, T = 9 * L, WORDS = 15 * L;
  static constexpr int STRIDE = WORDS | 1;   // odd: lanes on distinct banks
};

template <int L, int W>
struct Phases {
  using M = LaneMem<L>;
  using WC = msm::WideConsts<L, W>;

  // x1 x2, y1 y2, z1 z2, (x1 + y1)(x2 + y2), (y1 + z1)(y2 + z2),
  // (x1 + z1)(x2 + z2) into P, product g, g + kG, ... by thread g; the
  // thread of a product of sums writes the two sums where the product goes
  // and where level 2's operand of the same index goes, which no other
  // product of the level reads.
  static __device__ __forceinline__ void level1(int32_t* m, int g,
                                                const WC& KW) {
    const int32_t* p1 = m + M::P1;
    const int32_t* p2 = m + M::T;
    for (int j = g; j < 6; j += kG) {
      int32_t* o = m + M::P + j * L;
      const int32_t* a = p1 + j * L;
      const int32_t* b = p2 + j * L;
      if (j >= 3) {
        const int u = j == 4 ? L : 0;          // x + y, y + z, x + z
        const int v = j == 3 ? L : 2 * L;
        int32_t* t = m + M::T + j * L;
        for (int i = 0; i < L; i++) {
          o[i] = p1[u + i] + p1[v + i];
          t[i] = p2[u + i] + p2[v + i];
        }
        a = o;
        b = t;
      }
      msm::mul_wide<L, W>(a, b, o, KW);
    }
  }

  // T = t3 t4 t1 yz z3 t0 from the products.
  static __device__ __forceinline__ void mid(int32_t* m, int g,
                                             const msm::Consts<L>& K) {
    for (int i = g; i < L; i += kG) {
      const int32_t* P = m + M::P + i;
      int32_t* T = m + M::T + i;
      const int32_t m0 = P[0], m1 = P[L], m2 = P[2 * L];
      const int32_t m3 = P[3 * L], m4 = P[4 * L], m5 = P[5 * L];
      const int32_t t2 = m2 * K.b3;
      T[0] = m3 - (m0 + m1) + K.kp4[i];                   // t3
      T[L] = m4 - (m1 + m2) + K.kp4[i];                   // t4
      T[2 * L] = m1 - t2 + K.kpb3x2[i];                   // t1
      T[3 * L] = (m5 - (m0 + m2) + K.kp4[i]) * K.b3;      // yz
      T[4 * L] = m1 + t2;                                 // z3
      T[5 * L] = m0 * 3;                                  // t0
    }
  }

  // t3 t1, t4 yz, t1 z3, yz t0, z3 t4, t0 t3 into P, as level 1 shares
  // them out.
  static __device__ __forceinline__ void level2(int32_t* m, int g,
                                                const WC& KW) {
    for (int j = g; j < 6; j += kG) {
      const int b = j < 4 ? j + 2 : 5 - j;   // T index of the second operand
      msm::mul_wide<L, W>(m + M::T + j * L, m + M::T + b * L,
                          m + M::P + j * L, KW);
    }
  }

  // (x3, y3, z3) into p1's words.
  static __device__ __forceinline__ void finish(int32_t* m, int g,
                                                const msm::Consts<L>& K) {
    for (int i = g; i < L; i += kG) {
      const int32_t* P = m + M::P + i;
      m[M::P1 + i] = P[0] - P[L] + K.kp2[i];
      m[M::P1 + L + i] = P[2 * L] + P[3 * L];
      m[M::P1 + 2 * L + i] = P[4 * L] + P[5 * L];
    }
  }
};

template <int L, int W, typename Tin, typename Tout>
__global__ void __launch_bounds__(kMaxWarps * 32)
padd_kernel(const Tin* __restrict__ p, const Tin* __restrict__ q,
            Tout* __restrict__ out, int64_t F, int negate,
            const int32_t* __restrict__ kc, const msm::WideConsts<L, W> KW) {
  constexpr int LPW = kLanesPerWarp;
  using M = LaneMem<L>;
  using Ph = Phases<L, W>;
  __shared__ msm::Consts<L> K;
  __shared__ msm::WideConsts<L, W> KWs;
  extern __shared__ int32_t lanes[];     // [lanes a block][STRIDE]
  if (threadIdx.x == 0) KWs = KW;
  msm::load_consts<L>(K, kc);            // ends in __syncthreads

  const int lpb = (blockDim.x >> 5) * LPW;
  const int64_t f0 = (int64_t)blockIdx.x * lpb;
  const int nl = static_cast<int>(F - f0 < lpb ? F - f0 : lpb);
  // element (row, lane l) <-> thread l + lpb * (row mod rstep)
  const int rstep = blockDim.x / lpb;
  const int ll = threadIdx.x % lpb;
  const int r0 = threadIdx.x / lpb;
  const bool mover = r0 < rstep && ll < nl;
  if (mover) {
    for (int row = r0; row < 3 * L; row += rstep) {
      const int64_t src = (int64_t)row * F + f0 + ll;
      int32_t* m = lanes + ll * M::STRIDE;
      m[M::P1 + row] = static_cast<int32_t>(p[src]);
      Tin y = q[src];
      if (negate && row >= L && row < 2 * L)   // y -> 4p - y in Tin
        y = static_cast<Tin>(static_cast<uint32_t>(K.kp4[row - L]) -
                             static_cast<uint32_t>(static_cast<int32_t>(y)));
      m[M::T + row] = static_cast<int32_t>(y);
    }
  }
  __syncthreads();

  const int lw = (threadIdx.x & 31) / kG;   // lane within the warp
  const int g = (threadIdx.x & 31) % kG;    // thread within the lane
  const int l = (threadIdx.x >> 5) * LPW + lw;
  const bool active = lw < LPW && l < nl;
  const unsigned mask = __ballot_sync(0xffffffffu, active);
  if (active) {
    int32_t* m = lanes + l * M::STRIDE;
    Ph::level1(m, g, KWs);
    __syncwarp(mask);
    Ph::mid(m, g, K);
    __syncwarp(mask);
    Ph::level2(m, g, KWs);
    __syncwarp(mask);
    Ph::finish(m, g, K);
  }
  __syncthreads();

  if (mover) {
    for (int row = r0; row < 3 * L; row += rstep)
      out[(int64_t)row * F + f0 + ll] =
          static_cast<Tout>(lanes[ll * M::STRIDE + M::P1 + row]);
  }
}

template <int L, int W, typename Tin, typename Tout>
int launch(const void* p, const void* q, void* out, int64_t F, int negate,
           int warps, int blocks, const int32_t* consts,
           const msm::WideConsts<L, W>& KW, cudaStream_t stream) {
  const size_t smem = (size_t)warps * kLanesPerWarp * LaneMem<L>::STRIDE *
                      sizeof(int32_t);
  const cudaError_t rc = cudaFuncSetAttribute(
      padd_kernel<L, W, Tin, Tout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  padd_kernel<L, W, Tin, Tout>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
          static_cast<const Tin*>(p), static_cast<const Tin*>(q),
          static_cast<Tout*>(out), F, negate, consts, KW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_bits / out_bits: 16 or 32, the width of the int elements; negate:
// 1 for p - q; threads_per_lane must be kG (the wrapper's lane count
// rests on it); warps a block (1 to 4) and blocks from cuzk/kernels.py
// padd_batch_geometry, which must cover F; wide: host memory, the words
// of msm::WideConsts<L, W>.
extern "C" int msm_padd_batch(int num_limbs, int limb_bits, int in_bits,
                              int out_bits, const void* p, const void* q,
                              void* out, int64_t F, int negate,
                              int threads_per_lane, int warps, int blocks,
                              const int32_t* consts, const uint32_t* wide,
                              void* stream) {
  if (F < 1 || threads_per_lane != kG || warps < 1 || warps > kMaxWarps ||
      blocks < 1 || (int64_t)blocks * warps * kLanesPerWarp < F)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    msm::WideConsts<L, W> KW;
    std::memcpy(&KW, wide, sizeof(KW));
    if (in_bits == 16 && out_bits == 16)
      return launch<L, W, int16_t, int16_t>(p, q, out, F, negate, warps,
                                            blocks, consts, KW, s);
    if (in_bits == 16 && out_bits == 32)
      return launch<L, W, int16_t, int32_t>(p, q, out, F, negate, warps,
                                            blocks, consts, KW, s);
    if (in_bits == 32 && out_bits == 16)
      return launch<L, W, int32_t, int16_t>(p, q, out, F, negate, warps,
                                            blocks, consts, KW, s);
    if (in_bits == 32 && out_bits == 32)
      return launch<L, W, int32_t, int32_t>(p, q, out, F, negate, warps,
                                            blocks, consts, KW, s);
  });
  return static_cast<int>(cudaErrorInvalidValue);
}
