// Stage 2 of the device program: each window's digits sorted stably by
// |d|, the sign riding in the payload, and the bucket-region ends.
//
// Replaces tpu_msm/cuzk/pipeline_pallas.py:208-226, the `jax.lax.sort`
// of the sign-packed keys |d| << 1 | sign with the payload
// idx << 1 | sign, and `_bucket_counts` (:100), which XLA compiles around
// the Pallas kernels; no pallas_call. The key here is |d| alone: stage 3
// reads only the |d| boundaries, so the buckets are the same group
// elements, and |d| <= 2^15 takes two passes of 8 bits where the packed
// key's 17 bits would take three.
// Bound on the H100: bytes. The digits read once (2 B an element), pay
// (4 B) and cnt written once: about 100 MB at 2^20 with 16 windows,
// 0.03 ms at 3.35 TB/s. The passes move the keys and payloads between
// them once more each.
// Design: a least-significant-digit radix sort of cuzk/kernels.py
// `sort_passes(B)` passes of 8 bits, each three launches, then one for
// the counts; every launch is deterministic (no atomics), so the order is
// the stable one, bit for bit, run after run.
//  - `radix_tile_kernel<first, false>`: a block ranks a tile of kTile
//    elements of one window (grid x the tiles, y the windows) and writes
//    the tile's count of each of the 256 digits, hist (Wp, tiles, 256).
//    Warp w of the block owns elements [w kTile / 8, (w + 1) kTile / 8) of
//    the tile and walks them 32 at a time in index order: lanes of equal
//    digit find each other by one warp ballot a bit of the digit (the
//    multisplit; __match_any_sync, tried first, gave a sort no faster
//    than torch.sort), an element's rank among
//    the warp's earlier elements of its digit is the warp's count so far
//    (a 256-bin histogram of its own in shared memory) plus its peers of
//    lower lane, and the lowest peer adds the peers to the count. The last
//    tile's missing elements are left out of the peers (the first ballot,
//    of the lanes that hold an element) and of every count.
//  - `radix_scan_kernel`: for each window (a block) and digit (a thread),
//    the exclusive prefix of hist over the tiles, in place, and the
//    window's total of each digit.
//  - `radix_tile_kernel<first, true>`: the same ranking again; the block
//    scans the tile's counts over the digits (each digit's first slot in
//    the tile) and the totals (its first position in the window, to which
//    the tile's prefix from hist adds), writes each element's key and
//    payload at its slot in shared memory, so the tile sits there sorted,
//    and then copies it out, slot s of digit d to the window position
//    first(d) + s - slot(d): a digit's run of the tile goes to consecutive
//    addresses. The first pass reads the int16 digits and makes the key
//    |d| (as uint16: |-2^15| = 2^15) and the payload idx << 1 | (d < 0);
//    a later pass reads the keys and payloads the pass before wrote.
//  - `radix_bounds_kernel`: on the sorted keys, cnt[w, j] = #(|d| <= j):
//    position p writes p + 1 over j in [key[p], key[p + 1]) (up to B + 1
//    after the last), and position 0 writes 0 below key[0]. A warp writes
//    a range of more than 32 together, 32 entries a step, so the few long
//    ranges (a top window's empty upper buckets, an all-zero pad window)
//    are not one thread's loop.
// Temporaries are the caller's torch tensors: nothing is allocated here.
// Layouts: digits, pay, keys (Wp, n); cnt (Wp, B + 1); hist
// (Wp, tiles, 256); totals (Wp, 256); all row-major.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // a block of the tile kernels
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;               // elements a thread
constexpr int kTile = kThreads * kItems; // cuzk/kernels.py SORT_TILE
constexpr int kWarpSpan = kTile / kWarps;
constexpr int kRadixBits = 8;            // cuzk/kernels.py SORT_RADIX_BITS
constexpr int kRadix = 1 << kRadixBits;
constexpr int kScanUnroll = 16;
constexpr int kBoundsThreads = 256;
static_assert(kThreads == kRadix, "a thread a digit in the scans");

// The exclusive prefix of v over the block's threads (kThreads of them);
// wsum holds kWarps words. Every thread calls it (it holds
// __syncthreads, and leaves wsum free for the next call).
__device__ __forceinline__ int32_t block_exclusive(int32_t v,
                                                   int32_t* wsum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int32_t base = incl - v;
  for (int w = 0; w < warp; w++) base += wsum[w];
  __syncthreads();
  return base;
}

template <bool kFirst, bool kScatter>
__global__ void __launch_bounds__(kThreads)
radix_tile_kernel(const void* __restrict__ src_keys,
                  const int32_t* __restrict__ src_pay, int64_t n, int shift,
                  int32_t* __restrict__ hist,
                  const int32_t* __restrict__ totals,
                  uint16_t* __restrict__ dst_keys,
                  int32_t* __restrict__ dst_pay) {
  constexpr int kStage = kScatter ? kTile : 1;
  __shared__ int32_t whist[kWarps][kRadix];
  __shared__ int32_t wsum[kWarps];
  __shared__ int32_t first_slot[kRadix];   // a digit's first slot in the tile
  __shared__ int32_t first_pos[kRadix];    // ... and in the window
  __shared__ uint32_t stage_key[kStage];   // the tile in sorted order
  __shared__ int32_t stage_pay[kStage];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t win = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t row = win * n;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&whist[0][0])[i] = 0;
  __syncthreads();

  const int64_t i0 = tile * kTile + warp * kWarpSpan + lane;
  const unsigned below = (1u << lane) - 1u;
  // key, with the sign in bit 16 on the first pass; rank in the warp
  uint32_t key[kItems];
  int32_t rank[kItems];
#pragma unroll
  for (int c = 0; c < kItems; c++) {
    const int64_t idx = i0 + c * 32;
    const bool valid = idx < n;
    uint32_t k = 0;
    if (valid) {
      if (kFirst) {
        const int32_t d = static_cast<const int16_t*>(src_keys)[row + idx];
        k = static_cast<uint32_t>(d < 0 ? -d : d) | (d < 0 ? 1u << 16 : 0u);
      } else {
        k = static_cast<const uint16_t*>(src_keys)[row + idx];
      }
    }
    key[c] = k;
    // the lanes of equal digit: one ballot a bit of the digit
    const uint32_t dg = (k >> shift) & (kRadix - 1);
    unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
    for (int b = 0; b < kRadixBits; b++) {
      const bool bit = (dg >> b) & 1u;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? m : ~m;
    }
    const int before = __popc(peers & below);
    rank[c] = valid ? whist[warp][dg] + before : 0;
    __syncwarp();
    if (valid && before == 0) whist[warp][dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  const int d = threadIdx.x;   // a thread a digit from here
  int32_t* h = hist + (win * gridDim.x + tile) * kRadix + d;
  int32_t count = 0;           // the tile's elements of digit d
#pragma unroll
  for (int w = 0; w < kWarps; w++) count += whist[w][d];
  if (!kScatter) {
    *h = count;
    return;
  }
  // digit d's first slot in the tile, and its first position in the
  // window: the totals of the digits below it, then the tile's prefix
  // (hist, scanned); each warp's first slot of it after the warps before
  const int32_t slot = block_exclusive(count, wsum);
  first_slot[d] = slot;
  first_pos[d] = block_exclusive(totals[win * kRadix + d], wsum) + *h;
  int32_t run = slot;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    const int32_t v = whist[w][d];
    whist[w][d] = run;
    run += v;
  }
  __syncthreads();

  // the tile, sorted, into shared memory
#pragma unroll
  for (int c = 0; c < kItems; c++) {
    const int64_t idx = i0 + c * 32;
    if (idx < n) {
      const uint32_t k = key[c];
      const int s = whist[warp][(k >> shift) & (kRadix - 1)] + rank[c];
      stage_key[s] = k;
      stage_pay[s] = kFirst ? static_cast<int32_t>(idx << 1 | (k >> 16))
                            : src_pay[row + idx];
    }
  }
  __syncthreads();
  // ... and out: consecutive slots of a digit to consecutive positions
  const int64_t rest = n - tile * kTile;
  const int valid = rest < kTile ? static_cast<int>(rest) : kTile;
  for (int s = threadIdx.x; s < valid; s += kThreads) {
    const uint32_t k = stage_key[s];
    const int dg = (k >> shift) & (kRadix - 1);
    const int64_t pos = row + first_pos[dg] + (s - first_slot[dg]);
    dst_keys[pos] = static_cast<uint16_t>(k);
    dst_pay[pos] = stage_pay[s];
  }
}

// hist (Wp, tiles, 256) -> its exclusive prefix over the tiles, in place;
// totals (Wp, 256), each digit's count in the window. A block a window, a
// thread a digit: the loads of kScanUnroll tiles go out together.
template <int kUnroll>
__global__ void __launch_bounds__(kRadix)
radix_scan_kernel(int32_t* __restrict__ hist, int tiles,
                  int32_t* __restrict__ totals) {
  int32_t* h = hist + (int64_t)blockIdx.x * tiles * kRadix + threadIdx.x;
  int32_t run = 0;
  int t = 0;
  for (; t + kUnroll <= tiles; t += kUnroll) {
    int32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) v[u] = h[(int64_t)(t + u) * kRadix];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) {
      h[(int64_t)(t + u) * kRadix] = run;
      run += v[u];
    }
  }
  for (; t < tiles; t++) {
    const int32_t v = h[(int64_t)t * kRadix];
    h[(int64_t)t * kRadix] = run;
    run += v;
  }
  totals[(int64_t)blockIdx.x * kRadix + threadIdx.x] = run;
}

// c[j] = v for j in [a, b) of every lane, the lanes' ranges disjoint: a
// range of up to 32 by its own lane, a longer one by the whole warp.
// Every lane of the warp calls it.
__device__ __forceinline__ void fill_ranges(int32_t* c, int a, int b,
                                            int32_t v) {
  const int lane = threadIdx.x & 31;
  const bool own = b - a <= 32;
  if (own)
    for (int j = a; j < b; j++) c[j] = v;
  unsigned longer = __ballot_sync(0xffffffffu, !own);
  while (longer) {
    const int src = __ffs(longer) - 1;
    longer &= longer - 1;
    const int a2 = __shfl_sync(0xffffffffu, a, src);
    const int b2 = __shfl_sync(0xffffffffu, b, src);
    const int32_t v2 = __shfl_sync(0xffffffffu, v, src);
    for (int j = a2 + lane; j < b2; j += 32) c[j] = v2;
  }
}

template <int kBlock>
__global__ void __launch_bounds__(kBlock)
radix_bounds_kernel(const uint16_t* __restrict__ skeys, int64_t n, int B,
                    int32_t* __restrict__ cnt) {
  const int64_t win = blockIdx.y;
  const int64_t p = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const uint16_t* k = skeys + win * n;
  int32_t* c = cnt + win * (B + 1);
  const int top = B + 1;
  int k0 = top, k1 = top;
  if (p < n) {
    k0 = min(static_cast<int>(k[p]), top);
    if (p + 1 < n) k1 = min(static_cast<int>(k[p + 1]), top);
  }
  fill_ranges(c, k0, k1, static_cast<int32_t>(p + 1));
  fill_ranges(c, 0, p == 0 ? k0 : 0, 0);
}

}  // namespace

// digits (Wp, n) int16 with |d| <= B < 2^(8 passes), B <= 2^15, n < 2^30;
// passes 1 or 2 (cuzk/kernels.py sort_passes). Outputs pay (Wp, n) and
// cnt (Wp, B + 1) int32. Temporaries: keys_mid (Wp, n) 16-bit, pay_mid
// (Wp, n) int32 (unused with one pass), keys_out (Wp, n) 16-bit (the
// sorted keys), hist (Wp, ceil(n / kTile), 256) and totals (Wp, 256)
// int32.
extern "C" int msm_bucket_sort(const int16_t* digits, int Wp, int64_t n,
                               int B, int passes, int32_t* pay, int32_t* cnt,
                               int16_t* keys_mid, int32_t* pay_mid,
                               int16_t* keys_out, int32_t* hist,
                               int32_t* totals, void* stream) {
  if (Wp < 1 || Wp > 65535 || n < 1 || n >= (int64_t{1} << 30) || B < 1 ||
      B > (1 << 15) || passes < 1 || passes > 2 ||
      B >= (1 << (kRadixBits * passes)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(Wp));
  auto* mid = reinterpret_cast<uint16_t*>(keys_mid);
  auto* out = reinterpret_cast<uint16_t*>(keys_out);
  for (int pass = 0; pass < passes; pass++) {
    const int shift = kRadixBits * pass;
    const bool last = pass == passes - 1;
    uint16_t* dk = last ? out : mid;
    int32_t* dp = last ? pay : pay_mid;
    if (pass == 0) {
      radix_tile_kernel<true, false><<<grid, kThreads, 0, s>>>(
          digits, nullptr, n, shift, hist, totals, dk, dp);
    } else {
      radix_tile_kernel<false, false><<<grid, kThreads, 0, s>>>(
          mid, pay_mid, n, shift, hist, totals, dk, dp);
    }
    radix_scan_kernel<kScanUnroll><<<Wp, kRadix, 0, s>>>(
        hist, static_cast<int>(tiles), totals);
    if (pass == 0) {
      radix_tile_kernel<true, true><<<grid, kThreads, 0, s>>>(
          digits, nullptr, n, shift, hist, totals, dk, dp);
    } else {
      radix_tile_kernel<false, true><<<grid, kThreads, 0, s>>>(
          mid, pay_mid, n, shift, hist, totals, dk, dp);
    }
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 bgrid(static_cast<unsigned>((n + kBoundsThreads - 1) /
                                         kBoundsThreads),
                   static_cast<unsigned>(Wp));
  radix_bounds_kernel<kBoundsThreads><<<bgrid, kBoundsThreads, 0, s>>>(
      out, n, B, cnt);
  return static_cast<int>(cudaGetLastError());
}
