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
// Design: a one-sweep least-significant-digit radix sort (Adinets and
// Merrill, "Onesweep", 2022) of cuzk/kernels.py `sort_passes(B)` passes
// of 8 bits, 2 + passes launches a call (`bucket_sort_geometry`):
//  - `radix_upsweep_kernel`: a block takes a chunk of one window's
//    digits (grid x the chunks, y the windows) and counts each key
//    k = min(|d|, kmax) in a histogram of kmax + 1 bins in shared memory
//    (a warp whose 32 keys are one, as in the zero pad windows, adds
//    once); it writes the chunk's bins 0 .. B, part (Wp, chunks, B + 1),
//    and each pass's 256 digit counts, pdig (Wp, chunks, passes, 256),
//    sums of those bins. The blocks also zero the look-back words and
//    tile counters of the passes below.
//  - `radix_counts_kernel`: a block a segment of 256 bins of a window:
//    the bins summed over the chunks and scanned, plus the keys below the
//    segment (the pass-1 digits below it), give cnt[w, j] = #(|d| <= j),
//    each window's histogram's inclusive prefix, with no read of the
//    sorted keys; the first segment's block also scans each pass's digit
//    totals into each digit's first position in the window, dbase
//    (passes, Wp, 256).
//  - `radix_pass_kernel<first, last>`, once a pass: a block takes the
//    next tile of kTile elements of its window from an atomic counter of
//    the (pass, window), loads it, ranks it ONCE and scatters it. Warp w
//    of the block owns elements [w kTile / 8, (w + 1) kTile / 8) of the
//    tile. First the early counts (as Onesweep's): each warp counts its
//    digits by shared atomics, and the tile's count of each digit is
//    published at once as its aggregate, before the rank, so that the
//    tiles after it seldom wait for it; each digit's first slot in the
//    tile and each warp's after the warps before follow. Then the rank,
//    straight into the sorted tile in shared memory: a warp walks its
//    elements 32 at a time in index order; lanes of equal digit find
//    each other by one warp ballot a bit of the digit (the multisplit;
//    __match_any_sync was no faster a tile, PERF.md), an element's slot
//    is its warp's next slot of the digit plus its peers of lower lane,
//    and the lowest peer moves the next slot on. Then a thread a digit
//    looks back over the tiles before it (decoupled look-back, Merrill
//    and Garland, 2016): it adds aggregates until it meets an inclusive
//    prefix, and publishes its own inclusive prefix. It reads kLook
//    tiles' words a round trip (one a round trip took 0.18 to 0.21 ms a
//    pass at 2^20, PERF.md). A look-back word is one 32-bit word, the
//    flag in its top two bits and the count below (n < 2^30), stored
//    and loaded relaxed at the device scope: it carries its own value,
//    so no fence is needed. Slot s of digit d goes to window position
//    dbase(d) + (tiles before, digit d) + s - slot(d): a digit's run of
//    the tile goes to consecutive addresses. The first pass reads the
//    int16 digits and makes the key (as uint16: |-2^15| = 2^15) and the
//    payload idx << 1 | (d < 0); a later pass copies each payload by
//    cp.async from device memory to its sorted slot, so no register
//    holds it and the copies fly during the look-back; the last pass
//    writes only the payload.
// The tile ids come from atomics, so a block looks back only on tiles
// that are already running (a block that holds tile t waits on tiles
// below t, which took their ids before it), and the order in which
// blocks take tiles decides only which block sorts which tile, never an
// element's place: the output is the stable order, bit for bit, run
// after run. kmax = min(B + 1, 2^(8 passes) - 1) clamps a key above B
// (outside the contract) so that every key stays inside the histogram
// and the passes' digits agree with it.
// Temporaries are the caller's torch tensors: nothing is allocated here.
// Layouts: digits, pay, keys_mid, pay_mid (Wp, n); cnt (Wp, B + 1); work
// int32: part, pdig, dbase, then the look-back words (passes, Wp, tiles,
// 256) and tile counters (passes, Wp) together (zeroed by the upsweep);
// all row-major.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // a block of the pass kernel
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;               // elements a thread
constexpr int kTile = kThreads * kItems; // cuzk/kernels.py SORT_TILE
constexpr int kWarpSpan = kTile / kWarps;
constexpr int kRadixBits = 8;            // cuzk/kernels.py SORT_RADIX_BITS
constexpr int kRadix = 1 << kRadixBits;
constexpr int kUpThreads = 1024;         // cuzk/kernels.py SORT_UPSWEEP_THREADS
constexpr int kUpUnroll = 16;            // digits a thread in flight
// A look-back word: not ready (0), the tile's aggregate or its inclusive
// prefix, flagged in the top two bits.
constexpr uint32_t kAggregate = 1u << 30, kInclusive = 2u << 30;
constexpr uint32_t kCountMask = kAggregate - 1;
constexpr int kLook = 16;                // look-back words a round trip
constexpr int kPassBlocks = 5;           // resident pass blocks an SM: 48 registers
// A key in a register: 16 bits (kmax <= 2^15 + 1) and, on the first
// pass, the digit's sign in the top bit; kInvalid past the last element.
constexpr uint32_t kNeg = 1u << 31, kInvalid = 0x7fffffffu;
static_assert(kThreads == kRadix, "a thread a digit in the scans");

// The exclusive prefix of v over the block's kThreads threads; wsum
// holds kWarps words; *total, where given, gets the sum over the block.
// Every thread calls it (it holds __syncthreads, and leaves wsum free for
// the next call).
__device__ __forceinline__ int32_t block_exclusive(int32_t v, int32_t* wsum,
                                                   int32_t* total = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int32_t base = incl - v, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    if (w < warp) base += wsum[w];
    all += wsum[w];
  }
  __syncthreads();
  if (total) *total = all;
  return base;
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// A 4-byte copy from device to shared memory that does not wait for its
// data (cp.async), and the waits for this thread's copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// part (Wp, chunks, B + 1), pdig (Wp, chunks, passes, 256); zero: the
// zero_words words of the passes' look-back words and tile counters.
// Dynamic shared memory: ((kmax >> 8) + 1) 256 bins.
__global__ void __launch_bounds__(kUpThreads)
radix_upsweep_kernel(const int16_t* __restrict__ digits, int64_t n, int B,
                     int kmax, int passes, int64_t span,
                     int32_t* __restrict__ part, int32_t* __restrict__ pdig,
                     int32_t* __restrict__ zero, int64_t zero_words) {
  extern __shared__ int32_t h[];
  const int segs = (kmax >> kRadixBits) + 1;
  const int nbins = segs << kRadixBits;
  const int64_t chunk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int64_t stride = (int64_t)gridDim.x * gridDim.y * kUpThreads;
  for (int64_t i = chunk * kUpThreads + threadIdx.x; i < zero_words;
       i += stride)
    zero[i] = 0;
  for (int i = threadIdx.x; i < nbins; i += kUpThreads) h[i] = 0;
  __syncthreads();

  const int16_t* d = digits + (int64_t)blockIdx.y * n;
  const int64_t lo = (int64_t)blockIdx.x * span;
  const int64_t hi = min(n, lo + span);
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = lo; i0 < hi; i0 += (int64_t)kUpThreads * kUpUnroll) {
    int k[kUpUnroll];
#pragma unroll
    for (int u = 0; u < kUpUnroll; u++) {
      const int64_t i = i0 + u * kUpThreads + threadIdx.x;
      k[u] = -1;
      if (i < hi) {
        const int v = d[i];
        k[u] = min(v < 0 ? -v : v, kmax);
      }
    }
#pragma unroll
    for (int u = 0; u < kUpUnroll; u++) {
      const int k0 = __shfl_sync(0xffffffffu, k[u], 0);
      if (__all_sync(0xffffffffu, k[u] == k0)) {
        if (lane == 0 && k0 >= 0) atomicAdd(&h[k0], 32);
      } else if (k[u] >= 0) {
        atomicAdd(&h[k[u]], 1);
      }
    }
  }
  __syncthreads();

  int32_t* out = part + chunk * (B + 1);
  for (int j = threadIdx.x; j <= B; j += kUpThreads) out[j] = h[j];
  // the passes' digit counts: pass 0 the key's low 8 bits (bins j, j +
  // 256, ...: a quarter of the segments a thread, then added), pass 1 its
  // high bits (the 256 bins of a segment, by a warp)
  __shared__ int32_t low[kRadix];
  const int t = threadIdx.x, warp = t >> 5;
  if (t < kRadix) low[t] = 0;
  __syncthreads();
  {
    const int dg = t & (kRadix - 1);
    int32_t s = 0;
    for (int i = t >> kRadixBits; i < segs; i += kUpThreads / kRadix)
      s += h[(i << kRadixBits) + dg];
    atomicAdd(&low[dg], s);
  }
  int32_t* dig = pdig + chunk * passes * kRadix;
  if (passes > 1) {
    for (int i = warp; i < kRadix; i += kUpThreads / 32) {
      int32_t s = 0;
      if (i < segs)
        for (int j = lane; j < kRadix; j += 32) s += h[(i << kRadixBits) + j];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) dig[kRadix + i] = s;
    }
  }
  __syncthreads();
  if (t < kRadix) dig[t] = low[t];
}

// A block a segment of 256 bins (x) of a window (y): cnt (Wp, B + 1) and,
// from the first segment's block, dbase (passes, Wp, 256).
__global__ void __launch_bounds__(kRadix)
radix_counts_kernel(const int32_t* __restrict__ part,
                    const int32_t* __restrict__ pdig, int B, int passes,
                    int chunks, int Wp, int32_t* __restrict__ cnt,
                    int32_t* __restrict__ dbase) {
  __shared__ int32_t wsum[kWarps];
  const int s = blockIdx.x, t = threadIdx.x;
  const int64_t w = blockIdx.y;
  const int j = (s << kRadixBits) + t;
  const int32_t* pw = part + w * chunks * (B + 1);
  const int32_t* dw = pdig + w * chunks * passes * kRadix;
  int32_t h = 0;
  if (j <= B)
    for (int c = 0; c < chunks; c++) h += pw[(int64_t)c * (B + 1) + j];
  // the keys below the segment: its pass-1 digits below s (with one pass
  // there is one segment, s = 0)
  int32_t below = 0;
  if (t < s)
    for (int c = 0; c < chunks; c++) below += dw[(c * passes + 1) * kRadix + t];
  int32_t base;
  block_exclusive(below, wsum, &base);
  const int32_t incl = block_exclusive(h, wsum) + h;
  if (j <= B) cnt[w * (B + 1) + j] = base + incl;
  if (s == 0) {
    for (int p = 0; p < passes; p++) {
      int32_t tot = 0;
      for (int c = 0; c < chunks; c++) tot += dw[(c * passes + p) * kRadix + t];
      dbase[((int64_t)p * Wp + w) * kRadix + t] = block_exclusive(tot, wsum);
    }
  }
}

// One pass over a window (y) a tile at a time: src keys (int16 digits on
// the first pass, else uint16 keys) and payloads (none on the first
// pass) -> dst keys (none on the last) and payloads. dbase (Wp, 256),
// status (Wp, tiles, 256) and counter (Wp) are this pass's.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
radix_pass_kernel(const void* __restrict__ src_keys,
                  const int32_t* __restrict__ src_pay, int n, int shift,
                  int kmax, int tiles, const int32_t* __restrict__ dbase,
                  uint32_t* status, uint32_t* counter,
                  uint16_t* __restrict__ dst_keys,
                  int32_t* __restrict__ dst_pay) {
  __shared__ int32_t whist[kWarps][kRadix];
  __shared__ int32_t wsum[kWarps];
  __shared__ int32_t off[kRadix];          // position of a digit's slot 0
  __shared__ uint16_t stage_key[kTile];    // the tile in sorted order
  __shared__ uint32_t stage_pay[kTile];    // ... its payloads
  __shared__ int tile_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t win = blockIdx.y;
  const int64_t row = win * n;
  if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(counter + win, 1u));
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&whist[0][0])[i] = 0;
  __syncthreads();
  const int tile = tile_s;
  const int l0 = warp * kWarpSpan + lane;   // item 0's place in the tile
  const int i0 = tile * kTile + l0;

  // the tile's keys, all loads in flight together
  uint32_t key[kItems];
#pragma unroll
  for (int c = 0; c < kItems; c++) {
    const int idx = i0 + c * 32;
    uint32_t k = kInvalid;
    if (idx < n) {
      if constexpr (kFirst) {
        const int d = static_cast<const int16_t*>(src_keys)[row + idx];
        k = static_cast<uint32_t>(min(d < 0 ? -d : d, kmax)) |
            (d < 0 ? kNeg : 0u);
      } else {
        k = static_cast<const uint16_t*>(src_keys)[row + idx];
      }
    }
    key[c] = k;
  }

  // early counts: each warp's digits by shared atomics, so that the
  // tile's aggregate is out before the rank
#pragma unroll
  for (int c = 0; c < kItems; c++)
    if (key[c] != kInvalid)
      atomicAdd(&whist[warp][(key[c] >> shift) & (kRadix - 1)], 1);
  __syncthreads();

  // a thread a digit: the tile's count, published as its aggregate; the
  // digit's first slot in the tile, and each warp's after the warps
  // before
  const int d = threadIdx.x;
  int32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) count += whist[w][d];
  uint32_t* st = status + (win * tiles + tile) * kRadix + d;
  st_relaxed(st, (tile == 0 ? kInclusive : kAggregate) |
                     static_cast<uint32_t>(count));
  const int32_t slot = block_exclusive(count, wsum);
  int32_t run = slot;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    const int32_t v = whist[w][d];
    whist[w][d] = run;
    run += v;
  }
  __syncthreads();

  // the rank, straight into the sorted tile in shared memory: one ballot
  // a bit of the digit finds a lane's peers; its slot is its warp's next
  // slot of the digit plus its peers of lower lane, and the lowest peer
  // moves the warp's next slot on. A later pass's payloads go by
  // cp.async from device memory straight to their slots, in flight
  // during the look-back.
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kItems; c++) {
    const bool valid = key[c] != kInvalid;
    const uint32_t dg = (key[c] >> shift) & (kRadix - 1);
    unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
    for (int b = 0; b < kRadixBits; b++) {
      const bool bit = (dg >> b) & 1u;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      peers &= bit ? m : ~m;
    }
    const int before = __popc(peers & below);
    const int s = whist[warp][dg] + before;
    __syncwarp();
    if (valid) {
      if (before == 0) whist[warp][dg] = s + __popc(peers);
      const int idx = i0 + c * 32;
      stage_key[s] = static_cast<uint16_t>(key[c]);
      if constexpr (kFirst)
        stage_pay[s] = static_cast<uint32_t>(idx) << 1 | key[c] >> 31;
      else
        cp_async4(stage_pay + s, src_pay + row + idx);
    }
    __syncwarp();
  }
  if constexpr (!kFirst) cp_async_commit();

  // the look-back over the tiles before, kLook of them a round trip:
  // aggregates are added from the nearest tile back to an inclusive
  // prefix; a tile not ready is read again. Then the window position of
  // slot 0 of the digit's run.
  int32_t excl = 0;
  if (tile > 0) {
    const uint32_t* sw = status + win * tiles * kRadix + d;
    int q = tile - 1;   // the nearest tile not yet added
    for (;;) {
      uint32_t v[kLook];
#pragma unroll
      for (int u = 0; u < kLook; u++)
        v[u] = q - u >= 0 ? ld_relaxed(sw + (int64_t)(q - u) * kRadix)
                          : kInclusive;
      bool stop = false, done = false;
      int added = 0;
#pragma unroll
      for (int u = 0; u < kLook; u++) {
        if (!stop) {
          if (v[u] < kAggregate) {
            stop = true;
          } else {
            excl += static_cast<int32_t>(v[u] & kCountMask);
            added++;
            if (v[u] >= kInclusive) stop = done = true;
          }
        }
      }
      if (done) break;
      q -= added;
      if (!added) __nanosleep(64);
    }
    st_relaxed(st, kInclusive | static_cast<uint32_t>(excl + count));
  }
  off[d] = dbase[win * kRadix + d] + excl - slot;
  if constexpr (!kFirst) cp_async_wait_all();
  __syncthreads();

  // ... and out: consecutive slots of a digit to consecutive positions
  const int valid = min(kTile, n - tile * kTile);
  for (int s = threadIdx.x; s < valid; s += kThreads) {
    const uint32_t k = stage_key[s];
    const int64_t pos = row + off[(k >> shift) & (kRadix - 1)] + s;
    if constexpr (!kLast) dst_keys[pos] = static_cast<uint16_t>(k);
    dst_pay[pos] = static_cast<int32_t>(stage_pay[s]);
  }
}

template <bool kFirst, bool kLast>
void launch_pass(dim3 grid, cudaStream_t s, const void* keys,
                 const int32_t* pay_in, int n, int shift, int kmax, int tiles,
                 const int32_t* dbase, uint32_t* status, uint32_t* counter,
                 uint16_t* keys_out, int32_t* pay_out) {
  radix_pass_kernel<kFirst, kLast><<<grid, kThreads, 0, s>>>(
      keys, pay_in, n, shift, kmax, tiles, dbase, status, counter, keys_out,
      pay_out);
}

}  // namespace

// digits (Wp, n) int16 with |d| <= B < 2^(8 passes), B <= 2^15, n < 2^30;
// passes 1 or 2 (cuzk/kernels.py sort_passes); chunks a window of the
// upsweep (cuzk/kernels.py bucket_sort_geometry). Outputs pay (Wp, n)
// and cnt (Wp, B + 1) int32. Temporaries: keys_mid (Wp, n) 16-bit and
// pay_mid (Wp, n) int32 (unused with one pass); work, int32 words:
// Wp chunks (B + 1) + Wp chunks passes 256 + passes Wp 256
// + passes Wp (tiles 256 + 1), tiles = ceil(n / kTile).
extern "C" int msm_bucket_sort(const int16_t* digits, int Wp, int64_t n,
                               int B, int passes, int chunks, int32_t* pay,
                               int32_t* cnt, int16_t* keys_mid,
                               int32_t* pay_mid, int32_t* work,
                               void* stream) {
  if (Wp < 1 || Wp > 65535 || n < 1 || n >= (int64_t{1} << 30) || B < 1 ||
      B > (1 << 15) || passes < 1 || passes > 2 ||
      B >= (1 << (kRadixBits * passes)) || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  const int kmax = std::min(B + 1, (1 << (kRadixBits * passes)) - 1);
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int64_t span = (n + chunks - 1) / chunks;
  int32_t* part = work;
  int32_t* pdig = part + (int64_t)Wp * chunks * (B + 1);
  int32_t* dbase = pdig + (int64_t)Wp * chunks * passes * kRadix;
  int32_t* zero = dbase + (int64_t)passes * Wp * kRadix;
  auto* status = reinterpret_cast<uint32_t*>(zero);
  uint32_t* counter = status + (int64_t)passes * Wp * tiles * kRadix;
  const int64_t zero_words = (int64_t)passes * Wp * ((int64_t)tiles * kRadix + 1);

  const size_t up_smem = (size_t)(((kmax >> kRadixBits) + 1) << kRadixBits) *
                         sizeof(int32_t);
  cudaError_t rc = cudaFuncSetAttribute(
      radix_upsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(up_smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  radix_upsweep_kernel<<<dim3(chunks, Wp), kUpThreads, up_smem, s>>>(
      digits, n, B, kmax, passes, span, part, pdig, zero, zero_words);
  radix_counts_kernel<<<dim3((B >> kRadixBits) + 1, Wp), kRadix, 0, s>>>(
      part, pdig, B, passes, chunks, Wp, cnt, dbase);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);

  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(Wp));
  const int nn = static_cast<int>(n);
  auto* mid = reinterpret_cast<uint16_t*>(keys_mid);
  for (int pass = 0; pass < passes; pass++) {
    const int shift = kRadixBits * pass;
    const int32_t* db = dbase + (int64_t)pass * Wp * kRadix;
    uint32_t* stp = status + (int64_t)pass * Wp * tiles * kRadix;
    uint32_t* ctr = counter + (int64_t)pass * Wp;
    if (passes == 1)
      launch_pass<true, true>(grid, s, digits, nullptr, nn, shift, kmax, tiles,
                              db, stp, ctr, nullptr, pay);
    else if (pass == 0)
      launch_pass<true, false>(grid, s, digits, nullptr, nn, shift, kmax,
                               tiles, db, stp, ctr, mid, pay_mid);
    else
      launch_pass<false, true>(grid, s, mid, pay_mid, nn, shift, kmax, tiles,
                               db, stp, ctr, nullptr, pay);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaSuccess);
}
