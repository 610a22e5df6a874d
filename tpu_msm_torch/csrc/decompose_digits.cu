// Signed-digit decomposition of scalars, several scalars a thread.
//
// Replaces tpu_msm/cuzk/kernels.py `_digits_kernel` / `decompose_digits`,
// and XLA's part around it in the JAX package's stage 1: the cast of the
// halfwords to the kernel's int32 and the zero digit rows that pad the
// windows to Wp (pipeline_pallas.py:174-176).
// Bound on the H100: bytes. A scalar reads the halfword rows its W
// windows touch (uint16 or int32, as staged) and writes Wp int16 digits
// with a handful of shifts and masks per window.
// Design: latency, not bytes, sets the pace of a thread that walks one
// scalar with one 2-byte load a window, each issued only after the last
// window's digit: 16 dependent trips to memory a thread, 64 B a warp
// access. Here a thread owns P consecutive scalars, one word of 4 or 8
// bytes of each row (P = 2, 4 of uint16; 1, 2 of int32), and issues
// every row its windows read before the first digit: the rows sit in
// registers (r[kRows + 1][words], indexed only by unrolled constants),
// then the carry chain runs over the W windows of its P scalars and each
// window's P digits leave as one store of 2P bytes. Rows come kRows at a
// time, and the next chunk only where windows start beyond it (none at
// 256-bit scalars and s >= 13). The operations on each value are the
// plain version's on int32, so int32 halfwords outside [0, 2^16) keep
// its exact bits. P is the larger where its threads still fill the card
// (small n takes small words; 16-byte words were slower than 8-byte ones
// at 2^20 and 2^22: twice the registers a thread, fewer threads
// resident). Alignment: where the row stride is a multiple of the word,
// thread 0 takes the `head` scalars before the first word boundary of
// the rows (a pass's slice of a wider array) and every other full thread
// loads whole words; stores are whole words where head is 0 and n a
// multiple of P. Every other thread (the head, the ragged tail, a stride
// off the words) reads and writes element by element, in the same chain.
// `kernels.decompose_digits_geometry` picks P, head, the thread count
// and both vector flags; msm_decompose_digits checks them against the
// pointers. One launch a call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// rows of halfwords a thread holds at once; r[kRows] is the next
// chunk's first row, read by windows that straddle the chunk's end
constexpr int kRows = 16;

// value j of a row's word (NW 32-bit words) as the plain version's
// int32; j is an unrolled constant at every call
template <typename T, int NW>
__device__ __forceinline__ int32_t elem(const uint32_t (&v)[NW], int j) {
  if (sizeof(T) == 2)
    return static_cast<int32_t>((v[j >> 1] >> (16 * (j & 1))) & 0xFFFFu);
  return static_cast<int32_t>(v[j]);
}

template <typename T, int NW>
__device__ __forceinline__ void set_elem(uint32_t (&v)[NW], int j, T x) {
  if (sizeof(T) == 2) {
    const uint32_t sh = 16 * (j & 1);
    v[j >> 1] = (v[j >> 1] & ~(0xFFFFu << sh))
                | (static_cast<uint32_t>(static_cast<uint16_t>(x)) << sh);
  } else {
    v[j] = static_cast<uint32_t>(x);
  }
}

template <int NW>
__device__ __forceinline__ void load_word(uint32_t (&v)[NW],
                                          const void* src) {
  if constexpr (NW == 2) {
    const uint2 q = __ldg(static_cast<const uint2*>(src));
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = __ldg(static_cast<const unsigned int*>(src));
  }
}

// one window's P digits to its row: one word of 2P bytes where `vec`,
// else element by element below cnt
template <int P>
__device__ __forceinline__ void store_row(int16_t* __restrict__ row,
                                          const int16_t (&d)[P], bool vec,
                                          int cnt) {
  if (vec && P > 1) {
    uint32_t w[P / 2 > 0 ? P / 2 : 1];
#pragma unroll
    for (int j = 0; j < P / 2; j++)
      w[j] = static_cast<uint32_t>(static_cast<uint16_t>(d[2 * j]))
             | (static_cast<uint32_t>(static_cast<uint16_t>(d[2 * j + 1]))
                << 16);
    if constexpr (P == 4)
      *reinterpret_cast<uint2*>(row) = make_uint2(w[0], w[1]);
    else if constexpr (P == 2)
      *reinterpret_cast<uint32_t*>(row) = w[0];
  } else {
#pragma unroll
    for (int j = 0; j < P; j++)
      if (j < cnt) row[j] = d[j];
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
digits_kernel(const T* __restrict__ hw, int64_t ld, int16_t* __restrict__ out,
              int H, int64_t n, int s, int W, int Wp, int rows, int64_t head,
              int vec_load, int vec_store) {
  constexpr int NW = P * sizeof(T) / 4;        // 32-bit words of a row
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int first = head > 0;                  // thread 0 takes the head
  const int64_t f0 = t < first ? 0 : head + (t - first) * P;
  if (f0 >= n) return;
  const int64_t f1 = t < first ? head : (f0 + P < n ? f0 + P : n);
  const int cnt = static_cast<int>(f1 - f0);
  const bool vl = vec_load && cnt == P, vs = vec_store && cnt == P;
  const int32_t mask = (1 << s) - 1;
  const int32_t full = 1 << s;
  const int32_t half = 1 << (s - 1);
  int32_t carry[P];
#pragma unroll
  for (int j = 0; j < P; j++) carry[j] = 0;
  int16_t d[P];
  uint32_t r[kRows + 1][NW];
  int w = 0;
  for (int c0 = 0; w < W; c0 += kRows) {
    // every row of the chunk in flight before the first window
#pragma unroll
    for (int k = 0; k <= kRows; k++) {
      const int row = c0 + k;
#pragma unroll
      for (int q = 0; q < NW; q++) r[k][q] = 0;
      if (row < rows) {
        const T* src = hw + (int64_t)row * ld + f0;
        if (vl) {
          load_word<NW>(r[k], src);
        } else {
#pragma unroll
          for (int j = 0; j < P; j++)
            if (j < cnt) set_elem<T, NW>(r[k], j, src[j]);
        }
      }
    }
    // the windows whose first halfword lies in this chunk
#pragma unroll
    for (int k = 0; k < kRows; k++) {
      while (w < W && ((w * s) >> 4) == c0 + k) {
        const int off = (w * s) & 15;
        const bool next = off && c0 + k + 1 < H;
#pragma unroll
        for (int j = 0; j < P; j++) {
          int32_t val = elem<T, NW>(r[k], j);
          if (off) {
            val >>= off;
            if (next)
              val |= static_cast<int32_t>(
                  static_cast<uint32_t>(elem<T, NW>(r[k + 1], j))
                  << (16 - off));
          }
          val = (val & mask) + carry[j];
          const bool ge = val >= half;
          d[j] = static_cast<int16_t>(val - (ge ? full : 0));
          carry[j] = ge ? 1 : 0;
        }
        store_row<P>(out + (int64_t)w * n + f0, d, vs, cnt);
        w++;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P; j++) d[j] = 0;
  for (; w < Wp; w++) store_row<P>(out + (int64_t)w * n + f0, d, vs, cnt);
}

template <typename T, int P>
void launch(const void* hw, int64_t ld, int16_t* out, int H, int64_t n,
            int s, int W, int Wp, int rows, int64_t head, int64_t threads,
            int vec_load, int vec_store, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  digits_kernel<T, P><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(hw), ld, out, H, n, s, W, Wp, rows, head,
      vec_load, vec_store);
}

}  // namespace

// hw: (H, n) halfwords of hw_bytes each (2: uint16, 4: int32), row i at
// hw + i ld elements; out: (Wp, n) int16, Wp >= W. rows: the halfword
// rows the W windows read; P (scalars a thread: 2 or 4 of uint16, 1 or
// 2 of int32), head, threads, vec_load, vec_store from
// cuzk/kernels.py decompose_digits_geometry, checked here against the
// pointers: a vector flag the addresses do not allow is refused.
extern "C" int msm_decompose_digits(const void* hw, int hw_bytes, int64_t ld,
                                    int16_t* out, int H, int64_t n, int s,
                                    int W, int Wp, int rows, int P,
                                    int64_t head, int64_t threads,
                                    int vec_load, int vec_store,
                                    void* stream) {
  const int word = P * hw_bytes;               // bytes a row a thread
  if ((hw_bytes != 2 && hw_bytes != 4) || (word != 4 && word != 8) ||
      Wp < W || s < 1 || s > 16 || rows < 0 || rows > H || n < 1 ||
      head < 0 || head > n || threads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto at = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  if (vec_load && ((ld * hw_bytes) % word ||
                   (at(hw) + head * hw_bytes) % word))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_store && (head || n % P || at(out) % (2 * P)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((head > 0) + (n - head + P - 1) / P != threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = (cudaStream_t)stream;
  if (hw_bytes == 2) {
    if (P == 4)
      launch<uint16_t, 4>(hw, ld, out, H, n, s, W, Wp, rows, head, threads,
                          vec_load, vec_store, st);
    else
      launch<uint16_t, 2>(hw, ld, out, H, n, s, W, Wp, rows, head, threads,
                          vec_load, vec_store, st);
  } else {
    if (P == 2)
      launch<int32_t, 2>(hw, ld, out, H, n, s, W, Wp, rows, head, threads,
                         vec_load, vec_store, st);
    else
      launch<int32_t, 1>(hw, ld, out, H, n, s, W, Wp, rows, head, threads,
                         vec_load, vec_store, st);
  }
  return static_cast<int>(cudaGetLastError());
}
