// The product tree of batched Montgomery inversion, on the card: the
// tree of tpu_msm_torch/ops/inverse.py `batch_inverse` (the port of
// tpu_msm/ops/inverse.py:85 `batch_inverse`, which XLA compiles, no
// pallas_call), step for step. csrc/to_affine.cu and
// csrc/batch_inverse.cu are this tree with their own ends: the leaves
// they load and the inverses they store.
//
// The tree, as the plain version builds it:
//   leaves  the canonical limbs of each element; an element of value 0
//           (limbs of 0 or of p) becomes the Montgomery one, and Kp - K
//           more leaves of the Montgomery one pad K to Kp, the next power
//           of two
//   up      node (l + 1, i) = mont(node (l, 2i), node (l, 2i + 1))
//   root    its inverse by Fermat: from the Montgomery one, for each bit
//           of p - 2 from the top, a squaring and, where the bit is set,
//           a product with the root
//   down    inv (l, 2i) = mont(inv (l + 1, i), node (l, 2i + 1)),
//           inv (l, 2i + 1) = mont(inv (l + 1, i), node (l, 2i))
//   zeros   an element that was zero gets zero
// Every product is mul_wide.cuh's multiply, rows.py mont_mul_rows bit for
// bit, with the plain version's operands in its order, so every node and
// every inverse is the plain version's limbs (canonical, below 2p).
//
// Bound on the H100: operations. Up, the tree takes a multiply an
// element; down, two; the root's chain of 367 (BN254) or 559
// (BLS12-377) dependent multiplies runs on one thread, about 0.19 ms at
// BN254 that no other work can hide.
// Design. A launch's blocks each own a subtree of 2^n leaves at level lo
// (cuzk/kernels.py `batch_inverse_geometry` plans the launches). Each of
// a block's T = 2^(n - d) threads builds the subtree of its 2^d
// consecutive leaves (d <= kTreeRegLog) in registers, and the block runs
// the n - d levels above in shared memory; the down-sweep walks the same
// way back. A launch does the up-sweep (kTreeUp), the chain on thread 0
// of its one block (kTreeRoot) and the down-sweep (kTreeDown). Up to
// 2^kTreeBlockLog leaves a call is one launch of all three in one block.
// Above, up-sweep launches of 2^kTreeBlockLog leaves a block go first,
// level by level, then one launch of all three on the top levels, then
// the down-sweeps in reverse order: three launches up to 2^20 leaves.
// Every node goes to a scratch of 2 Kp nodes in N word planes (node
// (l, i) at 2 Kp - 2 (Kp >> l) + i), which the down-sweep reads its
// siblings from. A launch whose leaves sit at level lo > 0 reads them
// there and writes their inverses in their place, where the launch below
// reads its blocks' roots. A block's leaves and their inverses pass
// through shared memory (the stage), so that the limbs, the flags and the
// scratch's leaf level move in rounds of neighbouring leaves on
// neighbouring threads, coalesced, while a thread's subtree takes 2^d
// consecutive leaves. The multiply is inlined, its operands words in
// registers; limbs are packed once on load and unpacked once on store.
#pragma once

#include <cstring>

#include "mul_wide.cuh"

namespace msm {

constexpr int kTreeThreadsLog = 8;
constexpr int kTreeThreads = 1 << kTreeThreadsLog;   // threads a block
constexpr int kTreeRegLog = 2;        // a thread's register subtree: <= 4 leaves
constexpr int kTreeBlockLog = kTreeThreadsLog + kTreeRegLog;
// What a launch does (cuzk/kernels.py TREE_UP, TREE_ROOT, TREE_DOWN).
constexpr int kTreeUp = 1, kTreeRoot = 2, kTreeDown = 4;

// The kernel parameter struct, laid out as cuzk/kernels.py
// `_affine_consts_host` builds it.
template <int L, int W>
struct TreeConsts {
  WideConsts<L, W> wide;
  uint32_t one[Wide<L, W>::N];   // R mod p, words
  uint32_t e[Wide<L, W>::N];     // p - 2, words
  int32_t nbits;                 // bits of p - 2
};

// One launch of the tree: its leaves' level, the levels a block covers,
// the register levels a thread covers and what it does.
struct TreeLaunch {
  uint32_t* scratch;   // N word planes of 2 Kp words
  uint8_t* zero;       // K flags: the element was zero (set going up)
  int64_t K, Kp;
  int lo, n, d, roles;
};

template <int L, int W>
struct Tree {
  using M = MulWide<L, W>;
  static constexpr int N = M::N;

  // b's words from registers, in order
  struct Words {
    const uint32_t (&w)[N];
    __device__ __forceinline__ uint32_t next(int i) const { return w[i]; }
  };

  // r = a b / R, its bits at and above L W dropped
  static __device__ __forceinline__ void mul(const uint32_t (&a)[N],
                                             const uint32_t (&b)[N],
                                             uint32_t (&r)[N],
                                             const WideConsts<L, W>& K) {
    Words bw{b};
    M::mont(a, bw, r, K);
    if constexpr (M::RB > 0) r[N - 1] &= (1u << M::RB) - 1;
  }

  static __device__ __forceinline__ uint32_t p_word(
      const WideConsts<L, W>& K, int k) {
    return k < M::NP ? K.p[k] : 0u;
  }

  // zero by value: the canonical words of 0 or of p
  static __device__ __forceinline__ bool is_zero(const uint32_t (&w)[N],
                                                 const WideConsts<L, W>& K) {
    bool zero = true, isp = true;
#pragma unroll
    for (int k = 0; k < N; k++) {
      zero = zero && w[k] == 0;
      isp = isp && w[k] == p_word(K, k);
    }
    return zero || isp;
  }

  // r < 2p -> r mod p
  static __device__ __forceinline__ void reduce_once(
      uint32_t (&r)[N], const WideConsts<L, W>& K) {
    int cmp = 0;
#pragma unroll
    for (int k = N - 1; k >= 0; k--) {
      const uint32_t pk = p_word(K, k);
      if (cmp == 0) cmp = (r[k] > pk) - (r[k] < pk);
    }
    if (cmp >= 0) {
      uint32_t borrow = 0;
#pragma unroll
      for (int k = 0; k < N; k++) {
        const uint64_t d = static_cast<uint64_t>(r[k]) - p_word(K, k) - borrow;
        r[k] = static_cast<uint32_t>(d);
        borrow = static_cast<uint32_t>(d >> 63);
      }
    }
  }

  // the L limbs of element f of an (L, K) plane, packed to words
  static __device__ __forceinline__ void load(const int32_t* c, int64_t K,
                                              int64_t f, uint32_t (&w)[N]) {
    int32_t a[L];
#pragma unroll
    for (int i = 0; i < L; i++) a[i] = c[(int64_t)i * K + f];
    M::pack(a, w);
  }

  // words -> the limbs of element f, all zero where `zero`
  static __device__ __forceinline__ void store(const uint32_t (&r)[N],
                                               bool zero, int32_t* out,
                                               int64_t K, int64_t f) {
    int32_t a[L];
    M::unpack(r, a);
#pragma unroll
    for (int i = 0; i < L; i++) out[(int64_t)i * K + f] = zero ? 0 : a[i];
  }

  static __device__ __forceinline__ int64_t node(const TreeLaunch& P, int l,
                                                 int64_t i) {
    return 2 * P.Kp - 2 * (P.Kp >> l) + i;
  }

  static __device__ __forceinline__ void get(const TreeLaunch& P, int l,
                                             int64_t i, uint32_t (&w)[N]) {
    const uint32_t* s = P.scratch + node(P, l, i);
#pragma unroll
    for (int k = 0; k < N; k++) w[k] = s[(int64_t)k * 2 * P.Kp];
  }

  static __device__ __forceinline__ void put(const TreeLaunch& P, int l,
                                             int64_t i,
                                             const uint32_t (&w)[N]) {
    uint32_t* s = P.scratch + node(P, l, i);
#pragma unroll
    for (int k = 0; k < N; k++) s[(int64_t)k * 2 * P.Kp] = w[k];
  }

  static __device__ __forceinline__ void copy(uint32_t (&d)[N],
                                              const uint32_t (&s)[N]) {
#pragma unroll
    for (int k = 0; k < N; k++) d[k] = s[k];
  }
};

// One launch of the tree. Ends<L, W> gives the leaves at level 0 and
// takes their inverses:
//   bool leaf(Args, C, K, f, w)     element f's canonical words into w,
//                                   and whether it is zero by value
//   void sink(Args, C, K, f, inv, zero)   element f's inverse
// The block's 2^n leaves pass through `stage` (dynamic shared memory, N
// word planes, tree_stage_bytes): loaded and stored in rounds of T
// neighbouring leaves, leaf q T + t on thread t, so that every access to
// the limbs, the flags and the scratch's leaf level is coalesced, while
// thread t's subtree takes leaves 2^d t .. 2^d t + 2^d - 1 from it.
template <int L, int W, template <int, int> class Ends>
__device__ __forceinline__ void tree_run(const TreeLaunch& P,
                                         const typename Ends<L, W>::Args& E,
                                         const TreeConsts<L, W>& C) {
  using Tr = Tree<L, W>;
  using En = Ends<L, W>;
  constexpr int N = Tr::N;
  // a node a thread, word planes, by the parity of its shared level
  __shared__ uint32_t S[2][N][kTreeThreads];
  __shared__ uint32_t ebits[N];
  extern __shared__ uint32_t stage[];
  const int t = threadIdx.x;
  const int lo = P.lo, n = P.n, d = P.d;
  const int up = n - d;                // the block's shared levels
  const int T = 1 << up;               // threads with a node
  const int leaves = 1 << n;
  const bool active = t < T;
  const int64_t base = (int64_t)blockIdx.x << n;   // the block's first leaf
  // the thread's node at level lo + d
  const int64_t tnode = ((int64_t)blockIdx.x << up) + t;
  const int H = d == 2 ? 2 : 1, J = d >= 1 ? 2 : 1;
  uint32_t a[N], b[N], x[N], r[N];

  if (P.roles & kTreeUp) {
    // the leaves into the stage; at level 0 from the ends, their flags
    // and their values (one where zero or padding) into the scratch
    if (active) {
#pragma unroll 1
      for (int q = 0; q < (1 << d); q++) {
        const int i = q * T + t;
        const int64_t f = base + i;
        if (lo > 0) {
          Tr::get(P, lo, f, x);
        } else {
          bool zero = false;
          if (f < P.K) {
            zero = En::leaf(E, C, P.K, f, x);
            P.zero[f] = zero;
          }
          if (f >= P.K || zero) Tr::copy(x, C.one);
          Tr::put(P, 0, f, x);
        }
#pragma unroll
        for (int k = 0; k < N; k++) stage[k * leaves + i] = x[k];
      }
    }
    __syncthreads();
    if (active) {
      // the thread's subtree: leaves 2^d t + 2h + j of the block; the
      // nodes of level lo + 1 as j closes a pair, of level lo + 2 as h
      // does
#pragma unroll 1
      for (int h = 0; h < H; h++) {
#pragma unroll 1
        for (int j = 0; j < J; j++) {
          const int i = (t << d) + 2 * h + j;
#pragma unroll
          for (int k = 0; k < N; k++) x[k] = stage[k * leaves + i];
          if (j == 0) {
            Tr::copy(a, x);
          } else {
            Tr::mul(a, x, r, C.wide);
            Tr::copy(a, r);
            Tr::put(P, lo + 1, (base + i) >> 1, a);
          }
        }
        if (h == 0) {
          Tr::copy(b, a);
        } else {
          Tr::mul(b, a, r, C.wide);
          Tr::copy(b, r);
          Tr::put(P, lo + 2, tnode, b);
        }
      }
#pragma unroll
      for (int k = 0; k < N; k++) S[0][k][t] = b[k];
    }
    // shared level s: node i from nodes 2i, 2i + 1 of level s - 1
    for (int s = 1; s <= up; s++) {
      __syncthreads();
      if (t < (T >> s)) {
#pragma unroll
        for (int k = 0; k < N; k++) {
          a[k] = S[(s - 1) & 1][k][2 * t];
          x[k] = S[(s - 1) & 1][k][2 * t + 1];
        }
        Tr::mul(a, x, r, C.wide);
#pragma unroll
        for (int k = 0; k < N; k++) S[s & 1][k][t] = r[k];
        Tr::put(P, lo + d + s, ((int64_t)blockIdx.x << (up - s)) + t, r);
      }
    }
    __syncthreads();
  }

  if (P.roles & kTreeRoot) {
    // the root's inverse, on thread 0: rows.py fermat_inv's bits
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < N; k++) {
        ebits[k] = C.e[k];
        x[k] = S[up & 1][k][0];
      }
      Tr::copy(a, C.one);
      for (int i = C.nbits - 1; i >= 0; i--) {
        Tr::mul(a, a, r, C.wide);
        if ((ebits[i >> 5] >> (i & 31)) & 1) {
          Tr::mul(r, x, a, C.wide);
        } else {
          Tr::copy(a, r);
        }
      }
#pragma unroll
      for (int k = 0; k < N; k++) S[up & 1][k][0] = a[k];
    }
    __syncthreads();
  }

  if (P.roles & kTreeDown) {
    if (!(P.roles & kTreeUp)) {
      // the block root's inverse, from the launch above, and the leaves'
      // values into the stage (a launch that went up keeps both)
      if (t == 0) {
        Tr::get(P, lo + n, blockIdx.x, a);
#pragma unroll
        for (int k = 0; k < N; k++) S[up & 1][k][0] = a[k];
      }
      if (active) {
#pragma unroll 1
        for (int q = 0; q < (1 << d); q++) {
          const int i = q * T + t;
          Tr::get(P, lo, base + i, x);
#pragma unroll
          for (int k = 0; k < N; k++) stage[k * leaves + i] = x[k];
        }
      }
      __syncthreads();
    }
    // shared level s: the inverses of node i's children from node i's
    // and the siblings' values
    for (int s = up; s >= 1; s--) {
      if (t < (T >> s)) {
        const int64_t c0 = ((int64_t)blockIdx.x << (up - s + 1)) + 2 * t;
#pragma unroll
        for (int k = 0; k < N; k++) a[k] = S[s & 1][k][t];
#pragma unroll 1
        for (int c = 0; c < 2; c++) {
          Tr::get(P, lo + d + s - 1, c0 + (c ^ 1), x);
          Tr::mul(a, x, r, C.wide);
#pragma unroll
          for (int k = 0; k < N; k++) S[(s - 1) & 1][k][2 * t + c] = r[k];
        }
      }
      __syncthreads();
    }
    if (active) {
      // the thread's subtree: each leaf's inverse in the stage, in the
      // place of its value once its sibling no longer needs that
#pragma unroll
      for (int k = 0; k < N; k++) a[k] = S[0][k][t];
#pragma unroll 1
      for (int h = 0; h < H; h++) {
        // b: the inverse of node (lo + 1, 2 tnode + h) where d = 2, else
        // of the thread's node
        if (d == 2) {
          Tr::get(P, lo + 1, (tnode << 1) + (h ^ 1), x);
          Tr::mul(a, x, b, C.wide);
        } else {
          Tr::copy(b, a);
        }
        const int i0 = d >= 1 ? (t << d) + 2 * h : t;
        uint32_t v0[N];
#pragma unroll
        for (int k = 0; k < N; k++) v0[k] = stage[k * leaves + i0];
#pragma unroll 1
        for (int j = 0; j < J; j++) {
          if (d >= 1) {
            if (j == 0) {
#pragma unroll
              for (int k = 0; k < N; k++) x[k] = stage[k * leaves + i0 + 1];
            } else {
              Tr::copy(x, v0);
            }
            Tr::mul(b, x, r, C.wide);
          } else {
            Tr::copy(r, b);
          }
#pragma unroll
          for (int k = 0; k < N; k++) stage[k * leaves + i0 + j] = r[k];
        }
      }
    }
    __syncthreads();
    // the inverses out of the stage, to the ends or, above level 0, in
    // the place of the leaves' values
    if (active) {
#pragma unroll 1
      for (int q = 0; q < (1 << d); q++) {
        const int i = q * T + t;
        const int64_t f = base + i;
#pragma unroll
        for (int k = 0; k < N; k++) x[k] = stage[k * leaves + i];
        if (lo > 0) {
          Tr::put(P, lo, f, x);
        } else if (f < P.K) {
          En::sink(E, C, P.K, f, x, P.zero[f] != 0);
        }
      }
    }
  }
}

// The dynamic shared memory of a launch of 2^n leaves a block: the stage.
template <int L, int W>
constexpr size_t tree_stage_bytes(int n) {
  return sizeof(uint32_t) * Wide<L, W>::N * (size_t{1} << n);
}

// The launch of one tree kernel, its arguments checked against the plan
// cuzk/kernels.py `batch_inverse_geometry` makes.
template <int L, int W, typename Args, typename Kernel>
int tree_launch(Kernel kernel, uint32_t* scratch, uint8_t* zero, int64_t K,
                int64_t Kp, int lo, int n, int d, int roles, int64_t blocks,
                const Args& E, const uint32_t* consts, int words,
                void* stream) {
  TreeConsts<L, W> C;
  if (static_cast<size_t>(words) * sizeof(uint32_t) != sizeof(C))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(&C, consts, sizeof(C));
  int levels = 0;
  while ((int64_t{1} << levels) < Kp) levels++;
  const bool ok =
      K >= 1 && K <= Kp && Kp < 2 * K && (int64_t{1} << levels) == Kp &&
      d >= 0 && d <= kTreeRegLog && n >= d && n - d <= kTreeThreadsLog &&
      lo >= 0 && lo + n <= levels && roles >= 1 && roles <= 7 &&
      blocks == (Kp >> (lo + n)) &&
      (!(roles & kTreeRoot) || (blocks == 1 && lo + n == levels));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // a block of 2^kTreeBlockLog leaves may stage more than the 48 KB,
  // less the static shared memory, that a launch gets unasked
  const size_t smem = tree_stage_bytes<L, W>(n);
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tree_stage_bytes<L, W>(kTreeBlockLog)));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const TreeLaunch P{scratch, zero, K, Kp, lo, n, d, roles};
  kernel<<<static_cast<unsigned>(blocks), kTreeThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(P, E, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace msm
