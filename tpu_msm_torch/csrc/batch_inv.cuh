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
// (BLS12-377) dependent multiplies, which no other work can hide, runs
// on one thread (Tree::mul) up to N = 9 words and on one warp from N =
// 12 (WarpMul: each multiply spread over the warp's lanes, a column of
// the product a lane; `warp_chain`).
// Design. A launch's blocks each own a subtree of 2^n leaves at level lo
// (cuzk/kernels.py `batch_inverse_geometry` plans the launches). Each of
// a block's T = 2^(n - d) threads builds the subtree of its 2^d
// consecutive leaves (d <= kTreeRegLog) in registers, and the block runs
// the n - d levels above in shared memory; the down-sweep walks the same
// way back. A launch does the up-sweep (kTreeUp), the chain on thread
// or warp 0 of its one block (kTreeRoot) and the down-sweep (kTreeDown). Up to
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
  uint32_t pinv[Wide<L, W>::N];  // -p^-1 mod 2^(32 N), words
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

// Whether the root's chain runs on a warp (WarpMul) at N words: from N =
// 12 (BLS12-377), where the warp's multiply is much the faster on an
// H100; below, one thread's Tree::mul, whose multiply at N = 9 (BN254)
// takes about as long as the warp's, which there only added its
// exchanges and registers and made the chain slower (PERF.md, row 14).
__host__ __device__ constexpr bool warp_chain(int N) { return N >= 12; }

// The multiply of Tree::mul on one warp, for the root's chain: the same
// function, r = (a b + M p) / R mod R with R = 2^(L W) and M = -a b p^-1
// mod R, for a and b below R, so the same words (any exact REDC finds
// this M). Lane k holds word k of each value (zero from N up), and a
// multiply takes a in every lane and b's word in its lane:
//   1. lane k sums column k of t = a b, a_i b_(k-i) over i, the low and
//      the high words of the 32 x 32-bit products apart in 64 bits (three
//      sums at once, then added; no carry flag, which would chain them);
//   2. M = t p' mod R (p' = -p^-1 mod 2^(32 N)): the high sums moved up a
//      lane and added give t = sum_k (w_k + 2^32 g_k) 2^(32 k) with w_k a
//      word and g_k small (`fold`), and lane k sums the columns of that
//      times p' below N, w_i p'_(k-i) and g_i p'_(k-1-i), p' a constant
//      word a lane and product; `resolve` makes them words: the fold, the
//      small carry moved up a lane, and the carries that last ripples
//      through words of all ones found for every lane at once from two
//      ballots (carry-lookahead on the lanes' bits); the top word cut to
//      R;
//   3. u = t + M p: t's columns of step 1 plus M_i p_(k-i), resolved;
//      lane k of the result is word k of u / R: bits L W + 32 k .. of u,
//      from the lanes NF + k and NF + k + 1, cut to R.
// The lanes read each other's words through a small buffer in shared
// memory (one store and a warp barrier a value; mostly broadcast loads),
// which ran faster than the same moves by shuffles; only the folds' and
// the resolves' moves up a lane are shuffles. Each multiply takes its
// operands from the last one's u: its words in every lane, lane k's
// words k - i. tests/test_torch_warp_mul.py replays it lane by lane in
// numpy against mont_mul_rows. The columns and the carries take
// 2 N + 2 <= 32 lanes.
template <int L, int W>
struct WarpMul {
  using D = Wide<L, W>;
  static constexpr int N = D::N, NF = D::NF, NP = D::NP, RB = D::RB;
  static_assert(2 * N + 2 <= 32, "a word of t a lane");
  static constexpr unsigned kAll = 0xffffffffu;

  // a column: a + 2^32 b, the low and the high words of its products
  // summed apart in 64 bits (no carry flag, so that the three sums of a
  // column run at once)
  struct Col {
    uint64_t a, b;
  };

  // the lane's constant words: p_(k - i), p'_(k - i) and p'_(k - 1 - i),
  // zero off p's NP words and p''s N
  struct Lane {
    uint32_t p[N], q[N], q1[N];
  };

  static __device__ __forceinline__ void lane_consts(
      Lane& c, const TreeConsts<L, W>& C, int k) {
#pragma unroll
    for (int i = 0; i < N; i++) {
      c.p[i] = c.q[i] = c.q1[i] = 0;
#pragma unroll
      for (int j = 0; j < N; j++) {
        if (k - i == j) {
          if (j < NP) c.p[i] = C.wide.p[j];
          c.q[i] = C.pinv[j];
        }
        if (k - 1 - i == j) c.q1[i] = C.pinv[j];
      }
    }
  }

  // s += x y
  static __device__ __forceinline__ void mad(Col& s, uint32_t x, uint32_t y) {
    const uint64_t p = static_cast<uint64_t>(x) * y;
    s.a += static_cast<uint32_t>(p);
    s.b += p >> 32;
  }

  // three sums of a column, added
  static __device__ __forceinline__ Col sum3(const Col& x, const Col& y,
                                             const Col& z) {
    return Col{x.a + y.a + z.a, x.b + y.b + z.b};
  }

  static __device__ __forceinline__ uint64_t up64(uint64_t v, int d) {
    const uint32_t lo = __shfl_up_sync(kAll, static_cast<uint32_t>(v), d);
    const uint32_t hi = __shfl_up_sync(kAll, static_cast<uint32_t>(v >> 32),
                                       d);
    return (static_cast<uint64_t>(hi) << 32) | lo;
  }

  // lane k's w + 2^32 g = a_k + b_(k-1): the value sum_j col_j 2^(32 j)
  // as sum_k (w_k + 2^32 g_k) 2^(32 k), w a word, g small
  static __device__ __forceinline__ void fold(const Col& s, int k,
                                              uint32_t& w, uint32_t& g) {
    const uint64_t b = up64(s.b, 1);
    const uint64_t v = s.a + (k < 1 ? 0 : b);
    w = static_cast<uint32_t>(v);
    g = static_cast<uint32_t>(v >> 32);
  }

  // word k of sum_j col_j 2^(32 j), col_j lane j's column
  static __device__ __forceinline__ uint32_t resolve(const Col& s, int k) {
    uint32_t w, g;
    fold(s, k, w, g);
    uint32_t gi = __shfl_up_sync(kAll, g, 1);
    if (k < 1) gi = 0;
    // w + gi: a carry out (then w is small), or w of all ones passes one
    // on
    const uint64_t v = static_cast<uint64_t>(w) + gi;
    w = static_cast<uint32_t>(v);
    const unsigned gen = __ballot_sync(kAll, (v >> 32) != 0);
    const unsigned pass = __ballot_sync(kAll, w == 0xffffffffu);
    // the carries into each lane: those of gen + (gen | pass) as bits
    const unsigned x = gen | pass;
    const unsigned in = (x + gen) ^ x ^ gen;
    return w + ((in >> k) & 1u);
  }

  // The warp's words in shared memory, where every lane reads what it
  // needs of the others' (one store and a warp barrier a value, then
  // loads, most of them the same address in every lane: broadcasts):
  // t's folded words and small carries, M's words, u's words.
  struct alignas(16) Buf {
    uint32_t w[32], g[32], m[32], u[32];
  };

  // every lane's copy of words 0 .. N - 1 of a published value: the
  // same address in every lane, 16 bytes a load where they make one
  static __device__ __forceinline__ void load(const uint32_t* src,
                                              uint32_t (&dst)[N]) {
#pragma unroll
    for (int i = 0; i + 4 <= N; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
#pragma unroll
    for (int i = N - N % 4; i < N; i++) dst[i] = src[i];
  }

  // lane k's word of a value into `to`, for every lane to read
  static __device__ __forceinline__ void publish(uint32_t* to, uint32_t v,
                                                 int k) {
    to[k] = v;
    __syncwarp();
  }

  // u = a b + M p at lane k's word: a's words in every lane, bs[i] =
  // b_(k - i) (zero off b's N words); Tree::mul(a, b) is u / R mod R
  // (`words`, `word_at` once u is published)
  static __device__ __forceinline__ uint32_t mul(const uint32_t (&a)[N],
                                                 const uint32_t (&bs)[N],
                                                 const Lane& c, Buf& sb,
                                                 int k) {
    Col t3[3] = {};
#pragma unroll
    for (int i = 0; i < N; i++) mad(t3[i % 3], a[i], bs[i]);
    const Col t = sum3(t3[0], t3[1], t3[2]);
    // M = t p' mod R, from t = sum_i (w_i + 2^32 g_i) 2^(32 i)
    uint32_t w, g;
    fold(t, k, w, g);
    sb.w[k] = w;
    sb.g[k] = g;
    __syncwarp();
    uint32_t wv[N], gv[N];
    load(sb.w, wv);
    load(sb.g, gv);
    Col m3[3] = {};
#pragma unroll
    for (int i = 0; i < N; i++) {
      mad(m3[i % 3], wv[i], c.q[i]);
      mad(m3[(i + 1) % 3], gv[i], c.q1[i]);
    }
    uint32_t mk = resolve(sum3(m3[0], m3[1], m3[2]), k);
    if (k >= N) mk = 0;
    if constexpr (RB > 0) {
      if (k == N - 1) mk &= (1u << RB) - 1;
    }
    publish(sb.m, mk, k);
    uint32_t mv[N];
    load(sb.m, mv);
    // u = t + M p
    Col u3[3] = {t, {}, {}};
#pragma unroll
    for (int i = 0; i < N; i++) mad(u3[(i + 1) % 3], mv[i], c.p[i]);
    return resolve(sum3(u3[0], u3[1], u3[2]), k);
  }

  // word j of u / R mod R from u's published words: bits L W + 32 j ..
  // of u, words NF + j and NF + j + 1, the top word cut to R; zero for j
  // outside 0 .. N - 1. j may differ by lane: no branch, so the lanes
  // stay together.
  static __device__ __forceinline__ uint32_t word_at(const Buf& sb, int j) {
    const int jj = min(max(j, 0), N - 1);
    uint32_t r;
    if constexpr (RB > 0) {
      r = __funnelshift_r(sb.u[NF + jj], sb.u[NF + jj + 1], RB);
      if (jj == N - 1) r &= (1u << RB) - 1;
    } else {
      r = sb.u[N + jj];
    }
    return static_cast<unsigned>(j) < static_cast<unsigned>(N) ? r : 0u;
  }

  // every lane's copy of the N words of u / R mod R
  static __device__ __forceinline__ void words(const Buf& sb,
                                               uint32_t (&a)[N]) {
#pragma unroll
    for (int i = 0; i < N; i++) {
      if constexpr (RB > 0) {
        a[i] = __funnelshift_r(sb.u[NF + i], sb.u[NF + i + 1], RB);
      } else {
        a[i] = sb.u[N + i];
      }
    }
    if constexpr (RB > 0) a[N - 1] &= (1u << RB) - 1;
  }

  // Fermat's chain over p - 2 on warp 0, rows.py fermat_inv's bits:
  // from the Montgomery one, a squaring a bit from the top and a product
  // with x where the bit is set, each Tree::mul's function on the
  // operands of the one-thread chain. x: x's words; ebits: p - 2's words
  // in shared memory; sb: the warp's buffer; returns the inverse's word
  // k (zero from N up). Each multiply takes its operands straight from
  // the last one's u: the words in every lane, and lane k's words
  // k - i.
  static __device__ __forceinline__ uint32_t fermat(
      const uint32_t (&x)[N], const TreeConsts<L, W>& C,
      const uint32_t* ebits, Buf& sb, int k) {
    Lane c;
    lane_consts(c, C, k);
    uint32_t a[N], as[N], xs[N];
#pragma unroll
    for (int i = 0; i < N; i++) {
      a[i] = C.one[i];
      as[i] = xs[i] = 0;
#pragma unroll
      for (int j = 0; j < N; j++) {
        if (k - i == j) {
          as[i] = C.one[j];
          xs[i] = x[j];
        }
      }
    }
#pragma unroll 1
    for (int i = C.nbits - 1; i >= 0; i--) {
      publish(sb.u, mul(a, as, c, sb, k), k);      // a a
      words(sb, a);
      if ((ebits[i >> 5] >> (i & 31)) & 1) {
        __syncwarp();
        publish(sb.u, mul(a, xs, c, sb, k), k);    // (a a) x
        words(sb, a);
      }
#pragma unroll
      for (int j = 0; j < N; j++) as[j] = word_at(sb, k - j);
      __syncwarp();
    }
    return word_at(sb, k);
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
    if constexpr (warp_chain(N)) {
      // the root's inverse, on warp 0, lane k its word k
      __shared__ typename WarpMul<L, W>::Buf wbuf;
      if (t == 0) {
#pragma unroll
        for (int k = 0; k < N; k++) ebits[k] = C.e[k];
      }
      if (t < 32) {
        __syncwarp();
#pragma unroll
        for (int k = 0; k < N; k++) x[k] = S[up & 1][k][0];
        const uint32_t ik = WarpMul<L, W>::fermat(x, C, ebits, wbuf, t);
        __syncwarp();
        if (t < N) S[up & 1][t][0] = ik;
      }
    } else if (t == 0) {
      // the root's inverse, on thread 0: rows.py fermat_inv's bits
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
