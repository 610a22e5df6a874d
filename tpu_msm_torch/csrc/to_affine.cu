// Projective to affine, (X : Y : Z) -> (X / Z, Y / Z) and the infinity
// mask, on the product tree of batch_inv.cuh.
//
// Replaces the XLA-compiled tpu_msm/ops/inverse.py `to_affine` (no
// pallas_call: XLA fused its loop). Its plain version, ops/inverse.py
// `to_affine_plain`, is the same product tree in torch ops, with a
// Fermat chain of dozens of torch launches a multiply at its root.
// Bound on the H100: bytes at BN254_S12, the operations close behind
// (operations at BLS12-377): a point reads 3 L limbs and writes 2 L and a
// flag (441 B at L = 22), against 6 word-wide Montgomery multiplies
// (Montgomery's trick: Z one, one going up, two coming down, X zinv and
// Y zinv) and, once a call, the root's chain of about 370 dependent
// multiplies on one thread.
// Design: the tree of batch_inv.cuh, whose ends are
//   leaf  z = Z * one                 (Z's value into [0, 2p) before the
//                                      zero test: a lazy Z of value 2p
//                                      or 3p is infinity too)
//         inf = z is 0 or p           (the flag the tree keeps)
//   sink  x, y = reduce_once(X zinv), reduce_once(Y zinv), zeroed where
//         inf
// so a point costs the 6 multiplies, the tree's scratch traffic and one
// chain a call: one launch of one block up to 1,024 points (the window
// sums), three up to 2^20. Every step is the plain version's, so the
// outputs are its bits (and, fully reduced, unique).
#include "batch_inv.cuh"

namespace {

template <int L, int W>
struct AffineEnds {
  using Tr = msm::Tree<L, W>;
  static constexpr int N = Tr::N;
  struct Args {
    const int32_t* x;
    const int32_t* y;
    const int32_t* z;
    int32_t* ax;
    int32_t* ay;
  };

  static __device__ __forceinline__ bool leaf(const Args& E,
                                              const msm::TreeConsts<L, W>& C,
                                              int64_t K, int64_t f,
                                              uint32_t (&w)[N]) {
    uint32_t z[N];
    Tr::load(E.z, K, f, z);
    Tr::mul(z, C.one, w, C.wide);
    return Tr::is_zero(w, C.wide);
  }

  static __device__ __forceinline__ void sink(const Args& E,
                                              const msm::TreeConsts<L, W>& C,
                                              int64_t K, int64_t f,
                                              const uint32_t (&zinv)[N],
                                              bool inf) {
#pragma unroll 1
    for (int c = 0; c < 2; c++) {
      uint32_t v[N], r[N];
      Tr::load(c ? E.y : E.x, K, f, v);
      Tr::mul(v, zinv, r, C.wide);
      Tr::reduce_once(r, C.wide);
      Tr::store(r, inf, c ? E.ay : E.ax, K, f);
    }
  }
};

template <int L, int W>
__global__ void __launch_bounds__(msm::kTreeThreads)
to_affine_kernel(const msm::TreeLaunch P,
                 const typename AffineEnds<L, W>::Args E,
                 const msm::TreeConsts<L, W> C) {
  msm::tree_run<L, W, AffineEnds>(P, E, C);
}

}  // namespace

// One launch of the plan cuzk/kernels.py `batch_inverse_geometry` makes
// for K points. x, y, z: (L, K) int32 planes; ax, ay: (L, K) int32; inf:
// K flags; scratch: N word planes of 2 Kp words; consts: host memory,
// `words` words of TreeConsts<L, W> in its layout.
extern "C" int msm_to_affine(int num_limbs, int limb_bits, const int32_t* x,
                             const int32_t* y, const int32_t* z, int64_t K,
                             int32_t* ax, int32_t* ay, uint8_t* inf,
                             uint32_t* scratch, int64_t Kp, int lo, int n,
                             int d, int roles, int64_t blocks,
                             const uint32_t* consts, int words,
                             void* stream) {
  int rc = 0;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    const AffineEnds<L, W>::Args E{x, y, z, ax, ay};
    rc = msm::tree_launch<L, W>(to_affine_kernel<L, W>, scratch, inf, K, Kp,
                                lo, n, d, roles, blocks, E, consts, words,
                                stream);
  });
  return rc;
}
