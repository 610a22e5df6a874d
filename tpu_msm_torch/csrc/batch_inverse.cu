// Batched Montgomery inversion, a -> a^-1 elementwise (zero to zero), on
// the product tree of batch_inv.cuh.
//
// Replaces the XLA-compiled tpu_msm/ops/inverse.py `batch_inverse` (no
// pallas_call). Its plain version, ops/inverse.py `batch_inverse`, is the
// same tree in torch ops, a dozen launches a multiply, with a Fermat
// chain of some 360 of them at its root.
// Bound on the H100: operations, the bytes close behind: an element
// reads L limbs and writes L (176 B at L = 22) against 3 word-wide
// Montgomery multiplies (one going up, two coming down) and, once a
// call, the root's chain of about 370 dependent multiplies on one
// thread.
// Design: the tree of batch_inv.cuh, whose ends load an element's
// canonical limbs as words (the zero test on them) and store its
// inverse's limbs, zeroed where it was zero. The output is the plain
// version's, bit for bit: canonical limbs below 2p, which are not
// unique, so the tree, its operand order and its chain are the plain
// version's own.
#include "batch_inv.cuh"

namespace {

template <int L, int W>
struct InverseEnds {
  using Tr = msm::Tree<L, W>;
  static constexpr int N = Tr::N;
  struct Args {
    const int32_t* a;
    int32_t* out;
  };

  static __device__ __forceinline__ bool leaf(const Args& E,
                                              const msm::TreeConsts<L, W>& C,
                                              int64_t K, int64_t f,
                                              uint32_t (&w)[N]) {
    Tr::load(E.a, K, f, w);
    return Tr::is_zero(w, C.wide);
  }

  static __device__ __forceinline__ void sink(const Args& E,
                                              const msm::TreeConsts<L, W>&,
                                              int64_t K, int64_t f,
                                              const uint32_t (&inv)[N],
                                              bool zero) {
    Tr::store(inv, zero, E.out, K, f);
  }
};

template <int L, int W>
__global__ void __launch_bounds__(msm::kTreeThreads)
batch_inverse_kernel(const msm::TreeLaunch P,
                     const typename InverseEnds<L, W>::Args E,
                     const msm::TreeConsts<L, W> C) {
  msm::tree_run<L, W, InverseEnds>(P, E, C);
}

}  // namespace

// One launch of the plan cuzk/kernels.py `batch_inverse_geometry` makes
// for K elements. a, out: (L, K) int32 planes; zero: K flags; scratch: N
// word planes of 2 Kp words; consts: host memory, `words` words of
// TreeConsts<L, W> in its layout.
extern "C" int msm_batch_inverse(int num_limbs, int limb_bits,
                                 const int32_t* a, int64_t K, int32_t* out,
                                 uint8_t* zero, uint32_t* scratch, int64_t Kp,
                                 int lo, int n, int d, int roles,
                                 int64_t blocks, const uint32_t* consts,
                                 int words, void* stream) {
  int rc = 0;
  MSM_DISPATCH_PROFILE(num_limbs, limb_bits, {
    const InverseEnds<L, W>::Args E{a, out};
    rc = msm::tree_launch<L, W>(batch_inverse_kernel<L, W>, scratch, zero, K,
                                Kp, lo, n, d, roles, blocks, E, consts, words,
                                stream);
  });
  return rc;
}
