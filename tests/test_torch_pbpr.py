"""pbpr_full's plain version (tpu_msm_torch/cuzk/kernels.py) against the
JAX Pallas kernel in interpret mode on TINY62, bit for bit, and on
BN254_S12 against the weighted-sum oracle by group value. In a file of
its own: the interpret-mode kernel alone takes tens of seconds."""

import numpy as np
import jax.numpy as jnp
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import (planar_signed_to_ints_modp,
                                                  points_to_planar)

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)


def mont_buckets(curve, pts, shape, kill):
    """Affine points -> (3, L, *shape) int16 Montgomery projective buckets
    (canonical limbs, Z = 1), with infinity where `kill` is set."""
    L = curve.num_limbs
    xs, ys = points_to_planar(pts, curve)
    x = tk.encode_mont_plain(torch.from_numpy(xs.astype(np.int32)), curve)
    y = tk.encode_mont_plain(torch.from_numpy(ys.astype(np.int32)), curve)
    inf = tk.inf_stacked(curve, (len(pts),))
    b = torch.stack([x, y, inf[1]])
    b = torch.where(torch.from_numpy(kill.reshape(-1)), inf, b)
    return b.reshape((3, L) + shape).to(torch.int16)


def test_pbpr_full_tiny_vs_pallas():
    W, B, T = 4, 16, 4
    C = tc.TINY62
    pts, _ = ref.gen_points_scalars(C, W * B, seed=33)
    kill = np.random.default_rng(47).random((W, B)) < 0.3
    buckets = mont_buckets(C, pts, (W, B), kill)
    want = np.asarray(jk.pbpr_full(jnp.asarray(buckets.numpy()), jc.TINY62,
                                   T))
    got = tk.pbpr_full(buckets, C, T)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_pbpr_full_s12_weighted_sums():
    W, B, T = 2, 16, 4
    C = tc.BN254_S12
    pts, _ = ref.gen_points_scalars(C, W * B, seed=34)
    kill = np.random.default_rng(48).random((W, B)) < 0.3
    out = tk.pbpr_full(mont_buckets(C, pts, (W, B), kill), C, T).numpy()
    xs, ys, zs = (planar_signed_to_ints_modp(out[c], C) for c in range(3))
    for w in range(W):
        want = ref.INF
        for b in range(B):
            if not kill[w, b]:
                want = ref.add(C, want, ref.scalar_mul(
                    C, (*pts[w * B + b], 1), b + 1))
        z = zs[w]
        got = ref.INF if z == 0 else (xs[w] * pow(z, -1, C.p) % C.p,
                                      ys[w] * pow(z, -1, C.p) % C.p, 1)
        assert ref.jac_eq(C, got, want), w
