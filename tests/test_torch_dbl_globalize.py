"""The plain versions of `pdbl_batch` and `globalize`
(tpu_msm_torch/cuzk/kernels.py) against the JAX package, bit for bit, on
CPU tensors.

TINY62: against the Pallas kernels in interpret mode. `globalize` goes
through the layout map between the TPU kernel's (3*L*8, R*F8) buffer
(row (c*L + i)*8 + s8, column r*F8 + j) and the port's (3, L, R, F) with
lane f = s8*F8 + j. BN254_S12 and BN254_S13: `pdbl_batch` against
`tpu_msm.ops.complete.pdbl`. Also `pdbl_batch(p)` equal in the group to
`padd_batch(p, p)`, and `globalize` equal to `padd_batch` with S
expanded over the rows."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm.ops.complete import ProjPoint, pdbl
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import (planar_signed_to_ints_modp,
                                                  points_to_planar)

from test_torch_kernels import lazy_points, t

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# pdbl_batch
# ---------------------------------------------------------------------------


def test_pdbl_batch_tiny_vs_pallas():
    p = lazy_points(jc.TINY62, np.random.default_rng(11), (2, 16))
    want = np.asarray(jk.pdbl_batch(jnp.asarray(p), jc.TINY62))
    got = tk.pdbl_batch(t(p), tc.TINY62)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["bn254_s12", "bn254_s13"])
def test_pdbl_batch_vs_complete_pdbl(name):
    J, T = jc.CURVES[name], tc.CURVES[name]
    p = lazy_points(J, np.random.default_rng(12), (2, 8))
    jp = jnp.asarray(p)
    want = np.asarray(jnp.stack(tuple(pdbl(ProjPoint(jp[0], jp[1], jp[2]),
                                           J))))
    assert np.array_equal(tk.pdbl_batch(t(p), T).numpy(), want)


def test_pdbl_batch_is_padd_of_itself():
    """2P by the doubling formula and P + P by the complete add are one
    group element (different limbs), on real curve points and infinity."""
    C = tc.BN254_S12
    pts, _ = ref.gen_points_scalars(C, 5, seed=13)
    xs, ys = points_to_planar(pts, C)
    x = tk.encode_mont(t(xs.astype(np.int32)), C)
    y = tk.encode_mont(t(ys.astype(np.int32)), C)
    inf = tk.inf_stacked(C, (6,))
    p = inf.clone()
    p[0, :, :5], p[1, :, :5], p[2, :, :5] = x, y, inf[1, :, :5]
    d = tk.pdbl_batch(p, C).numpy()
    a = tk.padd_batch(p, p, C).numpy()
    dz = planar_signed_to_ints_modp(d[2], C)
    az = planar_signed_to_ints_modp(a[2], C)
    assert dz[5] == 0 and az[5] == 0                     # 2 * infinity
    for c in range(2):
        dv = planar_signed_to_ints_modp(d[c], C)
        av = planar_signed_to_ints_modp(a[c], C)
        for i in range(5):
            assert dz[i] and az[i]
            assert dv[i] * az[i] % C.p == av[i] * dz[i] % C.p, (c, i)
    want = ref.dbl(C, (*pts[0], 1))
    zi = pow(dz[0], -1, C.p)
    got = tuple(planar_signed_to_ints_modp(d[c], C)[0] * zi % C.p
                for c in range(2)) + (1,)
    assert ref.jac_eq(C, got, want)


# ---------------------------------------------------------------------------
# globalize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dt", [np.int16, np.int32])
def test_globalize_tiny_vs_pallas(in_dt):
    R, F8 = 3, 2
    L, F = jc.TINY62.num_limbs, 8 * F8
    rng = np.random.default_rng(14)
    T = lazy_points(jc.TINY62, rng, (R, F), in_dt)
    S = lazy_points(jc.TINY62, rng, (F,), in_dt)
    t8 = (T.reshape(3, L, R, 8, F8).transpose(0, 1, 3, 2, 4)
          .reshape(3 * L * 8, R * F8))
    s8 = S.reshape(3 * L * 8, F8)
    g8 = np.asarray(jk.globalize(jnp.asarray(t8.astype(np.int32)),
                                 jnp.asarray(s8.astype(np.int32)),
                                 jc.TINY62, F8))
    want = (g8.reshape(3, L, 8, R, F8).transpose(0, 1, 3, 2, 4)
            .reshape(3, L, R, F))
    got = tk.globalize(t(T), t(S), tc.TINY62)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    got16 = tk.globalize(t(T), t(S), tc.TINY62, out_dtype=torch.int16)
    assert got16.dtype == torch.int16
    assert np.array_equal(got16.numpy(), want.astype(np.int16))


def test_globalize_s12_is_padd_with_s_expanded():
    C = tc.BN254_S12
    R, F = 3, 8
    rng = np.random.default_rng(15)
    T = t(lazy_points(C, rng, (R, F), np.int16))
    S = t(lazy_points(C, rng, (F,), np.int16))
    want = tk.padd_batch(T, S[:, :, None].expand(3, C.num_limbs, R, F)
                         .contiguous(), C)
    assert torch.equal(tk.globalize(T, S, C), want)


def test_globalize_refuses_mismatched_shapes_and_dtypes():
    T = torch.zeros((3, 6, 2, 8), dtype=torch.int16)
    with pytest.raises(ValueError):
        tk.globalize(T, torch.zeros((3, 6, 4), dtype=torch.int16), tc.TINY62)
    with pytest.raises(ValueError):
        tk.globalize(T, torch.zeros((3, 6, 8), dtype=torch.int32), tc.TINY62)
