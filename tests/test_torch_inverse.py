"""The port's batched inversion and affine normalisation
(tpu_msm_torch/ops/inverse.py) on CPU tensors, against
`tpu_msm.ops.inverse` bit for bit and against python-int arithmetic, on
the inputs of tests/test_inverse.py, for BN254_S12 and BN254_S13."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpu_msm_torch
from tpu_msm import constants as jc
from tpu_msm.ops import inverse as jinverse
from tpu_msm.ops.complete import ProjPoint
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.ops import inverse, rows
from tpu_msm_torch.utils.limbs_conversion import ints_to_planar

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

PROFILES = ["bn254_s12", "bn254_s13"]


@pytest.fixture(params=PROFILES)
def curves(request):
    return jc.CURVES[request.param], tc.CURVES[request.param]


def enc(vals, curve):
    return ints_to_planar(vals, curve.num_limbs,
                          curve.log_limb_size).astype(np.int32)


def dec_mont(t, curve):
    """Canonical Montgomery limbs (< 2p) -> standard-form ints."""
    w = curve.log_limb_size
    arr = t.numpy().astype(object)
    return [curve.from_mont(sum(int(arr[i, k]) << (w * i)
                                for i in range(arr.shape[0])) % curve.p)
            for k in range(arr.shape[1])]


def same(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


def test_fermat_inv(curves):
    J, T = curves
    rng = random.Random(47)
    vals = [0, 1, T.p - 1, 2] + [rng.randrange(1, T.p) for _ in range(4)]
    a = enc([T.to_mont(v) for v in vals], T)
    got = inverse.fermat_inv(torch.from_numpy(a), T)
    assert same(jinverse.fermat_inv(jnp.asarray(a), J), got)
    for v, g in zip(vals, dec_mont(got, T)):
        assert g == (pow(v, -1, T.p) if v else 0)


def test_batch_inverse_with_zeros_and_odd_size(curves):
    """K = 13 takes the power-of-two padding; the zeros take the
    substitute-and-mask path."""
    J, T = curves
    rng = random.Random(48)
    vals = [rng.randrange(1, T.p) for _ in range(13)]
    vals[3] = vals[8] = 0
    a = enc([T.to_mont(v) for v in vals], T)
    a[:, 8] = enc([T.p], T)[:, 0]                 # zero by value, limbs of p
    got = inverse.batch_inverse(torch.from_numpy(a), T)
    assert same(jinverse.batch_inverse(jnp.asarray(a), J), got)
    for v, g in zip(vals, dec_mont(got, T)):
        assert g == (pow(v, -1, T.p) if v else 0)
    # a (L, 2, 4) batch comes back in its own shape, elementwise equal to
    # fermat_inv
    b = a[:, :8].reshape(T.num_limbs, 2, 4)
    got = inverse.batch_inverse(torch.from_numpy(b), T)
    assert got.shape == b.shape
    fi = inverse.fermat_inv(torch.from_numpy(a[:, :8]), T)
    assert dec_mont(got.reshape(T.num_limbs, 8), T) == dec_mont(fi, T)


def test_reduce_once_boundaries(curves):
    J, T = curves
    vals = [0, 1, T.p - 1, T.p, T.p + 1, 2 * T.p - 1]
    a = enc(vals, T)
    got = inverse.reduce_once(torch.from_numpy(a), T)
    assert same(jinverse.reduce_once(jnp.asarray(a), J), got)
    assert same(enc([v % T.p for v in vals], T), got)
    assert same(jinverse.is_zero_val(jnp.asarray(a), J),
                inverse.is_zero_val(torch.from_numpy(a), T))
    assert inverse.is_zero_val(torch.from_numpy(a), T).tolist() == [
        True, False, False, True, False, False]


def test_to_affine(curves):
    """Random affine points scaled by a random projective Z, and one
    infinity lane (0 : 1 : 0); stacked and ProjRows inputs."""
    J, T = curves
    rng = random.Random(49)
    n = 6
    pts = [(rng.randrange(1, T.p), rng.randrange(1, T.p)) for _ in range(n)]
    zs = [rng.randrange(1, T.p) for _ in range(n)]
    X = [T.to_mont(x * z % T.p) for (x, _), z in zip(pts, zs)] + [0]
    Y = [T.to_mont(y * z % T.p) for (_, y), z in zip(pts, zs)] + [
        T.to_mont(1)]
    Z = [T.to_mont(z) for z in zs] + [0]
    x, y, z = enc(X, T), enc(Y, T), enc(Z, T)
    # lazy limbs as the pipeline hands them over: same values, signed limbs
    x[0] -= 1 << T.log_limb_size
    x[1] += 1
    stacked = torch.from_numpy(np.stack([x, y, z]))
    ax, ay, inf = tpu_msm_torch.to_affine(stacked, T)
    want = jinverse.to_affine(ProjPoint(*map(jnp.asarray, (x, y, z))), J)
    for w, g in zip(want, (ax, ay, inf)):
        assert same(w, g)
    assert inf.tolist() == [False] * n + [True]
    assert list(zip(dec_mont(ax, T), dec_mont(ay, T))) == pts + [(0, 0)]
    limb_max = int(max(ax.max(), ay.max()))
    assert limb_max < (1 << T.log_limb_size)
    rx, ry, rinf = inverse.to_affine_plain(rows.ProjRows(*stacked), T)
    assert torch.equal(rx, ax) and torch.equal(ry, ay)
    assert torch.equal(rinf, inf)


def test_to_affine_lazy_zero_z():
    """Z of value 2p or 3p is infinity too: the window sums of all-zero
    digits come out so. (The JAX function takes such a Z for non-zero and
    loses every lane, so this case is held against python ints only.)"""
    T = tc.BN254_S12
    rng = random.Random(50)
    pts = [(rng.randrange(1, T.p), rng.randrange(1, T.p)) for _ in range(3)]
    zs = [rng.randrange(1, T.p) for _ in range(3)]
    X = [T.to_mont(x * z % T.p) + T.p for (x, _), z in zip(pts, zs)]
    Y = [T.to_mont(y * z % T.p) + 2 * T.p for (_, y), z in zip(pts, zs)]
    Z = [T.to_mont(z) + 3 * T.p for z in zs]
    stacked = torch.from_numpy(np.stack([
        enc(X + [0, 5], T), enc(Y + [T.to_mont(1), 7], T),
        enc(Z + [2 * T.p, 3 * T.p], T)]))
    ax, ay, inf = inverse.to_affine_plain(stacked, T)
    assert inf.tolist() == [False, False, False, True, True]
    assert list(zip(dec_mont(ax, T), dec_mont(ay, T))) == pts + [(0, 0)] * 2


def test_public_exports():
    assert tpu_msm_torch.to_affine is kernels.to_affine
    assert kernels.to_affine_plain is inverse.to_affine_plain
    assert tpu_msm_torch.batch_inverse is kernels.batch_inverse
    assert kernels.batch_inverse_plain is inverse.batch_inverse
    assert {"to_affine", "batch_inverse"} <= set(tpu_msm_torch.__all__)
