"""`to_affine`'s plain version (tpu_msm_torch/ops/inverse.py
`to_affine_plain`) and the algorithm of its kernel (csrc/to_affine.cu) on
CPU tensors.

`to_affine_plain` is held bit for bit against `tpu_msm.ops.inverse.
to_affine` on the inputs of tests/test_inverse.py (random affine points
scaled by a random Z, one lane at infinity), with Z of value 0 and p
added, at BN254_S12 and BLS12_377_S12; int16 limbs and the batch shapes
(3, L, W) and (3, L, a, b) give the same bits. Z of value 2p or 3p (the
fault of the JAX function that the port repairs, ROADMAP C) is held
against python-int arithmetic only.

The kernel runs one Fermat chain a point where the plain version runs a
product tree; `chain_affine` replays the kernel's steps on `ops/rows.py`
(z = Z one, the zero test, z^(p - 2) from the Montgomery one, X zinv and
Y zinv reduced once, zeroed at infinity) and must give the plain
version's bits on lazy limbs across the ledger. No tolerance."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpu_msm_torch
from tpu_msm import constants as jc
from tpu_msm.ops import inverse as jinverse
from tpu_msm.ops.complete import ProjPoint
from tpu_msm_torch import _build
from tpu_msm_torch.constants import BLS12_377_S12, BN254_S12, BN254_S13
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.ops import inverse, rows
from tpu_msm_torch.utils.limbs_conversion import ints_to_planar

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

CURVES = (BN254_S12, BLS12_377_S12)


def enc(vals, curve):
    return ints_to_planar(vals, curve.num_limbs,
                          curve.log_limb_size).astype(np.int32)


def dec_mont(t, curve):
    w = curve.log_limb_size
    arr = t.reshape(t.shape[0], -1).numpy().astype(object)
    return [curve.from_mont(sum(int(arr[i, k]) << (w * i)
                                for i in range(arr.shape[0])) % curve.p)
            for k in range(arr.shape[1])]


def points(curve, n, seed, z_extra=()):
    """n random affine points scaled by a random Z (in the Montgomery
    domain), one lane at infinity (0 : 1 : 0), then a lane for each Z
    value in z_extra (any X, Y). Returns the stacked (3, L, K) int32
    tensor and the affine points (None at infinity)."""
    rng = random.Random(seed)
    p = curve.p
    pts = [(rng.randrange(1, p), rng.randrange(1, p)) for _ in range(n)]
    zs = [rng.randrange(1, p) for _ in range(n)]
    X = [curve.to_mont(x * z % p) for (x, _), z in zip(pts, zs)] + [0]
    Y = [curve.to_mont(y * z % p) for (_, y), z in zip(pts, zs)] + [
        curve.to_mont(1)]
    Z = [curve.to_mont(z) for z in zs] + [0]
    for z in z_extra:
        X.append(rng.randrange(p))
        Y.append(rng.randrange(p))
        Z.append(z)
    stacked = torch.from_numpy(np.stack([enc(X, curve), enc(Y, curve),
                                         enc(Z, curve)]))
    return stacked, pts + [None] * (1 + len(z_extra))


def lazy(t, curve, seed):
    """The same values as signed lazy limbs: borrow a unit of the next
    limb into a random half of the limbs below the top."""
    rng = np.random.default_rng(seed)
    t = t.clone()
    move = torch.from_numpy(rng.random(t[:, :-1].shape) < 0.5)
    t[:, :-1] += move.to(torch.int32) << curve.log_limb_size
    t[:, 1:] -= move.to(torch.int32)
    return t


def check_affine(curve, ax, ay, inf, want):
    assert inf.tolist() == [w is None for w in want]
    got = list(zip(dec_mont(ax, curve), dec_mont(ay, curve)))
    assert got == [w or (0, 0) for w in want]
    for v in (ax, ay):       # fully reduced
        assert all(a < curve.p for a in (
            sum(int(l) << (curve.log_limb_size * i) for i, l in
                enumerate(col)) for col in v.reshape(v.shape[0], -1).T))


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_to_affine_plain_matches_jax(curve):
    """The inputs of tests/test_inverse.py with Z of value 0 and p
    added; stacked limbs signed as the pipeline hands them over."""
    stacked, want = points(curve, 6, 49, z_extra=(0, curve.p))
    stacked = lazy(stacked, curve, 50)
    ax, ay, inf = inverse.to_affine_plain(stacked, curve)
    jw = jinverse.to_affine(ProjPoint(*(jnp.asarray(c.numpy())
                                        for c in stacked)),
                            jc.CURVES[curve.name])
    for w, g in zip(jw, (ax, ay, inf)):
        assert np.array_equal(np.asarray(w), g.numpy())
    check_affine(curve, ax, ay, inf, want)
    # the public wrapper takes the plain version for CPU tensors
    for w, g in zip((ax, ay, inf), tpu_msm_torch.to_affine(stacked, curve)):
        assert torch.equal(w, g)


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_to_affine_int16_and_batch_shapes(curve):
    """int16 limbs give the int32 bits; (3, L, W) and (3, L, a, b) come
    back in their own shape, lane for lane the flat result."""
    stacked, _ = points(curve, 7, 51)                   # K = 8
    flat = kernels.to_affine(stacked, curve)
    small = kernels.to_affine(stacked.to(torch.int16), curve)
    for a, b in zip(flat, small):
        assert torch.equal(a, b)
    L = curve.num_limbs
    for shape in ((8,), (2, 4), (4, 2)):
        got = kernels.to_affine(stacked.reshape((3, L) + shape), curve)
        assert got[0].shape == got[1].shape == (L,) + shape
        assert got[2].shape == shape
        for a, b in zip(flat, got):
            assert torch.equal(a, b.reshape(a.shape))


@pytest.mark.parametrize("curve", CURVES + (BN254_S13,),
                         ids=lambda c: c.name)
def test_to_affine_lazy_zero_z_against_ints(curve):
    """Z of value 2p and 3p is infinity too (the JAX function takes it
    for non-zero and loses every lane, so this case is held against
    python ints only), beside lanes of X, Y, Z values above 2p."""
    p = curve.p
    stacked, want = points(curve, 3, 52, z_extra=(2 * p, 3 * p, 0, p))
    v = stacked.clone()
    for c, k in ((0, 1), (1, 2), (2, 3)):               # + k p, lazy
        v[c, :, :3] = torch.from_numpy(enc(
            [sum(int(l) << (curve.log_limb_size * i)
                 for i, l in enumerate(col)) + k * p
             for col in v[c, :, :3].T.tolist()], curve))
    ax, ay, inf = kernels.to_affine(lazy(v, curve, 53), curve)
    check_affine(curve, ax, ay, inf, want)


def chain_affine(stacked, curve):
    """The kernel's steps, one Fermat chain a point, on ops/rows.py."""
    px, py, pz = (c.to(torch.int32) for c in stacked)
    z = rows.mont_mul_rows(pz, rows.mont_one_rows(curve, pz), curve)
    inf = inverse.is_zero_val(z, curve)
    zinv = inverse.fermat_inv(z, curve)
    out = []
    for c in (px, py):
        v = inverse.reduce_once(rows.mont_mul_rows(c, zinv, curve), curve)
        out.append(torch.where(inf, torch.zeros_like(v), v))
    return out[0], out[1], inf


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_kernel_chain_matches_plain(curve):
    """Lazy limbs whose values run up the ledger (X, Y below 4p), Z of
    value 0, p, 2p and 3p: the chain a point gives the product tree's
    bits."""
    p = curve.p
    stacked, _ = points(curve, 9, 54, z_extra=(0, p, 2 * p, 3 * p))
    rng = random.Random(55)
    K = stacked.shape[2]
    X = [rng.randrange(4 * p) for _ in range(K)]
    Y = [rng.randrange(4 * p) for _ in range(K)]
    X[0], Y[0] = 4 * p - 1, 0
    v = stacked.clone()
    v[0], v[1] = torch.from_numpy(enc(X, curve)), torch.from_numpy(
        enc(Y, curve))
    v = lazy(v, curve, 56)
    want = inverse.to_affine_plain(v, curve)
    got = chain_affine(v, curve)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_to_affine_cpu_path_and_refusals(monkeypatch):
    def refuse(*_):
        raise AssertionError("a CUDA call on the CPU path")

    c = BN254_S12
    stacked, _ = points(c, 2, 57)
    monkeypatch.setattr(_build, "library", refuse)
    kernels.reset_launches()
    kernels.to_affine(stacked, c)
    kernels.to_affine(rows.ProjRows(*stacked), c)
    assert set(kernels.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):                 # mixed devices
        kernels.to_affine(rows.ProjRows(stacked[0], stacked[1],
                                        stacked[2].to("meta")), c)


@pytest.mark.parametrize("curve", CURVES + (BN254_S13,),
                         ids=lambda c: c.name)
def test_affine_consts_layout(curve):
    """Words of AffineConsts<L, W> (csrc/to_affine.cu): WideConsts (NF
    words of p, n0, N of R^2), R mod p and p - 2 in N words, the bit
    length."""
    bits = curve.num_limbs * curve.log_limb_size
    n, nf = -(-bits // 32), bits // 32
    words = kernels._affine_consts_host(curve)
    assert len(words) == nf + 1 + 3 * n + 1
    val = lambda ws: sum(v << (32 * i) for i, v in enumerate(ws))
    assert val(words[nf + 1 + n:][:n]) == curve.r_mod_p
    assert val(words[nf + 1 + 2 * n:][:n]) == curve.p - 2
    assert words[-1] == (curve.p - 2).bit_length()
