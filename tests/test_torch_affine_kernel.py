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

The kernel walks the plain version's product tree (csrc/batch_inv.cuh);
`_torch_tree.tree_affine` replays its launches on `ops/rows.py` (the
leaves z = Z one and the zero test on them, the tree split into blocks
of 2, 4 and 8 leaves as well as the kernel's 1,024, the root's chain, X
zinv and Y zinv reduced once, zeroed at infinity) and must give the
plain version's bits on lazy limbs across the ledger, with Z of value 0,
p, 2p and 3p. No tolerance."""

import functools
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_tree as tree
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


# (threads_log, reg_log) of the replayed plan, as in
# tests/test_torch_batch_inverse_kernel.py
SPLITS = {"b1": (0, 1), "b2": (1, 1), "b2_shared": (2, 0), "b3": (1, 2),
          "kernel": (kernels.TREE_THREADS_LOG, kernels.TREE_REG_LOG)}


CURVES_BY_NAME = {c.name: c for c in CURVES}


@functools.lru_cache(maxsize=None)
def ledger_points(name: str, n: int):
    """n random points scaled by a random Z, a lane at infinity and lanes
    of Z = 0, p, 2p, 3p, then X and Y replaced by values up the ledger
    (below 4p, one lane at 4p - 1 and 0) as lazy limbs; and the plain
    version's result on them."""
    curve = CURVES_BY_NAME[name]
    p = curve.p
    stacked, _ = points(curve, n, 54, z_extra=(0, p, 2 * p, 3 * p))
    rng = random.Random(55)
    K = stacked.shape[2]
    X = [rng.randrange(4 * p) for _ in range(K)]
    Y = [rng.randrange(4 * p) for _ in range(K)]
    X[0], Y[0] = 4 * p - 1, 0
    v = stacked.clone()
    v[0], v[1] = torch.from_numpy(enc(X, curve)), torch.from_numpy(
        enc(Y, curve))
    v = lazy(v, curve, 56)
    return v, inverse.to_affine_plain(v, curve)


@pytest.mark.parametrize("n", (9, 95))
@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(CURVES_BY_NAME))
def test_kernel_tree_matches_plain(name, split, n):
    """The kernel's launches, replayed with its ends (z = Z one and the
    flag at the leaves, X zinv and Y zinv reduced once at the end), give
    the plain version's bits: K = 14 and 100 lanes, Z of value 0, p, 2p
    and 3p at the last four."""
    curve = CURVES_BY_NAME[name]
    v, want = ledger_points(name, n)
    geo = kernels.batch_inverse_geometry(v.shape[2], *SPLITS[split])
    got = tree.tree_affine(v, curve, geo)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert got[2][-4:].all()


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
    """Words of TreeConsts<L, W> (csrc/batch_inv.cuh): WideConsts (NF
    words of p, n0, N of R^2), R mod p, p - 2 and the warp multiply's
    -p^-1 mod 2^(32 N) in N words, the bit length."""
    bits = curve.num_limbs * curve.log_limb_size
    n, nf = -(-bits // 32), bits // 32
    words = kernels._affine_consts_host(curve)
    assert len(words) == nf + 1 + 4 * n + 1
    val = lambda ws: sum(v << (32 * i) for i, v in enumerate(ws))
    assert val(words[nf + 1 + n:][:n]) == curve.r_mod_p
    assert val(words[nf + 1 + 2 * n:][:n]) == curve.p - 2
    assert (val(words[nf + 1 + 3 * n:][:n]) * curve.p + 1) % (
        1 << (32 * n)) == 0
    assert words[-1] == (curve.p - 2).bit_length()
