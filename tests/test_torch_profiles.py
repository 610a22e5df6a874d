"""The port at the profiles beyond BN254_S12: BN254_S13 (L = 21, w = 13),
BLS12_377_S12 (L = 32, w = 12) and BLS12_377_S13 (L = 30, w = 13), on
CPU tensors, against the JAX package.

Every kernel's plain version bit for bit against the JAX package's
non-Pallas counterpart of its body, as tests/test_torch_kernels.py does
at BN254_S12: `encode_mont` against `rows.to_mont_rows`, `padd_batch`
and `psub_batch` against `rows.padd_rows`, `pdbl_batch` against
`rows.pdbl_rows`, `prefix_scan` against a `rows.pmadd_rows` chain,
`col_prefix` against the levels of `rows.padd_rows`, `globalize` against
`rows.padd_rows` of S broadcast over the rows; `pbpr_full` and
`pbpr_stage1` against the weighted sums by group value, as
tests/test_torch_pbpr.py does. The slice (`tpu_variable_base_msm` with
device="cpu") at both BLS12-377 profiles against the JAX package's
reference `msm_pippenger_signed` by exact group equality, with GLV on
BLS12_377_S12 too. And `convert.from_jax` on a BLS12-377 config,
`glv.derive` against the JAX one, `to_affine` against the JAX one at
BLS12_377_S13, and the refusal of the F and base profiles."""

import dataclasses
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm import glv as jglv
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import kernels as jk
from tpu_msm.cuzk import pipeline as jpipeline
from tpu_msm.ops import inverse as jinverse
from tpu_msm.ops import rows as jrows
from tpu_msm.ops.complete import ProjPoint
from tpu_msm.reference import curve as jref
from tpu_msm_torch import constants as tc
from tpu_msm_torch import convert, glv, to_affine
from tpu_msm_torch.config import MSMConfig, default_config
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.cuzk.pipeline import get_pipeline, tpu_variable_base_msm
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import (ints_to_planar,
                                                  planar_signed_to_ints_modp)

from test_torch_kernels import canon, jproj, jstack, lazy_points, scan_inputs
from test_torch_pbpr import mont_buckets

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

PROFILES = ["bn254_s13", "bls12_377_s12", "bls12_377_s13"]


@pytest.fixture(params=PROFILES)
def curves(request):
    return jc.CURVES[request.param], tc.CURVES[request.param]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------


def test_encode_mont_vs_rows(curves):
    J, T = curves
    xs = canon(J, np.random.default_rng(2), (4, 16))
    xs[:, 0, :3] = ints_to_planar([0, 1, T.p - 1], T.num_limbs,
                                  T.log_limb_size)
    want = np.asarray(jrows.to_stacked(
        jrows.to_mont_rows(jrows.from_stacked(jnp.asarray(xs)), J)))
    assert np.array_equal(tk.encode_mont(t(xs), T).numpy(), want)


def test_padd_psub_vs_rows(curves):
    J, T = curves
    rng = np.random.default_rng(5)
    p = lazy_points(J, rng, (2, 8), np.int16)
    q = lazy_points(J, rng, (2, 8), np.int16)
    q[..., 0, 0] = p[..., 0, 0]                     # P + P
    want = jstack(jrows.padd_rows(jproj(p), jproj(q), J))
    got = tk.padd_batch(t(p), t(q), T)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    qn = np.asarray(jk.pneg_stacked(jnp.asarray(q), J))
    assert np.array_equal(tk.pneg_stacked(t(q), T).numpy(), qn)
    want = jstack(jrows.padd_rows(jproj(p), jproj(qn), J))
    got = tk.psub_batch(t(p), t(q), T, out_dtype=torch.int16)
    assert np.array_equal(got.numpy(), want.astype(np.int16))


def test_pdbl_vs_rows(curves):
    J, T = curves
    p = lazy_points(J, np.random.default_rng(6), (3, 7))
    want = jstack(jrows.pdbl_rows(jproj(p), J))
    got = tk.pdbl_batch(t(p), T)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_prefix_scan_vs_pmadd_chain(curves):
    J, T = curves
    Wg, C, R = 2, 3, 3
    X, Y, pay, rows16 = scan_inputs(J, Wg, C, R, 7)
    pos = np.arange(C) * R
    acc = jrows.proj_infinity_rows(J, jnp.zeros(Wg * C, jnp.int32))
    steps = []
    for r in range(R):
        v = pay[:, pos + r].reshape(-1)
        x = jrows.from_stacked(jnp.asarray(X[:, v >> 1]))
        y = jrows.from_stacked(jnp.asarray(Y[:, v >> 1]))
        y = jrows.select_rows(jnp.asarray((v & 1) != 0),
                              jrows.neg_rows(y, J, 2), y)
        acc = jrows.pmadd_rows(acc, x, y, J)
        steps.append(jstack(acc))
    want = np.stack(steps, axis=2).astype(np.int16)           # (3,L,R,F)
    got = tk.prefix_scan(t(rows16), t(pay), T, C)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)


def test_col_prefix_vs_rows_levels(curves):
    """The TPU kernel's level order, replayed with eager JAX rows."""
    J, T = curves
    Wg, C = 2, 4
    coltot = lazy_points(J, np.random.default_rng(9), (Wg, C), np.int16)
    inf = np.asarray(jstack(jrows.proj_infinity_rows(
        J, jnp.zeros((Wg, C), jnp.int32))))
    v = np.concatenate([inf[..., :1], coltot[..., :-1].astype(np.int32)], -1)
    for lv in range(2):
        k = 1 << lv
        sh = np.concatenate([inf[..., :k], v[..., :C - k]], -1)
        v = jstack(jrows.padd_rows(jproj(v), jproj(sh), J))
    got = tk.col_prefix(t(coltot), T)
    assert np.array_equal(got.numpy(), v.astype(np.int16))


def test_globalize_vs_rows(curves):
    J, T = curves
    rng = np.random.default_rng(10)
    tbuf = lazy_points(J, rng, (2, 5), np.int16)
    s = lazy_points(J, rng, (5,), np.int16)
    sb = np.broadcast_to(s[:, :, None], tbuf.shape)
    want = jstack(jrows.padd_rows(jproj(tbuf), jproj(sb), J))
    got = tk.globalize(t(tbuf), t(s), T)
    assert np.array_equal(got.numpy(), want)


def decode(curve, out):
    """(3, L, W) signed lazy limbs -> W affine-as-Jacobian points."""
    xs, ys, zs = (planar_signed_to_ints_modp(out[c], curve)
                  for c in range(3))
    return [ref.INF if z == 0 else
            (x * pow(z, -1, curve.p) % curve.p,
             y * pow(z, -1, curve.p) % curve.p, 1)
            for x, y, z in zip(xs, ys, zs)]


def test_pbpr_full_and_stage1_weighted_sums(curves):
    """pbpr_full: G_w = sum_b (b+1) bucket_b; pbpr_stage1: slice t of Bt
    buckets from the top down, m_t its sum and g_t = sum_j (j+1)
    bucket_{t,j}; each by group value, some buckets at infinity."""
    _, C = curves
    W, B, T = 2, 8, 4
    Bt = B // T
    pts, _ = ref.gen_points_scalars(C, W * B, seed=34)
    kill = np.random.default_rng(48).random((W, B)) < 0.3
    buckets = mont_buckets(C, pts, (W, B), kill)
    mul = lambda k, i: (ref.INF if kill.reshape(-1)[i] else
                        ref.scalar_mul(C, (*pts[i], 1), k))
    got = decode(C, tk.pbpr_full(buckets, C, T).numpy())
    for w in range(W):
        want = ref.INF
        for b in range(B):
            want = ref.add(C, want, mul(b + 1, w * B + b))
        assert ref.jac_eq(C, got[w], want), w
    m, g = tk.pbpr_stage1(buckets, C, T)
    m = decode(C, m.reshape(3, C.num_limbs, W * T).numpy())
    g = decode(C, g.reshape(3, C.num_limbs, W * T).numpy())
    for w in range(W):
        for s in range(T):
            base = w * B + s * Bt
            wm = wg = ref.INF
            for j in range(Bt):
                wm = ref.add(C, wm, mul(1, base + j))
                wg = ref.add(C, wg, mul(j + 1, base + j))
            assert ref.jac_eq(C, m[w * T + s], wm), (w, s)
            assert ref.jac_eq(C, g[w * T + s], wg), (w, s)


# ---------------------------------------------------------------------------
# the slice against the JAX package's reference MSM
# ---------------------------------------------------------------------------


def small_cfg(curve, **kw):
    return MSMConfig(curve=curve, window_size=8, columns=32, pbpr_threads=16,
                     subtask_group=8, **kw)


def jax_oracle(name, pts, scalars):
    J = jc.CURVES[name]
    return jref.msm_pippenger_signed(
        J, pts, [k % J.scalar_modulus for k in scalars], window=8)


@pytest.mark.parametrize("name,n", [("bls12_377_s12", 96),
                                    ("bls12_377_s13", 160)])
def test_slice_vs_jax_reference_msm(name, n):
    """n = 96 (one lane column a window: R = 3) and 160, with a zero
    scalar, r - 1, r (zero in the group) and the largest that fits."""
    c = tc.CURVES[name]
    pts, scalars = ref.gen_points_scalars(c, n, seed=81)
    scalars[0], scalars[1] = 0, c.scalar_modulus - 1
    scalars[2], scalars[3] = c.scalar_modulus, (1 << c.scalar_bits) - 1
    got = tpu_variable_base_msm(pts, scalars, config=small_cfg(c), curve=c,
                                device="cpu")
    assert ref.jac_eq(c, got, jax_oracle(name, pts, scalars))


def test_slice_glv_bls12_377_s12():
    """glv=True on BLS12-377 (j-invariant 0, b = 1): equal to the JAX
    reference MSM and to the port's own MSM without GLV."""
    c = tc.BLS12_377_S12
    g = glv.derive(c)
    pts, scalars = ref.gen_points_scalars(c, 64, seed=82)
    scalars[:4] = [0, 1, c.scalar_modulus - 1, g.lam]
    got = tpu_variable_base_msm(pts, scalars, config=small_cfg(c, glv=True),
                                curve=c, device="cpu")
    assert ref.jac_eq(c, got, jax_oracle("bls12_377_s12", pts, scalars))


def test_default_config_bls12_377():
    """The default schedule takes BLS12-377's 253-bit scalars at every
    size, the top window short of a full s bits."""
    c = tc.BLS12_377_S12
    for logn, s, W in ((8, 8, 32), (12, 10, 26), (16, 13, 20),
                       (20, 16, 16)):
        cfg = default_config(1 << logn, c)
        assert (cfg.curve, cfg.window_size, cfg.num_windows) == (c, s, W)


# ---------------------------------------------------------------------------
# the JAX package's inputs, GLV constants and affine output
# ---------------------------------------------------------------------------


def test_convert_from_jax_bls12_377():
    jcfg = JaxConfig(curve=jc.BLS12_377_S12, window_size=8, columns=32,
                     pbpr_threads=16, subtask_group=8, backend="xla")
    c = tc.BLS12_377_S12
    pts, scalars = ref.gen_points_scalars(c, 40, seed=83)
    xs, ys, hw = jpipeline.get_pipeline(jcfg).pack(pts, scalars)
    cfg, tx, ty, th = convert.from_jax(xs, ys, hw, dataclasses.asdict(jcfg),
                                       device="cpu")
    assert cfg == dataclasses.replace(small_cfg(c), backend="xla")
    assert tx.shape == (32, 64) and tx.dtype == torch.int32
    got = tpu_variable_base_msm(pts, scalars, config=cfg, curve=c,
                                device="cpu")
    pipe = get_pipeline(cfg, "cpu")
    assert ref.jac_eq(c, pipe.horner(pipe.window_sums(tx, ty, th)), got)
    s13 = convert.config_from_fields(dict(curve="bls12_377_s13"))
    assert s13.curve is tc.BLS12_377_S13


@pytest.mark.parametrize("name", ["bls12_377_s12", "bls12_377_s13"])
def test_glv_derive_vs_jax(name):
    J, T = jc.CURVES[name], tc.CURVES[name]
    jg, tg = jglv.derive(J), glv.derive(T)
    for f in ("lam", "beta", "a1", "b1", "a2", "b2", "g1", "g2", "max_abs"):
        assert getattr(jg, f) == getattr(tg, f), f
    rng = random.Random(84)
    r = T.scalar_modulus
    for k in [0, 1, r - 1, tg.lam] + [rng.randrange(r) for _ in range(32)]:
        assert tg.split_signed(k) == jg.split_signed(k)


def test_to_affine_bls12_377_s13_vs_jax():
    J, T = jc.BLS12_377_S13, tc.BLS12_377_S13
    rng = random.Random(85)
    n = 4
    pts = [(rng.randrange(1, T.p), rng.randrange(1, T.p)) for _ in range(n)]
    zs = [rng.randrange(1, T.p) for _ in range(n)]
    enc = lambda vals: ints_to_planar(vals, T.num_limbs,
                                      T.log_limb_size).astype(np.int32)
    x = enc([T.to_mont(a * z % T.p) for (a, _), z in zip(pts, zs)] + [0])
    y = enc([T.to_mont(b * z % T.p) for (_, b), z in zip(pts, zs)]
            + [T.to_mont(1)])
    z = enc([T.to_mont(v) for v in zs] + [0])
    ax, ay, inf = to_affine(torch.from_numpy(np.stack([x, y, z])), T)
    want = jinverse.to_affine(ProjPoint(*map(jnp.asarray, (x, y, z))), J)
    for w, g in zip(want, (ax, ay, inf)):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert inf.tolist() == [False] * n + [True]


# ---------------------------------------------------------------------------
# which profiles the CUDA library takes
# ---------------------------------------------------------------------------


def test_cuda_profiles():
    """The library is built for the signed profiles of both curves and
    TINY62, and the pipeline takes each of them."""
    signed = ["bn254_s12", "bn254_s13", "bls12_377_s12", "bls12_377_s13",
              "tiny62"]
    assert tk.CUDA_PROFILES == {
        (tc.CURVES[n].num_limbs, tc.CURVES[n].log_limb_size) for n in signed}
    assert set(tc.CURVES) == set(signed) | {"bn254_f13", "bls12_377_f12",
                                            "bn254", "bls12_377"}
    for n in signed:
        c = tc.CURVES[n]
        assert tk._profile("x", c) == (c.num_limbs, c.log_limb_size)
        assert MSMConfig(curve=c).curve is c


REFUSED = {
    "bn254_f13": tc.BN254_F13, "bls12_377_f12": tc.BLS12_377_F12,
    "bn254": tc.BN254, "bls12_377": tc.BLS12_377,
    # renamed: BLS12_377_F12 has BLS12_377_S12's L and w
    "bls12_377_f12 renamed": dataclasses.replace(tc.BLS12_377_F12,
                                                 name="renamed"),
    # signed, but 20 x 13 = 260 bits leave 6 bits of slack over BN254's p
    "bn254_s13 on 20 limbs": dataclasses.replace(tc.BN254_S13,
                                                 name="s13_l20",
                                                 num_limbs=20),
    # signed, but 14-bit limbs do not fit int16 storage
    "bn254 w=14": dataclasses.replace(tc.BN254_S13, name="s14",
                                      log_limb_size=14)}


@pytest.mark.parametrize("key", sorted(REFUSED))
def test_refusal_of_unsigned_profiles(key):
    """The F profiles and the 16-bit base profiles are data only, and a
    signed profile under the JAX package's floor of 7 bits of slack or
    with limbs of more than 13 bits is refused too: by MSMConfig (so by
    the pipeline on the CPU as on the card, and by `convert`) and by
    every CUDA wrapper before any launch. A new name does not get past
    the rule."""
    c = REFUSED[key]
    with pytest.raises(ValueError, match=c.name):
        tk._profile("x", c)
    with pytest.raises(ValueError, match=c.name):
        MSMConfig(curve=c)
    with pytest.raises(ValueError, match=c.name):
        tpu_variable_base_msm([(c.gen_x, c.gen_y)], [1], curve=c,
                              device="cpu")
    if c.name in tc.CURVES:
        with pytest.raises(ValueError, match=c.name):
            convert.config_from_fields({"curve": c.name})
