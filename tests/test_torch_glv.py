"""The GLV configuration of the port (tpu_msm_torch/glv.py, cuzk/glv.py,
ops/limbs.py, ops/barrett.py and the GLV branch of the pipeline) on CPU
tensors, against the JAX package and the oracle.

`glv.derive` field by field against `tpu_msm.glv.derive` (python ints);
`mul_wide`, `add_unsafe`, `sub` against the JAX halfword functions;
`split_scalars` against `tpu_msm.cuzk.glv.split_scalars` (eager) and
`GLVParams.split_signed`; `apply_glv` against `tpu_msm.cuzk.glv.apply_glv`
(eager): the doubled x, y stream and the digits, all bit for bit. That
is the whole of what GLV adds before the sort. The MSM with glv=True is
then held, by group value, against the oracle and the port's own result
without GLV; the JAX pipeline with GLV is not compiled here (it takes
minutes on a CPU)."""

import dataclasses
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm import glv as jglv
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import glv as jdglv
from tpu_msm.ops import barrett as jbarrett
from tpu_msm.ops import lazy as jlazy
from tpu_msm.ops import limbs as jlimbs
from tpu_msm_torch import convert, glv
from tpu_msm_torch.config import MSMConfig, default_config
from tpu_msm_torch.constants import BN254_S12, BN254_S13, TINY62
from tpu_msm_torch.cuzk import glv as dglv
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.cuzk.pipeline import get_pipeline, tpu_variable_base_msm
from tpu_msm_torch.ops import barrett, limbs
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import (points_to_planar,
                                                  scalars_to_planar)

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

FIELDS = dict(window_size=8, columns=32, pbpr_threads=16, subtask_group=8)


def glv_cfg(curve, **kw):
    return MSMConfig(curve=curve, glv=True, **{**FIELDS, **kw})


def edge_scalars(curve, n, seed):
    g = glv.derive(curve)
    r = curve.scalar_modulus
    rng = random.Random(seed)
    ks = [0, 1, r - 1, g.lam, r - g.lam]
    return ks + [rng.randrange(r) for _ in range(n - len(ks))]


# ---------------------------------------------------------------------------
# host derivation
# ---------------------------------------------------------------------------


def test_derive_matches_jax_field_by_field():
    mine, theirs = glv.derive(BN254_S12), jglv.derive(jc.BN254_S12)
    for f in dataclasses.fields(mine):
        if f.name != "curve":
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.max_bits == theirs.max_bits == 127
    assert glv.M_SHIFT == jglv.M_SHIFT


@pytest.mark.parametrize("curve", [BN254_S12, BN254_S13],
                         ids=lambda c: c.name)
def test_derivation_invariants(curve):
    g = glv.derive(curve)
    r, p = curve.scalar_modulus, curve.p
    assert pow(g.lam, 3, r) == 1 and g.lam != 1
    assert pow(g.beta, 3, p) == 1 and g.beta != 1
    gen = (curve.gen_x, curve.gen_y, 1)
    assert ref.jac_eq(curve, ref.scalar_mul(curve, gen, g.lam),
                      (g.beta * curve.gen_x % p, curve.gen_y, 1))
    assert (g.a1 + g.b1 * g.lam) % r == 0
    assert (g.a2 + g.b2 * g.lam) % r == 0
    assert g.a1 * g.b2 - g.a2 * g.b1 == r
    assert g.b1 <= 0 <= g.b2
    assert g.max_bits <= 128
    for k in edge_scalars(curve, 200, 81):
        k1, k2 = g.decompose(k)
        assert (k1 + k2 * g.lam - k) % r == 0, k
        assert abs(k1) <= g.max_abs and abs(k2) <= g.max_abs, k


def test_derive_refuses_a_curve_without_the_endomorphism():
    """TINY62's group order is composite: no cube root of unity to find."""
    with pytest.raises(ValueError):
        glv.derive(TINY62)


# ---------------------------------------------------------------------------
# halfword arithmetic
# ---------------------------------------------------------------------------


def test_halfword_ops_match_jax():
    rng = np.random.default_rng(91)
    a = rng.integers(0, 1 << 16, (16, 40)).astype(np.uint32)
    b = rng.integers(0, 1 << 16, (10, 40)).astype(np.uint32)
    a[:, 0], b[:, 0] = 0xFFFF, 0xFFFF              # the largest products
    a[:, 1] = 0
    ta, tb = (torch.from_numpy(v.astype(np.int64)) for v in (a, b))
    want = np.asarray(jbarrett.mul_wide(jnp.asarray(a), jnp.asarray(b)))
    got = barrett.mul_wide(ta, tb)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    # a constant operand broadcasts over the lanes
    assert torch.equal(barrett.mul_wide(ta, tb[:, :1]),
                       barrett.mul_wide(ta, tb[:, :1].expand(10, 40)))
    c = rng.integers(0, 1 << 16, (16, 40)).astype(np.uint32)
    tcc = torch.from_numpy(c.astype(np.int64))
    for mine, theirs in ((limbs.add_unsafe, jlimbs.add_unsafe),
                         (limbs.sub, jlimbs.sub)):
        want = np.asarray(theirs(jnp.asarray(a), jnp.asarray(c)))
        assert np.array_equal(mine(ta, tcc).numpy(), want), mine.__name__
    cond = rng.random(40) < 0.5
    want = np.asarray(jlimbs.select(jnp.asarray(cond), jnp.asarray(a),
                                    jnp.asarray(c)))
    assert np.array_equal(
        limbs.select(torch.from_numpy(cond), ta, tcc).numpy(), want)


# ---------------------------------------------------------------------------
# split_scalars and apply_glv
# ---------------------------------------------------------------------------


def test_split_scalars_matches_jax_and_oracle():
    c = BN254_S12
    g = glv.derive(c)
    ks = edge_scalars(c, 64, 82)
    hw = scalars_to_planar(ks, c)
    n1, m1, n2, m2 = dglv.split_scalars(torch.from_numpy(
        hw.astype(np.int32)), g)
    assert m1.dtype == torch.int32 and m1.shape == (dglv.B_LIMBS, len(ks))
    assert n1.dtype == torch.bool
    want = jdglv.split_scalars(jnp.asarray(hw), jglv.derive(jc.BN254_S12))
    for mine, theirs in zip((n1, m1, n2, m2), want):
        assert np.array_equal(mine.numpy().astype(np.int64),
                              np.asarray(theirs).astype(np.int64))
    for i, k in enumerate(ks):
        got1 = sum(int(m1[j, i]) << (16 * j) for j in range(dglv.B_LIMBS))
        got2 = sum(int(m2[j, i]) << (16 * j) for j in range(dglv.B_LIMBS))
        assert (bool(n1[i]), got1, bool(n2[i]), got2) == g.split_signed(k), k


@pytest.mark.parametrize("s", [8, 13, 16])
def test_apply_glv_matches_jax(s):
    """n = 64 on BN254_S12: the doubled stream and the digits, bit for
    bit. s = 16 has full halfword windows, whose raw value 2^15 must
    become the digit -2^15 with a carry."""
    c = BN254_S12
    fields = dict(FIELDS, window_size=s, pbpr_threads=min(16, 1 << (s - 1)))
    cfg = MSMConfig(curve=c, glv=True, **fields)
    jcfg = JaxConfig(curve=jc.BN254_S12, glv=True, backend="xla",
                     unroll=False, **fields)
    assert cfg.num_windows == jcfg.num_windows == 128 // s + 1
    pts, _ = ref.gen_points_scalars(c, 64, seed=85)
    ks = edge_scalars(c, 64, 86)
    # a magnitude whose low halfword is exactly 2^15: k = k1 with k2 = 0
    ks[5] = 1 << 15
    xs, ys = points_to_planar(pts, c)
    hw = np.concatenate([scalars_to_planar(ks, c),
                         np.zeros((2, 64), np.uint32)])
    xm = kernels.encode_mont(torch.from_numpy(xs.astype(np.int32)), c)
    ym = kernels.encode_mont(torch.from_numpy(ys.astype(np.int32)), c)
    x2, y2, digits = dglv.apply_glv(xm, ym, torch.from_numpy(
        hw.astype(np.int32)), cfg)
    assert digits.dtype == torch.int16 and digits.shape == (128 // s + 1, 128)
    assert x2.shape == y2.shape == (c.num_limbs, 128)
    # canonical limbs: the int16 row table of the scan holds them exactly
    for v in (x2, y2):
        assert int(v.min()) >= 0 and int(v.max()) < (1 << c.log_limb_size)

    jx = jlazy.to_mont(jnp.asarray(xs.astype(np.int32)), jc.BN254_S12)
    jy = jlazy.to_mont(jnp.asarray(ys.astype(np.int32)), jc.BN254_S12)
    wx, wy, wd = jdglv.apply_glv(jx, jy, jnp.asarray(hw), jcfg)
    assert np.array_equal(x2.numpy(), np.asarray(wx))
    assert np.array_equal(y2.numpy(), np.asarray(wy))
    assert np.array_equal(digits.numpy().astype(np.int32), np.asarray(wd))
    if s == 16:
        assert int(digits[0, 5]) == -(1 << 15) and int(digits[1, 5]) == 1


# ---------------------------------------------------------------------------
# config and convert
# ---------------------------------------------------------------------------


def test_glv_window_counts():
    cfg = glv_cfg(BN254_S13)
    base = MSMConfig(curve=BN254_S13, **FIELDS)
    assert cfg.num_windows <= base.num_windows // 2 + 1
    s = cfg.window_size
    assert cfg.effective_scalar_bits - s * (cfg.num_windows - 1) < s
    assert cfg.effective_scalar_bits == 128
    for s, W in ((16, 9), (13, 10), (8, 17)):
        jcfg = JaxConfig(curve=jc.BN254_S12, window_size=s, glv=True)
        mine = MSMConfig(curve=BN254_S12, window_size=s, glv=True)
        assert mine.num_windows == jcfg.num_windows == W
        assert mine.padded_windows == jcfg.padded_windows
    # the default schedule leaves GLV off, as the JAX package does
    assert not default_config(1 << 20).glv and not MSMConfig().glv
    with pytest.raises(ValueError):
        MSMConfig(curve=TINY62, glv=True, **FIELDS).num_windows


def test_convert_from_jax_with_glv():
    c = BN254_S12
    jcfg = JaxConfig(curve=jc.BN254_S12, glv=True, backend="xla", **FIELDS)
    pts, scalars = ref.gen_points_scalars(c, 40, seed=87)
    pipe = get_pipeline(glv_cfg(c), "cpu")
    xs, ys, hw = pipe.pack(pts, scalars)
    cfg, tx, ty, th = convert.from_jax(xs, ys, hw, dataclasses.asdict(jcfg),
                                       device="cpu")
    assert cfg == dataclasses.replace(glv_cfg(c), backend="xla") and cfg.glv
    got = pipe.horner(get_pipeline(cfg, "cpu").window_sums(tx, ty, th))
    assert ref.jac_eq(c, got, ref.msm_pippenger_signed(c, pts, scalars,
                                                       window=8))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("curve", [BN254_S12, BN254_S13],
                         ids=lambda c: c.name)
def test_slice_glv_matches_oracle_and_plain_path(curve):
    pts, scalars = ref.gen_points_scalars(curve, 128, seed=83)
    scalars[0], scalars[1] = 0, 1
    scalars[2] = curve.scalar_modulus - 1
    scalars[3] = glv.derive(curve).lam
    got = tpu_variable_base_msm(pts, scalars, config=glv_cfg(curve),
                                device="cpu")
    assert ref.jac_eq(curve, got, ref.msm_pippenger_signed(
        curve, pts, scalars, window=8))
    plain = tpu_variable_base_msm(pts, scalars, device="cpu",
                                  config=MSMConfig(curve=curve, **FIELDS))
    assert ref.jac_eq(curve, got, plain)


def test_slice_glv_grouped_windows_and_rows():
    """Wg = 4 with W = 10 padded to 12, and R = 2n / C = 4 rows a column."""
    c = BN254_S12
    cfg = glv_cfg(c, window_size=13, columns=64, subtask_group=4,
                  pbpr_threads=1024)
    assert (cfg.num_windows, cfg.padded_windows, cfg.num_groups) == (10, 12, 3)
    pts, scalars = ref.gen_points_scalars(c, 128, seed=88)
    got = tpu_variable_base_msm(pts, scalars, config=cfg, device="cpu")
    assert ref.jac_eq(c, got, ref.msm_pippenger_signed(c, pts, scalars,
                                                       window=8))


def test_slice_glv_multi_pass_halves_the_pass_size():
    """max_points_per_pass counts stream lanes: under GLV a pass takes
    half as many points, so 96 points at 64 lanes a pass are 3 passes."""
    c = BN254_S12
    pts, scalars = ref.gen_points_scalars(c, 96, seed=89)
    one = get_pipeline(glv_cfg(c), "cpu")
    multi = get_pipeline(glv_cfg(c, max_points_per_pass=64), "cpu")
    packed = one.pack(pts, scalars)
    calls = []
    orig = multi._run
    multi._run = lambda staged: calls.append(staged[0][0].shape[-1]) or \
        orig(staged)
    try:
        many = multi.window_sums(*packed)
    finally:
        multi._run = orig
    assert calls == [32, 32, 32]
    for a, b in zip(one.window_sums(*packed), many):
        assert ref.jac_eq(c, a, b)
    assert ref.jac_eq(c, multi.horner(many), ref.msm_pippenger_signed(
        c, pts, scalars, window=8))


def test_slice_glv_leaves_launch_counts_alone_on_cpu():
    kernels.reset_launches()
    pts, scalars = ref.gen_points_scalars(BN254_S12, 8, seed=90)
    tpu_variable_base_msm(pts, scalars, config=glv_cfg(BN254_S12),
                          device="cpu")
    assert set(kernels.LAUNCHES.values()) == {0}
    assert len(kernels.LAUNCHES) == 17
