"""The port's unsigned arithmetic layers (tpu_msm_torch/ops/limbs.py,
barrett.py, field.py, mont.py, curve.py) against the JAX functions of
the same names, bit for bit, on inputs made from a numpy seed: limbs,
Barrett, field and CIOS at BN254 and BLS12_377 (16-bit limbs), the
deferred-carry multiply at BN254_F13 and BLS12_377_F12, the NSAFE-gated
multiply at 14- and 15-bit limbs, and the Jacobian point layer at
BN254_F13 and TINY62 (jac_dbl also at BN254), the profiles of the JAX
package's own tests. The port's int64 limbs are compared by value with
the JAX uint32 limbs. `jac_add` is held against JAX under both of its
dbl_modes. JAX runs op by op, except where a jit compiles faster than
the op-by-op run takes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.ops import barrett as jbarrett
from tpu_msm.ops import curve as jcurve
from tpu_msm.ops import field as jfield
from tpu_msm.ops import limbs as jlimbs
from tpu_msm.ops import mont as jmont
from tpu_msm_torch import constants as tc
from tpu_msm_torch.ops import barrett, curve, field, limbs, mont
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils import testing
from tpu_msm_torch.utils.limbs_conversion import (ints_to_planar,
                                                   planar_to_ints)

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

N = 16


def rand_ints(bound, n, rng):
    """n ints in [0, bound), the first three 0, 1 and bound - 1."""
    out = [0, 1, bound - 1]
    out += [int.from_bytes(rng.bytes(64), "little") % bound
            for _ in range(n - 3)]
    return out


def planar(vals, curve, num_limbs=None):
    """(L, n) uint32 limbs of the ints."""
    return ints_to_planar(vals, num_limbs or curve.num_limbs,
                          curve.log_limb_size)


def both(a):
    """The same limbs as a JAX uint32 array and a torch int64 tensor."""
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.uint32)), torch.from_numpy(
        a.astype(np.int64))


def same(j, t):
    """JAX uint32 (or bool) result == torch result, by value."""
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == np.bool_:
        return t.dtype == np.bool_ and np.array_equal(j, t)
    return j.shape == t.shape and np.array_equal(j.astype(np.int64), t)


def curves(*names):
    return pytest.mark.parametrize(
        "J,T", [(jc.CURVES[n], tc.CURVES[n]) for n in names], ids=names)


# ---------------------------------------------------------------------------
# limbs
# ---------------------------------------------------------------------------


def test_limbs_match_jax():
    rng = np.random.default_rng(1)
    c = jc.BN254
    a = planar(rand_ints(1 << 256, N, rng), c)
    b = planar(rand_ints(1 << 256, N, rng), c)
    b[:, 5] = a[:, 5]                              # an equal pair
    (ja, ta), (jb, tb) = both(a), both(b)
    assert same(jlimbs.add_unsafe(ja, jb), limbs.add_unsafe(ta, tb))
    assert same(jlimbs.add_wide(ja, jb), limbs.add_wide(ta, tb))
    jd, jbr = jlimbs.sub_with_borrow(ja, jb)
    td, tbr = limbs.sub_with_borrow(ta, tb)
    assert same(jd, td) and same(jbr, tbr)
    assert same(jlimbs.sub(ja, jb), limbs.sub(ta, tb))
    assert same(jlimbs.gte(ja, jb), limbs.gte(ta, tb))
    assert same(jlimbs.eq(ja, jb), limbs.eq(ta, tb))
    assert same(jlimbs.is_zero(ja), limbs.is_zero(ta))
    wide = limbs.to_wide(ta)
    assert same(jlimbs.to_wide(ja), wide)
    assert same(jlimbs.from_wide(jlimbs.to_wide(ja), 16),
                limbs.from_wide(wide, 16))
    assert same(jlimbs.zeros_like_batch(ja, 3),
                limbs.zeros_like_batch(ta, 3))
    cond = ta[0] > tb[0]
    assert same(jlimbs.select(jnp.asarray(cond.numpy()), ja, jb),
                limbs.select(cond, ta, tb))


def test_limbs_narrow_width():
    """12-bit limbs: the carry and borrow move at bit 12."""
    rng = np.random.default_rng(2)
    c = jc.BN254_S12
    (ja, ta), (jb, tb) = (both(planar(rand_ints(1 << 264, N, rng), c))
                          for _ in range(2))
    assert same(jlimbs.add_wide(ja, jb, 12), limbs.add_wide(ta, tb, 12))
    jd, jbr = jlimbs.sub_with_borrow(ja, jb, 12)
    td, tbr = limbs.sub_with_borrow(ta, tb, 12)
    assert same(jd, td) and same(jbr, tbr)


# ---------------------------------------------------------------------------
# Barrett
# ---------------------------------------------------------------------------


def test_mul_wide_matches_jax():
    rng = np.random.default_rng(3)
    c = jc.BN254
    (ja, ta) = both(planar(rand_ints(1 << 256, N, rng), c))
    (jb, tb) = both(planar(rand_ints(1 << 128, N, rng), c, 8))
    assert same(jbarrett.mul_wide(ja, ja), barrett.mul_wide(ta, ta))
    assert same(jbarrett.mul_wide(ja, jb), barrett.mul_wide(ta, tb))


@curves("bn254", "bls12_377")
def test_barrett_matches_jax(J, T):
    rng = np.random.default_rng(4)
    (ja, ta), (jb, tb) = (both(planar(rand_ints(J.p, N, rng), J))
                          for _ in range(2))
    assert T.barrett_mu == J.barrett_mu and T.mu_limbs() == J.mu_limbs()
    assert same(jbarrett.field_mul(ja, jb, J), barrett.field_mul(ta, tb, T))
    assert same(jbarrett.to_mont_barrett(ja, J),
                barrett.to_mont_barrett(ta, T))
    # a full 2L-limb product below p^2, reduced on its own
    jx, tx = both(planar([J.p * J.p - 1, J.p * (J.p - 2) + 5, 0, 1], J,
                         2 * J.num_limbs))
    assert same(jbarrett.barrett_reduce(jx, J),
                barrett.barrett_reduce(tx, T))


# ---------------------------------------------------------------------------
# field
# ---------------------------------------------------------------------------


@curves("bn254", "bls12_377")
def test_field_matches_jax(J, T):
    rng = np.random.default_rng(5)
    (ja, ta), (jb, tb) = (both(planar(rand_ints(J.p, N, rng), J))
                          for _ in range(2))
    assert same(jfield.p_array(J, (N,)), field.p_array(T, (N,)))
    for jf, tf in ((jfield.ff_add, field.ff_add),
                   (jfield.ff_sub, field.ff_sub)):
        assert same(jf(ja, jb, J), tf(ta, tb, T))
        assert same(jf(jb, ja, J), tf(tb, ta, T))
    assert same(jfield.ff_neg(ja, J), field.ff_neg(ta, T))
    assert same(jfield.ff_double(ja, J), field.ff_double(ta, T))
    # reduce-once on values in [0, 2p)
    jw, tw = both(planar([v + J.p for v in rand_ints(J.p, N, rng)], J))
    assert same(jfield.ff_reduce(jw, J), field.ff_reduce(tw, T))


# ---------------------------------------------------------------------------
# Montgomery
# ---------------------------------------------------------------------------


@curves("bn254", "bls12_377", "bn254_f13", "bls12_377_f12")
def test_mont_matches_jax(J, T):
    rng = np.random.default_rng(6)
    (ja, ta), (jb, tb) = (both(planar(rand_ints(J.p, N, rng), J))
                          for _ in range(2))
    assert (T.n0, T.nsafe) == (J.n0, J.nsafe)
    assert same(jmont.mont_mul(ja, jb, J), mont.mont_mul(ta, tb, T))
    assert same(jmont.mont_sqr(ja, J), mont.mont_sqr(ta, T))
    assert same(jmont.to_mont(ja, J), mont.to_mont(ta, T))
    assert same(jmont.from_mont(ja, J), mont.from_mont(ta, T))
    assert same(jmont.mont_mul_modified(ja, jb, J),
                mont.mont_mul_modified(ta, tb, T))
    if J.log_limb_size == 16:
        assert same(jmont.mont_mul_cios(ja, jb, J),
                    mont.mont_mul_cios(ta, tb, T))
    else:
        assert same(jmont.mont_mul_deferred(ja, jb, J, unroll=False),
                    mont.mont_mul_deferred(ta, tb, T))


@pytest.mark.parametrize("w,L", [(14, 19), (15, 18)])
def test_mont_mul_modified_midwidth(w, L):
    """14- and 15-bit limbs take the gated-fold loop."""
    J = dataclasses.replace(jc.BN254, name=f"bn254_m{w}", num_limbs=L,
                            log_limb_size=w)
    T = dataclasses.replace(tc.BN254, name=f"bn254_m{w}", num_limbs=L,
                            log_limb_size=w)
    assert T.nsafe == J.nsafe > 1
    rng = np.random.default_rng(w)
    (ja, ta), (jb, tb) = (both(planar(rand_ints(J.p, N, rng), J))
                          for _ in range(2))
    got = mont.mont_mul_modified(ta, tb, T)
    assert same(jmont.mont_mul_modified(ja, jb, J), got)
    for x, y, g in zip(*(planar_to_ints(v.numpy(), w)
                         for v in (ta, tb, got))):
        assert g == x * y * T.rinv % T.p


def test_mont_refusals():
    a = torch.zeros((16, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="13"):
        mont.mont_mul_deferred(a, a, tc.BN254)
    headroom = dataclasses.replace(tc.BN254_F13, num_limbs=64)
    assert tc.deferred_carry_headroom(64, 13) < 1
    with pytest.raises(ValueError, match="overflow"):
        mont.mont_mul_deferred(torch.zeros((64, 1), dtype=torch.int64),
                               torch.zeros((64, 1), dtype=torch.int64),
                               headroom)


def test_constants_helpers_match_jax():
    for name in ("bn254", "bn254_f13", "bls12_377_f12", "bn254_s12",
                 "tiny62"):
        J, T = jc.CURVES[name], tc.CURVES[name]
        L, w = J.num_limbs, J.log_limb_size
        assert tc.calc_rinv_and_n0(J.p, L, w) == jc.calc_rinv_and_n0(J.p, L,
                                                                     w)
        assert tc.calc_nsafe(w) == jc.calc_nsafe(w)
        assert tc.calc_barrett_mu(J.p, L, w) == jc.calc_barrett_mu(J.p, L, w)
        assert tc.deferred_carry_headroom(L, w) == \
            jc.deferred_carry_headroom(L, w)
        assert T.p_wide_limbs() == J.p_wide_limbs()


# ---------------------------------------------------------------------------
# Jacobian points
# ---------------------------------------------------------------------------


def rand_jac(c, n, rng):
    """n oracle Jacobian points with random z: random multiples of the
    generator; the last one at infinity."""
    g = (c.gen_x, c.gen_y, 1)
    out = []
    for _ in range(n - 1):
        x, y = ref.to_affine(c, ref.scalar_mul(c, g, int(rng.integers(
            1, 1 << 62))))
        z = int(rng.integers(2, 1 << 62)) % c.p
        out.append((x * z * z % c.p, y * z ** 3 % c.p, z))
    return out + [ref.INF]


def enc(pts, J):
    """Oracle points -> (JAX JacPoint, port JacPoint)."""
    arrs = [both(a) for a in testing.jac_to_planar_mont(pts, J)]
    return (jcurve.JacPoint(*(a[0] for a in arrs)),
            curve.JacPoint(*(a[1] for a in arrs)))


def same_point(j, t):
    return all(same(a, b) for a, b in zip(j, t))


def pairs(c, rng):
    """(p1, p2) lanes: generic sums, P + P (the doubling case, with other
    z), P + (-P), infinity on either side, both at infinity."""
    p = rand_jac(c, 8, rng)
    q = rand_jac(c, 8, rng)
    x, y, z = p[0]
    q[0] = (x * 4 % c.p, y * 8 % c.p, z * 2 % c.p)            # P + P
    q[1] = ref.neg(c, p[1])                                    # P + (-P)
    q[2] = ref.INF                                             # P + inf
    p[3] = ref.INF                                             # inf + Q
    return p, q


def check_oracle(c, got, want):
    for g, w in zip(testing.planar_mont_to_jac(*got, c), want):
        assert ref.jac_eq(c, g, w)


@curves("bn254_f13", "bn254")
def test_jac_dbl_matches_jax(J, T):
    pts = rand_jac(T, 8, np.random.default_rng(7))
    jp, tp = enc(pts, J)
    got = curve.jac_dbl(tp, T)
    assert same_point(jcurve.jac_dbl(jp, J), got)
    check_oracle(T, got, [ref.dbl(T, p) for p in pts])


@curves("bn254_f13", "tiny62")
def test_jac_add_matches_jax_select(J, T):
    p, q = pairs(T, np.random.default_rng(8))
    (jp, tp), (jq, tq) = enc(p, J), enc(q, J)
    got = curve.jac_add(tp, tq, T)
    assert same_point(jcurve.jac_add(jp, jq, J, dbl_mode="select"), got)
    check_oracle(T, got, [ref.add(T, a, b) for a, b in zip(p, q)])


@pytest.mark.parametrize("with_dbl", [True, False])
def test_jac_add_matches_jax_cond(with_dbl):
    """dbl_mode="cond" computes the doubling only when a lane needs it;
    with and without such a lane the port's per-lane select agrees."""
    J, T = jc.TINY62, tc.TINY62
    p, q = pairs(T, np.random.default_rng(9))
    if not with_dbl:
        q[0] = rand_jac(T, 2, np.random.default_rng(10))[0]
    (jp, tp), (jq, tq) = enc(p, J), enc(q, J)
    f = jax.jit(lambda a, b: jcurve.jac_add(a, b, J, unroll=False,
                                            dbl_mode="cond"))
    assert same_point(f(jp, jq), curve.jac_add(tp, tq, T))


@curves("bn254_f13", "tiny62")
def test_jac_madd_matches_jax(J, T):
    rng = np.random.default_rng(11)
    p = rand_jac(T, 8, rng)                  # the last at infinity
    aff = [ref.to_affine(T, a) for a in rand_jac(T, 9, rng)[:-1]]
    aff[0] = ref.to_affine(T, p[0])                     # P + P
    aff[1] = ref.to_affine(T, ref.neg(T, p[1]))         # P + (-P)
    mask = np.zeros(8, bool)
    mask[2] = True                                      # affine identity
    xs, ys = testing.affine_to_planar_mont(aff, T)
    (jx, tx), (jy, ty) = both(xs), both(ys)
    jp, tp = enc(p, J)
    got = curve.jac_madd(tp, tx, ty, T, p2_inf=torch.from_numpy(mask))
    want = jcurve.jac_madd(jp, jx, jy, J, p2_inf=jnp.asarray(mask),
                           dbl_mode="select")
    assert same_point(want, got)
    assert same_point(jcurve.jac_madd(jp, jx, jy, J, dbl_mode="select"),
                      curve.jac_madd(tp, tx, ty, T))
    check_oracle(T, got, [a if m else ref.add(T, a, (b[0], b[1], 1))
                          for a, b, m in zip(p, aff, mask)])


def test_neg_eq_select_infinity_match_jax():
    J, T = jc.BN254_F13, tc.BN254_F13
    pts = rand_jac(T, 8, np.random.default_rng(12))
    jp, tp = enc(pts, J)
    assert same_point(jcurve.jac_neg(jp, J), curve.jac_neg(tp, T))
    assert same(jcurve.is_inf(jp), curve.is_inf(tp))
    assert same(jcurve.jac_eq_limbwise(jp, jcurve.jac_neg(jp, J)),
                curve.jac_eq_limbwise(tp, curve.jac_neg(tp, T)))
    assert same(jcurve.jac_eq_limbwise(jp, jp), curve.jac_eq_limbwise(tp, tp))
    cond = np.arange(8) % 3 == 0
    ji, ti = jcurve.infinity(J, (8,)), curve.infinity(T, (8,))
    assert same_point(ji, ti)
    assert same_point(jcurve.select_point(jnp.asarray(cond), jp, ji),
                      curve.select_point(torch.from_numpy(cond), tp, ti))


def test_jac_scalar_mul_u32_matches_jax():
    J, T = jc.TINY62, tc.TINY62
    rng = np.random.default_rng(13)
    pts = rand_jac(T, 8, rng)
    k = rng.integers(0, 1 << 32, 8, dtype=np.uint64)
    k[:2] = [0, (1 << 32) - 1]
    jp, tp = enc(pts, J)
    f = jax.jit(lambda a, kk: jcurve.jac_scalar_mul_u32(a, kk, J))
    got = curve.jac_scalar_mul_u32(tp, torch.from_numpy(k.astype(np.int64)),
                                   T)
    assert same_point(f(jp, jnp.asarray(k.astype(np.uint32))), got)
    check_oracle(T, got, [ref.scalar_mul(T, a, int(kk))
                          for a, kk in zip(pts, k)])
