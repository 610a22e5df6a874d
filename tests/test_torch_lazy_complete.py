"""The port's signed lazy field layer and complete point formulas
(tpu_msm_torch/ops/lazy.py, complete.py) against the JAX functions of
the same names and against the port's ops/rows.py, bit for bit, at
TINY62, BN254_S12 and BLS12_377_S12, on inputs made from a numpy seed
at the relaxed extremes of the bound ledger: multiply operands of value
up to 32p with limbs in [-2^13, 2^13] and negative limbs, point
coordinates up to 4p with limbs in (-2^w, 2^(w+1)), and outputs fed back
as inputs. These runs are what lets lazy.py and complete.py delegate to
rows.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.ops import complete as jcomplete
from tpu_msm.ops import lazy as jlazy
from tpu_msm_torch import constants as tc
from tpu_msm_torch.ops import complete, lazy, rows

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

PROFILES = ["tiny62", "bn254_s12", "bls12_377_s12"]
N = 24


@pytest.fixture(params=PROFILES)
def curves(request):
    return jc.CURVES[request.param], tc.CURVES[request.param]


def relaxed(c, rng, mult, n=N):
    """(L, n) int32 limbs of values in [0, mult p]: the first lanes 0, 1,
    mult p - 1 and mult p; then one carry of -1, 0 or +1 moved across
    each limb boundary, so that limbs leave [0, 2^w) on both sides while
    the value stays (limbs within [-2^w - 1, 2^(w+1) - 1]). No borrow is
    taken from the top limb, which stays non-negative, as the ledger
    keeps it."""
    L, w = c.num_limbs, c.log_limb_size
    vals = [0, 1, mult * c.p - 1, mult * c.p]
    vals += [int.from_bytes(rng.bytes(64), "little") % (mult * c.p + 1)
             for _ in range(n - 4)]
    a = np.array([tc.int_to_limbs(v, L, w) for v in vals], np.int64).T
    k = rng.integers(-1, 2, (L - 1, n))
    k[-1] = np.minimum(k[-1], 0)
    a[:-1] += k << w
    a[1:] -= k
    assert (a < 0).any() and (a >= 1 << w).any()
    return a.astype(np.int32)


def value(a, c):
    """Exact value of signed limbs, per lane."""
    a = np.asarray(a).astype(object)
    return [sum(int(v) << (c.log_limb_size * i) for i, v in enumerate(col))
            for col in a.T]


def same(j, *ts):
    j = np.asarray(j)
    return all(j.dtype == np.int32 and t.dtype == torch.int32
               and np.array_equal(j, t.numpy()) for t in ts)


def same_point(j, *ts):
    return all(same(jc_, *tc_) for jc_, *tc_ in zip(j, *ts))


def test_const_and_one(curves):
    J, T = curves
    for v in (0, 1, J.p, 32 * J.p):
        assert same(jlazy.const_limbs(v, J, 2), lazy.const_limbs(v, T, 2))
    assert same(jlazy.const_limbs(J.p, J, 1, J.num_limbs + 1),
                lazy.const_limbs(T.p, T, 1, T.num_limbs + 1))
    assert same(jlazy.mont_one(J, 3), lazy.mont_one(T, 3))
    assert same(jcomplete.proj_infinity(J, (2, 3)).y,
                complete.proj_infinity(T, (2, 3)).y)


def test_lazy_field_ops(curves):
    J, T = curves
    rng = np.random.default_rng(1)
    a, b = relaxed(J, rng, 2), relaxed(J, rng, 2)
    (ja, jb), (ta, tb) = (jnp.asarray(a), jnp.asarray(b)), (
        torch.from_numpy(a), torch.from_numpy(b))
    assert same(jlazy.add(ja, jb), lazy.add(ta, tb))
    for k in (2, 4):
        assert same(jlazy.sub(ja, jb, J, k), lazy.sub(ta, tb, T, k),
                    rows.sub_rows(ta, tb, T, k))
        assert same(jlazy.neg(ja, J, k), lazy.neg(ta, T, k),
                    rows.neg_rows(ta, T, k))
    big = jlazy.smallmul(jlazy.sub(ja, jb, J, 2), 9)
    tbig = lazy.smallmul(lazy.sub(ta, tb, T, 2), 9)
    assert same(big, tbig)
    for passes in (1, 2):
        got = lazy.fold(tbig, T, passes)
        assert same(jlazy.fold(big, J, passes), got,
                    rows.fold_rows(tbig, T, passes))
        assert value(got, T) == value(tbig, T)
    assert same(jlazy.canonicalize(ja, J), lazy.canonicalize(ta, T),
                rows.canon_rows(ta, T))


@pytest.mark.parametrize("mult", [2, 32])
def test_mont_mul_relaxed(curves, mult):
    """Operands up to 32p with negative limbs, folded first as
    ops/complete.py's callers leave them."""
    J, T = curves
    rng = np.random.default_rng(mult)
    a, b = relaxed(J, rng, mult), relaxed(J, rng, mult)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = lazy.mont_mul(ta, tb, T)
    for unroll in (True, False):
        assert same(jlazy.mont_mul(jnp.asarray(a), jnp.asarray(b), J,
                                   unroll=unroll),
                    got, rows.mont_mul_rows(ta, tb, T))
    # the output bound (a b + m p) / R <= (mult p)^2 / R + p: below 2p
    # wherever the radix has the slack for it (not BLS12_377_S12 at 32p)
    top = (mult * T.p) ** 2 // T.mont_radix + T.p
    for g, x, y in zip(value(got, T), value(a, T), value(b, T)):
        assert g % T.p == x * y * T.rinv % T.p and 0 <= g <= top
    # negative limbs from a lazy subtract of values up to mult/2 p,
    # folded: a value up to mult p
    h = [relaxed(J, rng, mult // 2) for _ in range(2)]
    d = lazy.fold(lazy.sub(*map(torch.from_numpy, h), T, mult // 2), T)
    jd = jlazy.fold(jlazy.sub(*map(jnp.asarray, h), J, mult // 2), J)
    assert same(jd, d)
    assert same(jlazy.mont_mul(jd, jnp.asarray(b), J),
                lazy.mont_mul(d, tb, T), rows.mont_mul_rows(d, tb, T))


def test_to_mont(curves):
    J, T = curves
    rng = np.random.default_rng(3)
    vals = [0, 1, J.p - 1] + [int.from_bytes(rng.bytes(64), "little") % J.p
                              for _ in range(N - 3)]
    a = np.array([tc.int_to_limbs(v, T.num_limbs, T.log_limb_size)
                  for v in vals], np.int32).T
    got = lazy.to_mont(torch.from_numpy(a), T)
    assert same(jlazy.to_mont(jnp.asarray(a), J), got,
                rows.to_mont_rows(torch.from_numpy(a), T))
    assert [g % T.p for g in value(got, T)] == [T.to_mont(v) for v in vals]


def points(J, rng, mult=4):
    a = [relaxed(J, rng, mult) for _ in range(3)]
    return (jcomplete.ProjPoint(*map(jnp.asarray, a)),
            complete.ProjPoint(*map(torch.from_numpy, a)))


def test_point_formulas_relaxed(curves):
    """padd, pmadd and pdbl on coordinates up to 4p (mixed-add operands
    up to 2p, as smvp's 2p - y), then their outputs fed back in."""
    J, T = curves
    rng = np.random.default_rng(4)
    (jp, tp), (jq, tq) = points(J, rng), points(J, rng)
    x2, y2 = relaxed(J, rng, 2), relaxed(J, rng, 2)
    (jx, jy), (tx, ty) = (jnp.asarray(x2), jnp.asarray(y2)), (
        torch.from_numpy(x2), torch.from_numpy(y2))

    s = complete.padd(tp, tq, T)
    js = jcomplete.padd(jp, jq, J)
    assert same_point(js, s, rows.padd_rows(tp, tq, T))
    m = complete.pmadd(tp, tx, ty, T)
    assert same_point(jcomplete.pmadd(jp, jx, jy, J), m,
                      rows.pmadd_rows(tp, tx, ty, T))
    d = complete.pdbl(tp, T)
    assert same_point(jcomplete.pdbl(jp, J), d, rows.pdbl_rows(tp, T))
    # the outputs (values < 4p, negative limbs) as inputs
    chain = complete.padd(complete.pdbl(s, T), complete.pmadd(m, tx, ty, T),
                          T)
    jchain = jcomplete.padd(jcomplete.pdbl(js, J),
                            jcomplete.pmadd(jcomplete.pmadd(jp, jx, jy, J),
                                            jx, jy, J), J)
    assert same_point(jchain, chain)
    for coord in chain:
        assert all(0 <= v < 4 * T.p for v in value(coord, T))


def test_select_and_infinity(curves):
    J, T = curves
    rng = np.random.default_rng(5)
    (jp, tp), (jq, tq) = points(J, rng), points(J, rng)
    cond = np.arange(N) % 3 == 0
    assert same_point(jcomplete.select(jnp.asarray(cond), jp, jq),
                      complete.select(torch.from_numpy(cond), tp, tq))
    ji, ti = jcomplete.proj_infinity(J, (N,)), complete.proj_infinity(T, (N,))
    assert same_point(ji, tuple(c.expand(T.num_limbs, N) for c in ti))
    # three tensors, each its own storage
    assert len({c.data_ptr() for c in ti}) == 3
    # infinity is the identity of the complete add, by value
    s = complete.padd(tp, ti, T)
    js = jcomplete.padd(jp, ji, J)
    assert same_point(js, s)
