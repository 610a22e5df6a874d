"""The port's field and point arithmetic (tpu_msm_torch/ops/rows.py)
against the JAX list-form rows (tpu_msm/ops/rows.py) on the same inputs,
bit for bit, on TINY62, BN254_S12 and BN254_S13 (whose 13-bit limbs take
the mid-loop carry fold of the Montgomery multiply)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.ops import rows as jrows
from tpu_msm_torch import constants as tc
from tpu_msm_torch.ops import rows as trows

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

PROFILES = ["tiny62", "bn254_s12", "bn254_s13"]
BATCH = (4, 8)


def rand_limbs(curve, rng, signed=False):
    """(L, *BATCH) int32 limbs; signed=True spans (-2^w, 2^(w+1)), the
    lazy point-limb range, with a small non-negative top limb."""
    L, w = curve.num_limbs, curve.log_limb_size
    lo, hi = (-(1 << w) + 1, 1 << (w + 1)) if signed else (0, 1 << w)
    a = rng.integers(lo, hi, (L,) + BATCH).astype(np.int32)
    if signed:
        a[-1] = np.abs(a[-1]) % 8 + 1
    return a


def jr(a):
    return jrows.from_stacked(jnp.asarray(a))


def same(jax_rows, t):
    return np.array_equal(np.asarray(jrows.to_stacked(jax_rows)), t.numpy())


@pytest.fixture(params=PROFILES)
def curves(request):
    return jc.CURVES[request.param], tc.CURVES[request.param]


@pytest.mark.parametrize("signed", [False, True])
def test_mont_mul_rows(curves, signed):
    J, T = curves
    rng = np.random.default_rng(1)
    a, b = rand_limbs(J, rng, signed), rand_limbs(J, rng, signed)
    got = trows.mont_mul_rows(torch.from_numpy(a), torch.from_numpy(b), T)
    assert same(jrows.mont_mul_rows(jr(a), jr(b), J), got)


def test_fold_sub_neg_canon_rows(curves):
    J, T = curves
    rng = np.random.default_rng(2)
    a, b = rand_limbs(J, rng), rand_limbs(J, rng)
    d = a - 3 * b
    ta, tb, td = map(torch.from_numpy, (a, b, d))
    assert same(jrows.fold_rows(jr(d), J), trows.fold_rows(td.clone(), T))
    assert same(jrows.fold_rows(jr(d), J, passes=2),
                trows.fold_rows(td.clone(), T, passes=2))
    for k in (2, 4, 18):
        assert same(jrows.sub_rows(jr(a), jr(b), J, k),
                    trows.sub_rows(ta, tb, T, k))
    assert same(jrows.neg_rows(jr(a), J, 2), trows.neg_rows(ta, T, 2))
    pos = a + (1 << J.log_limb_size)      # value stays non-negative
    assert same(jrows.canon_rows(jr(pos), J),
                trows.canon_rows(torch.from_numpy(pos), T))


def test_to_mont_rows(curves):
    J, T = curves
    a = rand_limbs(J, np.random.default_rng(3))
    assert same(jrows.to_mont_rows(jr(a), J),
                trows.to_mont_rows(torch.from_numpy(a), T))


@pytest.mark.parametrize("op", ["padd", "pmadd", "pdbl", "pneg"])
def test_point_rows(curves, op):
    J, T = curves
    rng = np.random.default_rng(4)
    p = [rand_limbs(J, rng, signed=True) for _ in range(3)]
    q = [rand_limbs(J, rng, signed=True) for _ in range(3)]
    x2, y2 = rand_limbs(J, rng), rand_limbs(J, rng)
    jp, jq = jrows.ProjRows(*map(jr, p)), jrows.ProjRows(*map(jr, q))
    tp = trows.ProjRows(*map(torch.from_numpy, p))
    tq = trows.ProjRows(*map(torch.from_numpy, q))
    if op == "padd":
        want, got = jrows.padd_rows(jp, jq, J), trows.padd_rows(tp, tq, T)
    elif op == "pmadd":
        want = jrows.pmadd_rows(jp, jr(x2), jr(y2), J)
        got = trows.pmadd_rows(tp, torch.from_numpy(x2),
                               torch.from_numpy(y2), T)
    elif op == "pdbl":
        want, got = jrows.pdbl_rows(jp, J), trows.pdbl_rows(tp, T)
    else:
        want, got = jrows.pneg_rows(jp, J), trows.pneg_rows(tp, T)
    for w, g in zip(want, got):
        assert same(w, g)


def test_infinity_and_select_rows(curves):
    J, T = curves
    like = np.zeros((J.num_limbs,) + BATCH, np.int32)
    inf_j = jrows.proj_infinity_rows(J, jnp.zeros(BATCH, jnp.int32))
    inf_t = trows.proj_infinity_rows(T, torch.from_numpy(like))
    for w, g in zip(inf_j, inf_t):
        assert same(w, g)
    rng = np.random.default_rng(5)
    a, b = rand_limbs(J, rng), rand_limbs(J, rng)
    cond = rng.random(BATCH) < 0.5
    assert same(jrows.select_rows(jnp.asarray(cond), jr(a), jr(b)),
                trows.select_rows(torch.from_numpy(cond),
                                  torch.from_numpy(a), torch.from_numpy(b)))
