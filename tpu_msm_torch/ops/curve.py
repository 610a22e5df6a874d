"""Jacobian curve arithmetic on planar Montgomery-form limb tensors.

The port of `tpu_msm/ops/curve.py`, the classical unsigned point layer:
dbl-2009-l, add-2007-bl and madd-2007-bl with their exceptional cases
(infinity, doubling, cancellation) resolved by lane selects, negation,
representative equality and a 32-bit double-and-add. A point batch is a
`JacPoint(x, y, z)` of three (num_limbs, ...batch) int64 tensors of
Montgomery-form coordinates (`ops/mont.py`, `ops/field.py`); z == 0
encodes infinity.

The JAX `dbl_mode` has no counterpart. Its "select" computes the
doubling for every lane and selects it where U1 == U2 and S1 == S2; its
"cond" computes the doubling only when some lane needs it and then
selects the same way, so each lane's result is the same under both.
The port always computes the doubling and selects per lane, which is
the JAX result under either mode.

The groups here have odd prime order, so y == 0 never occurs on the
curve and dbl's z3 = 2 y z vanishes only at infinity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import CurveParams
from . import limbs
from .field import ff_add, ff_neg, ff_sub
from .mont import mont_mul

I64 = torch.int64


class JacPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def infinity(curve: CurveParams, batch_shape=(), device="cpu") -> JacPoint:
    """Canonical infinity: all-zero coordinates (z == 0 is what counts)."""
    z = torch.zeros((curve.num_limbs,) + tuple(batch_shape), dtype=I64,
                    device=device)
    return JacPoint(z, z, z)


def is_inf(pt: JacPoint) -> torch.Tensor:
    """z == 0."""
    return limbs.is_zero(pt.z)


def select_point(cond: torch.Tensor, a: JacPoint, b: JacPoint) -> JacPoint:
    """Lane-wise point select: cond has the batch shape."""
    return JacPoint(limbs.select(cond, a.x, b.x),
                    limbs.select(cond, a.y, b.y),
                    limbs.select(cond, a.z, b.z))


def jac_eq_limbwise(a: JacPoint, b: JacPoint) -> torch.Tensor:
    """Equality of representatives, limb by limb (not projective
    equality; group equality is the oracle's `jac_eq`)."""
    return limbs.eq(a.x, b.x) & limbs.eq(a.y, b.y) & limbs.eq(a.z, b.z)


def jac_neg(pt: JacPoint, curve: CurveParams) -> JacPoint:
    """(x, -y, z); ff_neg maps the all-zero y of infinity to itself."""
    return JacPoint(pt.x, ff_neg(pt.y, curve), pt.z)


def jac_dbl(pt: JacPoint, curve: CurveParams) -> JacPoint:
    """dbl-2009-l; needs no infinity select (z3 = 2 y1 z1 vanishes
    exactly when z1 does)."""
    x1, y1, z1 = pt
    mul = lambda a, b: mont_mul(a, b, curve)
    a = mul(x1, x1)
    b = mul(y1, y1)
    c = mul(b, b)
    t = ff_add(x1, b, curve)
    t = mul(t, t)
    d = ff_sub(ff_sub(t, a, curve), c, curve)
    d = ff_add(d, d, curve)
    e = ff_add(ff_add(a, a, curve), a, curve)
    f = mul(e, e)
    x3 = ff_sub(f, ff_add(d, d, curve), curve)
    c2 = ff_add(c, c, curve)
    c4 = ff_add(c2, c2, curve)
    c8 = ff_add(c4, c4, curve)
    y3 = ff_sub(mul(e, ff_sub(d, x3, curve)), c8, curve)
    z3 = mul(ff_add(y1, y1, curve), z1)
    return JacPoint(x3, y3, z3)


def jac_add(p1: JacPoint, p2: JacPoint, curve: CurveParams) -> JacPoint:
    """add-2007-bl with the exceptional cases selected per lane:

        p1 == inf            -> p2
        p2 == inf            -> p1
        U1 == U2, S1 == S2   -> dbl(p1)
        U1 == U2, S1 != S2   -> inf        (p1 == -p2)
        otherwise            -> the generic sum
    """
    mul = lambda a, b: mont_mul(a, b, curve)
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = mul(z1, z1)
    z2z2 = mul(z2, z2)
    u1 = mul(x1, z2z2)
    u2 = mul(x2, z1z1)
    s1 = mul(mul(y1, z2), z2z2)
    s2 = mul(mul(y2, z1), z1z1)

    h = ff_sub(u2, u1, curve)
    h2 = ff_add(h, h, curve)
    i = mul(h2, h2)
    j = mul(h, i)
    r = ff_sub(s2, s1, curve)
    r = ff_add(r, r, curve)
    v = mul(u1, i)
    x3 = ff_sub(ff_sub(mul(r, r), j, curve), ff_add(v, v, curve), curve)
    s1j = mul(s1, j)
    y3 = ff_sub(mul(r, ff_sub(v, x3, curve)), ff_add(s1j, s1j, curve), curve)
    z12 = ff_add(z1, z2, curve)
    zz = ff_sub(ff_sub(mul(z12, z12), z1z1, curve), z2z2, curve)
    z3 = mul(zz, h)
    res = JacPoint(x3, y3, z3)

    p1_inf = is_inf(p1)
    p2_inf = is_inf(p2)
    both = ~p1_inf & ~p2_inf
    x_eq = limbs.eq(u1, u2)
    y_eq = limbs.eq(s1, s2)
    res = select_point(both & x_eq & y_eq, jac_dbl(p1, curve), res)
    res = select_point(both & x_eq & ~y_eq,
                       infinity(curve, x1.shape[1:], x1.device), res)
    res = select_point(p2_inf, p1, res)
    return select_point(p1_inf, p2, res)


def jac_madd(p1: JacPoint, x2: torch.Tensor, y2: torch.Tensor,
             curve: CurveParams, p2_inf: torch.Tensor | None = None
             ) -> JacPoint:
    """madd-2007-bl: mixed add with an affine p2 (z2 == 1 implied).
    `p2_inf` marks the lanes whose affine operand is the identity."""
    mul = lambda a, b: mont_mul(a, b, curve)
    x1, y1, z1 = p1
    z1z1 = mul(z1, z1)
    u2 = mul(x2, z1z1)
    s2 = mul(mul(y2, z1), z1z1)

    h = ff_sub(u2, x1, curve)
    hh = mul(h, h)
    i2 = ff_add(hh, hh, curve)
    i = ff_add(i2, i2, curve)
    j = mul(h, i)
    r = ff_sub(s2, y1, curve)
    r = ff_add(r, r, curve)
    v = mul(x1, i)
    x3 = ff_sub(ff_sub(mul(r, r), j, curve), ff_add(v, v, curve), curve)
    y1j = mul(y1, j)
    y3 = ff_sub(mul(r, ff_sub(v, x3, curve)), ff_add(y1j, y1j, curve), curve)
    z1h = ff_add(z1, h, curve)
    z3 = ff_sub(ff_sub(mul(z1h, z1h), z1z1, curve), hh, curve)
    res = JacPoint(x3, y3, z3)

    p1_inf = is_inf(p1)
    if p2_inf is None:
        p2_inf = torch.zeros(x2.shape[1:], dtype=torch.bool,
                             device=x2.device)
    both = ~p1_inf & ~p2_inf
    x_eq = limbs.eq(x1, u2)
    y_eq = limbs.eq(y1, s2)
    res = select_point(both & x_eq & y_eq, jac_dbl(p1, curve), res)
    one = torch.tensor(curve.r_limbs(), dtype=I64, device=x2.device)
    p2_as_jac = JacPoint(x2, y2, one.reshape(
        (curve.num_limbs,) + (1,) * (x2.dim() - 1)).expand_as(x2))
    res = select_point(both & x_eq & ~y_eq,
                       infinity(curve, x2.shape[1:], x2.device), res)
    res = select_point(p2_inf, p1, res)
    return select_point(p1_inf & ~p2_inf, p2_as_jac, res)


def jac_scalar_mul_u32(pt: JacPoint, k: torch.Tensor, curve: CurveParams
                       ) -> JacPoint:
    """Per-lane double-and-add over the 32 bits of k (an integer tensor of
    the batch shape, values in [0, 2^32)): 32 fixed steps of a selected
    add and a doubling."""
    acc = infinity(curve, pt.x.shape[1:], pt.x.device)
    base = pt
    kk = k.to(I64)
    for _ in range(32):
        bit = (kk & 1) == 1
        acc = select_point(bit, jac_add(acc, base, curve), acc)
        base = jac_dbl(base, curve)
        kk = kk >> 1
    return acc
