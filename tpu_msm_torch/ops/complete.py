"""Complete projective point arithmetic (Renes-Costello-Batina, a = 0)
on signed lazy limbs.

The port of `tpu_msm/ops/complete.py`: Algorithms 7 (padd), 8 (pmadd,
Z2 == 1) and 9 (pdbl) of "Complete addition formulas for prime order
elliptic curves" (EUROCRYPT 2016), with no exceptional cases: one
straight-line formula for every input pair, doubling, cancellation and
the point at infinity (0 : 1 : 0) included. Coordinates are Montgomery
form limbs of `ops/lazy.py`, values < 4p.

`ops/rows.py` computes the same formulas in the same order, and the tests
hold these functions bit for bit against both the JAX module and
rows.py at the relaxed extremes; so the three formulas delegate to
rows.py, and `ProjPoint` is its `ProjRows`.
"""

from __future__ import annotations

import torch

from ..constants import CurveParams
from . import rows

I32 = torch.int32

ProjPoint = rows.ProjRows


def proj_infinity(curve: CurveParams, batch_shape=(), device="cpu"
                  ) -> ProjPoint:
    """(0 : 1 : 0) with 1 in Montgomery form; three separate tensors, so
    a caller may write into one."""
    zero = torch.zeros((curve.num_limbs,) + tuple(batch_shape), dtype=I32,
                       device=device)
    return rows.proj_infinity_rows(curve, zero)


def select(cond: torch.Tensor, a: ProjPoint, b: ProjPoint) -> ProjPoint:
    """Lane-wise point select: cond has the batch shape."""
    return ProjPoint(*(rows.select_rows(cond, u, v) for u, v in zip(a, b)))


def padd(p1: ProjPoint, p2: ProjPoint, curve: CurveParams) -> ProjPoint:
    """RCB Algorithm 7 (complete add): inputs < 4p, outputs < 4p."""
    return rows.padd_rows(p1, p2, curve)


def pmadd(p1: ProjPoint, x2: torch.Tensor, y2: torch.Tensor,
          curve: CurveParams) -> ProjPoint:
    """RCB Algorithm 8 (complete mixed add, Z2 == 1): complete for every
    p1; (x2, y2) must be a real affine point in Montgomery form."""
    return rows.pmadd_rows(p1, x2, y2, curve)


def pdbl(p: ProjPoint, curve: CurveParams) -> ProjPoint:
    """RCB Algorithm 9 (complete doubling)."""
    return rows.pdbl_rows(p, curve)
