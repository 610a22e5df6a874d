"""Prime-field arithmetic (mod p) on planar limb tensors, branchless.

The port of `tpu_msm/ops/field.py` on the int64 limbs of `ops/limbs.py`.
Every function maps fully reduced inputs (< p) to fully reduced outputs
(< p), so limbwise equality of representatives is field equality, which
the U1 == U2 / S1 == S2 tests of `ops/curve.py` rely on.
"""

from __future__ import annotations

import torch

from ..constants import CurveParams
from . import limbs

I64 = torch.int64


def p_array(curve: CurveParams, batch_shape=(), device="cpu") -> torch.Tensor:
    """The modulus as an (L,) + (1,) * len(batch_shape) int64 constant."""
    p = torch.tensor(curve.p_limbs(), dtype=I64, device=device)
    return p.reshape((curve.num_limbs,) + (1,) * len(batch_shape))


def _p_like(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    return p_array(curve, a.shape[1:], a.device).expand_as(a)


def ff_reduce(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Reduce once: a - p if a >= p."""
    d, borrow = limbs.sub_with_borrow(a, _p_like(a, curve),
                                      curve.log_limb_size)
    return limbs.select(borrow == 0, d, a)


def ff_add(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
           ) -> torch.Tensor:
    """(a + b) mod p for a, b < p: a + b < 2p < 2^(L w), so add_unsafe
    and one reduction are exact."""
    return ff_reduce(limbs.add_unsafe(a, b, curve.log_limb_size), curve)


def ff_sub(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
           ) -> torch.Tensor:
    """(a - b) mod p for a, b < p: a - b and a - b + p, selected on the
    borrow."""
    d, borrow = limbs.sub_with_borrow(a, b, curve.log_limb_size)
    d_plus_p = limbs.add_unsafe(d, _p_like(d, curve), curve.log_limb_size)
    return limbs.select(borrow == 0, d, d_plus_p)


def ff_neg(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """(-a) mod p, with -0 == 0."""
    d = limbs.sub(_p_like(a, curve), a, curve.log_limb_size)
    return limbs.select(limbs.is_zero(a), a, d)


def ff_double(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    return ff_add(a, a, curve)
