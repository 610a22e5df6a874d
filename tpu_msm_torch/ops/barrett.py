"""Barrett reduction and the full-width field multiply on planar limbs.

The port of `tpu_msm/ops/barrett.py`: the schoolbook wide multiply,
`barrett_reduce`, `field_mul` and `to_mont_barrett`. Limbs are int64
tensors (see `ops/limbs.py`). With base b = 2^w, k = num_limbs (p < b^k)
and mu = floor(b^2k / p):

    q  = floor( floor(x / b^(k-1)) * mu / b^(k+1) )
    r  = x - q*p   (computed mod b^(k+1); r < 3p, two conditional subtracts)
"""

from __future__ import annotations

import torch

from ..constants import CurveParams
from . import limbs

I64 = torch.int64


def mul_wide(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
             ) -> torch.Tensor:
    """La x Lb limb multiply -> La + Lb canonical limbs of the product.

    The JAX function ripples a carry through every row of the schoolbook
    in uint32 (t + a*b + c <= 2^32 - 1 exactly). With int64 limbs the
    carries can wait: the column sums of the 16-bit limb products are
    taken first (at most min(La, Lb) products below 2^32 each, so below
    2^38 for any operand under 64 limbs) and one ripple follows. The
    canonical limbs of a product are unique, so the result is the same
    bit for bit. `>>` acts on non-negative values only."""
    la, lb = a.shape[0], b.shape[0]
    if min(la, lb) >= 64:
        raise ValueError("mul_wide: column sums would leave the int64 bound")
    mask = (1 << log_limb_size) - 1
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    t = torch.zeros((la + lb,) + shape, dtype=I64, device=a.device)
    for i in range(la):
        t[i:i + lb] += a[i] * b
    carry = 0
    for k in range(la + lb):
        s = t[k] + carry
        t[k] = s & mask
        carry = s >> log_limb_size
    return t


def barrett_reduce(x: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """A 2L-limb product mod p -> L canonical limbs, value < p."""
    L = curve.num_limbs
    w = curve.log_limb_size
    q1 = x[L - 1:]                      # floor(x / b^(k-1)): L+1 limbs
    q2 = mul_wide(q1, limbs.const(curve.mu_limbs(), x), w)   # 2L+2 limbs
    q3 = q2[L + 1:]                     # floor(q2 / b^(k+1)): L+1 limbs
    p_wide = limbs.const(curve.p_wide_limbs(), x)
    # q3 * p mod b^(k+1): its low L+1 limbs suffice since r < b^(k+1)
    qp = mul_wide(q3, p_wide, w)[:L + 1]
    r = limbs.sub_with_borrow(x[:L + 1], qp, w)[0]   # exact: x - q p >= 0
    # r < 3p: at most two conditional subtracts
    for _ in range(2):
        d, borrow = limbs.sub_with_borrow(r, p_wide, w)
        r = limbs.select(borrow == 0, d, r)
    return r[:L]


def field_mul(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
              ) -> torch.Tensor:
    """(a * b) mod p in standard form, through Barrett."""
    return barrett_reduce(mul_wide(a, b, curve.log_limb_size), curve)


def to_mont_barrett(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Montgomery encode by Barrett: field_mul(a, R mod p)."""
    return field_mul(a, limbs.const(curve.r_limbs(), a).expand_as(a), curve)
