"""Schoolbook wide multiply on planar halfword limbs.

The part of `tpu_msm/ops/barrett.py` that the GLV scalar split needs:
`mul_wide`. Limbs are int64 tensors (see `ops/limbs.py`).
"""

from __future__ import annotations

import torch

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
