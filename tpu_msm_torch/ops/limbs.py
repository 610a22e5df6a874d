"""Planar multi-limb big-integer arithmetic on halfword tensors.

The part of `tpu_msm/ops/limbs.py` that the GLV scalar split needs:
`add_unsafe`, `sub` and `select`. A big-integer batch is one
(num_limbs, ...batch) tensor, limb axis first, each limb holding
`log_limb_size` (16) bits.

The JAX module works in uint32, which PyTorch has next to no arithmetic
for, and int32 would overflow: the limbs here are int64. Every value
stays far inside int64: a sum of two 16-bit limbs and a carry is below
2^17, and a difference is above -2^17. `>>` is only ever applied to a
non-negative value, and a borrow is read off the sign; `& mask` of a
negative int64 gives the same low bits as the uint32 wraparound.
"""

from __future__ import annotations

import torch

I64 = torch.int64


def add_unsafe(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
               ) -> torch.Tensor:
    """Limbwise add with carry ripple, the final carry dropped (the sum is
    taken mod 2^(num_limbs * w))."""
    mask = (1 << log_limb_size) - 1
    out = []
    carry = 0
    for i in range(a.shape[0]):
        s = a[i] + b[i] + carry
        out.append(s & mask)
        carry = s >> log_limb_size
    return torch.stack(torch.broadcast_tensors(*out))


def sub(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
        ) -> torch.Tensor:
    """a - b mod 2^(num_limbs * w) by a borrow ripple (exact for a >= b;
    otherwise the two's complement representative)."""
    mask = (1 << log_limb_size) - 1
    out = []
    borrow = 0
    for i in range(a.shape[0]):
        d = a[i] - b[i] - borrow
        out.append(d & mask)
        borrow = (d < 0).to(I64)
    return torch.stack(torch.broadcast_tensors(*out))


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """Per-element limb-array select: cond has the batch shape."""
    return torch.where(cond[None], a, b)
