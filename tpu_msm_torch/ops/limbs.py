"""Planar multi-limb big-integer arithmetic on halfword tensors.

The port of `tpu_msm/ops/limbs.py`. A big-integer batch is one
(num_limbs, ...batch) tensor, limb axis first, each limb holding
`log_limb_size` (at most 16) bits.

The JAX module works in uint32, which PyTorch has next to no arithmetic
for, and int32 would overflow: the limbs here are int64. Every value
stays far inside int64: a sum of two 16-bit limbs and a carry is below
2^17, and a difference is above -2^17. `>>` is only ever applied to a
non-negative value, and a borrow is read off the sign; `& mask` of a
negative int64 gives the same low bits as the uint32 wraparound. So
every result equals the JAX uint32 result.
"""

from __future__ import annotations

from typing import Tuple

import torch

I64 = torch.int64


def const(limb_list, like: torch.Tensor) -> torch.Tensor:
    """Limbs of a constant as an int64 (len, 1, ...) tensor on `like`'s
    device, broadcastable over `like`'s batch."""
    return torch.tensor(limb_list, dtype=I64, device=like.device).reshape(
        (len(limb_list),) + (1,) * (like.dim() - 1))


def zeros_like_batch(ref: torch.Tensor, num_limbs: int) -> torch.Tensor:
    return torch.zeros((num_limbs,) + ref.shape[1:], dtype=I64,
                       device=ref.device)


def _add(a: torch.Tensor, b: torch.Tensor, log_limb_size: int
         ) -> Tuple[list, torch.Tensor]:
    """The limbs of a + b and the carry out of the top limb."""
    mask = (1 << log_limb_size) - 1
    out = []
    carry = 0
    for i in range(a.shape[0]):
        s = a[i] + b[i] + carry
        out.append(s & mask)
        carry = s >> log_limb_size
    return out, carry


def add_unsafe(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
               ) -> torch.Tensor:
    """Limbwise add with carry ripple, the final carry dropped (the sum is
    taken mod 2^(num_limbs * w))."""
    out, _ = _add(a, b, log_limb_size)
    return torch.stack(torch.broadcast_tensors(*out))


def add_wide(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
             ) -> torch.Tensor:
    """Limbwise add returning num_limbs + 1 limbs (the carry on top)."""
    out, carry = _add(a, b, log_limb_size)
    return torch.stack(torch.broadcast_tensors(*out, carry))


def sub_with_borrow(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a - b limbwise: (difference mod 2^(num_limbs * w), final borrow in
    {0, 1} of the batch shape)."""
    mask = (1 << log_limb_size) - 1
    out = []
    borrow = torch.zeros(torch.broadcast_shapes(a.shape[1:], b.shape[1:]),
                         dtype=I64, device=a.device)
    for i in range(a.shape[0]):
        d = a[i] - b[i] - borrow
        out.append(d & mask)
        borrow = (d < 0).to(I64)
    return torch.stack(torch.broadcast_tensors(*out)), borrow


def sub(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
        ) -> torch.Tensor:
    """a - b mod 2^(num_limbs * w) by a borrow ripple (exact for a >= b;
    otherwise the two's complement representative)."""
    return sub_with_borrow(a, b, log_limb_size)[0]


def gte(a: torch.Tensor, b: torch.Tensor, log_limb_size: int = 16
        ) -> torch.Tensor:
    """a >= b, boolean of the batch shape."""
    return sub_with_borrow(a, b, log_limb_size)[1] == 0


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limbwise equality reduced over the limb axis."""
    return torch.all(a == b, dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """All limbs zero."""
    return torch.all(a == 0, dim=0)


def to_wide(a: torch.Tensor) -> torch.Tensor:
    """Append one zero limb."""
    return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])


def from_wide(a: torch.Tensor, num_limbs: int) -> torch.Tensor:
    """Drop the high limbs (the caller guarantees they are zero)."""
    return a[:num_limbs]


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """Per-element limb-array select: cond has the batch shape."""
    return torch.where(cond[None], a, b)
