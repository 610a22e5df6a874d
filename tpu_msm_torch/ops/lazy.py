"""Signed lazy-reduction field arithmetic on int32 torch tensors.

The port of `tpu_msm/ops/lazy.py`, the stacked-limb form of the signed
field layer: limbs are int32 holding w-bit digits, planar (L, ...batch);
add, sub, neg and smallmul are single tensor ops (sub adds k p so values
stay non-negative while limbs may go negative); fold re-bounds limbs
without a ripple; mont_mul is the deferred-carry Montgomery multiply
(inputs of value <= 32p, limbs |.| <= 2^13; canonical outputs of value
< 2p).

`ops/rows.py` computes the same operations, and the tests hold these
functions bit for bit against both the JAX module and rows.py,
including the relaxed extremes of the bound ledger. So sub, neg, fold,
canonicalize, mont_mul and to_mont delegate to rows.py: the port keeps
one Montgomery multiply.
"""

from __future__ import annotations

import torch

from ..constants import CurveParams, int_to_limbs
from . import rows

I32 = torch.int32


def const_limbs(value: int, curve: CurveParams, batch_ndim: int = 1,
                num_limbs: int | None = None, device="cpu") -> torch.Tensor:
    """A non-negative constant as canonical int32 limbs of shape
    (L,) + (1,) * batch_ndim on `device`."""
    L = num_limbs or curve.num_limbs
    return torch.tensor(int_to_limbs(value, L, curve.log_limb_size),
                        dtype=I32, device=device
                        ).reshape((L,) + (1,) * batch_ndim)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy add: values add, limb bounds add."""
    return a + b


def sub(a: torch.Tensor, b: torch.Tensor, curve: CurveParams, k: int
        ) -> torch.Tensor:
    """a - b + k p: the value stays non-negative for value(b) < k p."""
    return rows.sub_rows(a, b, curve, k)


def neg(a: torch.Tensor, curve: CurveParams, k: int) -> torch.Tensor:
    """k p - a (value(a) < k p); k is a bound multiplier."""
    return rows.neg_rows(a, curve, k)


def smallmul(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a small non-negative integer; limb bounds scale by c."""
    return a * c


def fold(a: torch.Tensor, curve: CurveParams, passes: int = 1
         ) -> torch.Tensor:
    """Re-bound limbs toward [0, 2^w) without changing the value."""
    return rows.fold_rows(a, curve, passes)


def canonicalize(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Full carry ripple -> canonical limbs in [0, 2^w), for values in
    [0, 2^(w L))."""
    return rows.canon_rows(a, curve)


def mont_mul(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
             ) -> torch.Tensor:
    """Deferred-carry Montgomery multiply on signed lazy limbs."""
    return rows.mont_mul_rows(a, b, curve)


def to_mont(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Canonical standard-form limbs -> Montgomery form (times R^2)."""
    return rows.to_mont_rows(a, curve)


def mont_one(curve: CurveParams, batch_ndim: int = 1, device="cpu"
             ) -> torch.Tensor:
    """1 in Montgomery form (R mod p), canonical limbs."""
    return const_limbs(curve.r_mod_p, curve, batch_ndim, device=device)
