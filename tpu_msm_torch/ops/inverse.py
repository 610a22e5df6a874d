"""Batched modular inversion and projective -> affine normalisation.

The port of `tpu_msm/ops/inverse.py` on stacked (L, ...) int32 tensors,
built on `ops/rows.py`, in the Montgomery domain on signed lazy limbs.
The functions run where their tensors are (CPU or CUDA).

  * `fermat_inv`: a^(p-2) by left-to-right square-and-multiply over the
    static exponent bits. Maps 0 to 0, which is what the Z-normalisation
    wants.
  * `batch_inverse`: product-tree batched inversion, about three
    Montgomery multiplies per element at log2(K) vector depth and one
    `fermat_inv` at the root. Zeros are replaced by one on the way up and
    zeroed again in the result, so it agrees with `fermat_inv` element
    by element. The plain version of the kernel csrc/batch_inverse.cu,
    whose wrapper is `cuzk/kernels.batch_inverse`, the public
    `tpu_msm_torch.batch_inverse`.
  * `to_affine_plain`: (X : Y : Z) -> (X/Z, Y/Z) and the infinity mask,
    on the product tree above; the plain version of the kernel
    csrc/to_affine.cu, whose wrapper is `cuzk/kernels.to_affine`, the
    public `tpu_msm_torch.to_affine`.
Both kernels walk this tree (csrc/batch_inv.cuh), operand for operand.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import CurveParams
from . import rows


def is_zero_val(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Zero test by value for lazy limbs with value in [0, 2p): zero is
    the canonical limbs of 0 or of p."""
    c = rows.canon_rows(a, curve)
    p_limbs = rows.const_rows(curve.p, curve, a)
    return (c == 0).all(dim=0) | (c == p_limbs).all(dim=0)


def reduce_once(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Canonical limbs with value < 2p -> fully reduced value < p: compare
    with p, subtract p where >=, and ripple again."""
    c = rows.canon_rows(a, curve)
    p_limbs = rows.const_rows(curve.p, curve, a)
    # lexicographic >= built from the least significant limb up: the limb
    # taken last decides, so the top limb has the last word
    gte = torch.ones(c.shape[1:], dtype=torch.bool, device=c.device)
    for j in range(c.shape[0]):
        pj = p_limbs[j]
        gte = (c[j] > pj) | ((c[j] == pj) & gte)
    return rows.canon_rows(torch.where(gte, c - p_limbs, c), curve)


def fermat_inv(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Montgomery-domain inverse by Fermat: given a*R (value < 32p),
    returns a^(-1)*R as canonical limbs < 2p; zero maps to zero."""
    e = curve.p - 2
    nbits = e.bit_length()
    a_c = rows.canon_rows(a, curve)
    acc = rows.mont_one_rows(curve, a)
    for i in range(nbits):
        acc = rows.mont_mul_rows(acc, acc, curve)
        # the exponent is static: the multiply the JAX loop selects away
        # on a zero bit is not computed at all
        if (e >> (nbits - 1 - i)) & 1:
            acc = rows.mont_mul_rows(acc, a_c, curve)
    return acc


def batch_inverse(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Elementwise Montgomery-domain inverse of an (L, *batch) tensor by a
    product tree; zeros map to zero. Canonical limbs, value < 2p."""
    L = a.shape[0]
    flat = a.reshape(L, -1)
    K = flat.shape[1]
    zero = is_zero_val(flat, curve)
    one = rows.mont_one_rows(curve, flat)
    flat = torch.where(zero, one, rows.canon_rows(flat, curve))

    Kp = 1 << max((K - 1).bit_length(), 0)
    if Kp != K:
        flat = torch.cat([flat, one[:, :1].expand(L, Kp - K)], dim=1)

    # up-sweep: pairwise products, every level kept for the down-sweep
    levels = [flat]
    cur = flat
    while cur.shape[1] > 1:
        cur = rows.mont_mul_rows(cur[:, 0::2], cur[:, 1::2], curve)
        levels.append(cur)

    inv = fermat_inv(levels[-1], curve)
    # down-sweep: the children's inverses from the parent's inverse and
    # the sibling's stored subtree product
    for v in reversed(levels[:-1]):
        left = rows.mont_mul_rows(inv, v[:, 1::2], curve)
        right = rows.mont_mul_rows(inv, v[:, 0::2], curve)
        inv = torch.stack([left, right], dim=2).reshape(L, v.shape[1])

    inv = inv[:, :K]
    inv = torch.where(zero, torch.zeros_like(inv), inv)
    return inv.reshape(a.shape)


def to_affine_plain(p, curve: CurveParams
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projective (X : Y : Z), a `rows.ProjRows` or a stacked (3, L, ...)
    tensor, -> affine (X/Z, Y/Z) and the infinity mask.

    The coordinates come back fully reduced (< p) in the Montgomery
    domain; infinity lanes (Z = 0 in the field) give (0, 0, True).

    Z is first multiplied by the Montgomery one, which brings its value
    into [0, 2p) where `is_zero_val` holds. The JAX function tests Z as it
    comes, and a lazy Z of value 2p or 3p (the window sums of all-zero
    digits are such) passes for non-zero there and zeroes the whole
    product tree. The outputs are fully reduced, so on every input the
    JAX function gets right the two agree bit for bit."""
    px, py, pz = (c.to(torch.int32) for c in p)
    pz = rows.mont_mul_rows(pz, rows.mont_one_rows(curve, pz), curve)
    zinv = batch_inverse(pz, curve)
    inf = is_zero_val(pz, curve)
    x = reduce_once(rows.mont_mul_rows(px, zinv, curve), curve)
    y = reduce_once(rows.mont_mul_rows(py, zinv, curve), curve)
    x = torch.where(inf, torch.zeros_like(x), x)
    y = torch.where(inf, torch.zeros_like(y), y)
    return x, y, inf

