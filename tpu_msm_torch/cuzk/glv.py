"""Device-side GLV scalar split and endomorphism point-stream doubling.

The port of `tpu_msm/cuzk/glv.py` (see `tpu_msm_torch/glv.py` for the
math and the parameter derivation): planar fixed-point Babai rounding on
16-bit halfword limbs, giving for each scalar k the pair (|k1|, |k2|)
and two sign masks with k = +-|k1| + lambda * (+-|k2|) mod r.

`apply_glv` then rewrites the pipeline inputs:

    points:  (P_i)          -> (sign1_i * P_i, sign2_i * phi(P_i))
    digits:  decompose(k)   -> decompose(|k1|) ++ decompose(|k2|)

so every later stage runs unchanged on a 2n-point stream with
`cfg.num_windows` halved. Signs are applied by negating y, not the
digits: a negated digit +2^(s-1) would leave the signed-digit range (and
int16 at s = 16).

In the JAX package these are XLA ops outside any Pallas kernel, and here
they are torch ops on the device of their inputs; only the digits go
through a kernel (`kernels.decompose_digits`). The halfword arithmetic
runs on int64 limbs (`ops/limbs.py` says why).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MSMConfig
from ..constants import int_to_limbs
from ..glv import M_SHIFT, GLVParams
from ..ops import limbs, rows
from ..ops.barrett import mul_wide
from . import kernels

I32 = torch.int32
I64 = torch.int64

# working width of the lattice combination: 12 halfwords = 192 bits of
# two's complement, which hold |k_i| <= 2^127 and a sign
B_LIMBS = 12
_B_BITS = 16 * B_LIMBS


def _const(value: int, num_limbs: int, device) -> torch.Tensor:
    """Non-negative int -> (num_limbs, 1) int64 halfwords, broadcastable
    over the lanes."""
    return torch.tensor(int_to_limbs(value, num_limbs, 16), dtype=I64,
                        device=device)[:, None]


def split_scalars(halfwords: torch.Tensor, glvp: GLVParams
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """(H, n) scalar halfwords -> (neg1, mag1, neg2, mag2).

    The mags are (B_LIMBS, n) int32 halfword magnitudes |k1|, |k2|; the
    negs are (n,) bool sign masks. Bit for bit `GLVParams.decompose`: two
    mul-shift Babai roundings, two lattice combinations in two's
    complement mod 2^192, then sign and magnitude."""
    dev = halfwords.device
    n = halfwords.shape[1]
    r = glvp.curve.scalar_modulus
    hs = (r.bit_length() + 15) // 16
    k = halfwords[:hs].to(I64)
    shift_limbs = M_SHIFT // 16                       # 17

    cs = []
    for g in (glvp.g1, glvp.g2):
        gh = max(1, (g.bit_length() + 15) // 16)
        prod = mul_wide(k, _const(g, gh, dev))        # (hs + gh, n)
        # rounding addend 2^(M_SHIFT-1): bit 15 of halfword 16
        rnd = _const(1 << (M_SHIFT - 1), prod.shape[0], dev)
        prod = limbs.add_unsafe(prod, rnd)
        c = prod[shift_limbs:]                        # >> M_SHIFT
        # c < 2^129 (k < 2^255, g < 2^147): pad or trim to 9 limbs
        if c.shape[0] < 9:
            c = torch.cat([c, c.new_zeros((9 - c.shape[0], n))])
        cs.append(c[:9])
    c1, c2 = cs

    def mul_mod_b(c: torch.Tensor, const: int) -> torch.Tensor:
        """c * const mod 2^_B_BITS (a negative const by its two's
        complement representative)."""
        return mul_wide(c, _const(const % (1 << _B_BITS), B_LIMBS, dev)
                        )[:B_LIMBS]

    zero = torch.zeros((B_LIMBS, n), dtype=I64, device=dev)
    # k[:B_LIMBS] drops the top halfwords of k on purpose: mod 2^192
    k1 = limbs.sub(limbs.sub(k[:B_LIMBS], mul_mod_b(c1, glvp.a1)),
                   mul_mod_b(c2, glvp.a2))
    k2 = limbs.sub(zero, limbs.add_unsafe(mul_mod_b(c1, glvp.b1),
                                          mul_mod_b(c2, glvp.b2)))

    def sign_mag(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        neg = (x[B_LIMBS - 1] >> 15) == 1             # two's complement sign
        mag = limbs.select(neg, limbs.sub(zero, x), x)
        return neg, mag.to(I32)

    neg1, mag1 = sign_mag(k1)
    neg2, mag2 = sign_mag(k2)
    return neg1, mag1, neg2, mag2


def apply_glv(xm: torch.Tensor, ym: torch.Tensor, halfwords: torch.Tensor,
              cfg: MSMConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Montgomery-encoded (L, n) points and raw (H, n) scalar halfwords ->
    the doubled GLV stream (xm', ym', digits): n' = 2n lanes of canonical
    limbs and (cfg.num_windows, 2n) int16 signed digits.

    Lanes [0, n) carry sign1 * P with the digits of |k1|, lanes [n, 2n)
    carry sign2 * phi(P) with the digits of |k2|."""
    curve = cfg.curve
    glvp = cfg.glv_params
    W, s = cfg.num_windows, cfg.window_size
    # the top window reads halfword ((W-1)*s >> 4) + 1, which must exist
    if ((W - 1) * s >> 4) + 1 >= B_LIMBS:
        raise ValueError("apply_glv: the windows reach past the "
                         f"{B_LIMBS}-halfword magnitudes")

    neg1, mag1, neg2, mag2 = split_scalars(halfwords, glvp)
    d1 = kernels.decompose_digits(mag1.contiguous(), s, W)
    d2 = kernels.decompose_digits(mag2.contiguous(), s, W)
    digits = torch.cat([d1, d2], dim=1)               # (W, 2n)

    # phi(P) = (beta * x, y); the signs fold into y (-P = (x, -y))
    xb = rows.mont_mul_rows(
        xm, rows.const_rows(curve.to_mont(glvp.beta), curve, xm), curve)
    # 2p - y, rippled again: the int16 row table needs canonical limbs
    yn = rows.canon_rows(rows.neg_rows(ym, curve, 2), curve)
    y1 = rows.select_rows(neg1, yn, ym)
    y2 = rows.select_rows(neg2, yn, ym)
    return torch.cat([xm, xb], dim=-1), torch.cat([y1, y2], dim=-1), digits
