"""Montgomery multiplication on unsigned planar limb tensors.

The port of `tpu_msm/ops/mont.py`: CIOS for 16-bit limbs
(`mont_mul_cios`), the deferred-carry multiply for limbs of at most 13
bits (`mont_mul_deferred`), the NSAFE-gated form for 14 and 15 bits
(`mont_mul_modified`), the dispatcher `mont_mul`, and the encode and
decode helpers. These are the unsigned layers of the base and F profiles
(BN254, BLS12_377, BN254_F13, BLS12_377_F12); the signed-lazy multiply
of the MSM is `ops/rows.py` mont_mul_rows.

Limbs are int64 (see `ops/limbs.py`); inputs of another integer dtype
are widened first. The JAX functions run in uint32 and keep every
accumulator below 2^32 (CIOS: t + a b + c <= 2^32 - 1;
deferred: `constants.deferred_carry_headroom` > 1), so the same steps on
int64 give the same values; where the JAX code lets a product wrap
(t[0] * n0), only its low w bits are read, which int64 keeps too. The
JAX `unroll` argument has no counterpart: its two forms are
bit-identical.
"""

from __future__ import annotations

import torch

from ..constants import CurveParams, deferred_carry_headroom
from . import limbs

I64 = torch.int64


def _ripple(t: torch.Tensor, w: int) -> torch.Tensor:
    """Carry ripple of non-negative slots down to w-bit limbs."""
    mask = (1 << w) - 1
    out = []
    c = 0
    for j in range(t.shape[0]):
        s = t[j] + c
        out.append(s & mask)
        c = s >> w
    return torch.stack(out)


def _reduce_once(wide: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """(L+1)-limb value < 2p -> L limbs < p by one conditional subtract."""
    p_wide = limbs.const(curve.p_wide_limbs(), wide).expand_as(wide)
    d, borrow = limbs.sub_with_borrow(wide, p_wide, curve.log_limb_size)
    return limbs.select(borrow == 0, d, wide)[:curve.num_limbs]


def mont_mul_cios(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
                  ) -> torch.Tensor:
    """(a * b * R^-1) mod p for a, b < p; output fully reduced (< p).
    Textbook CIOS, one limb at a time, as the JAX function."""
    L = curve.num_limbs
    w = curve.log_limb_size
    mask = curve.limb_mask
    p = curve.p_limbs()
    n0 = curve.n0
    a, b = a.to(I64), b.to(I64)
    zero = torch.zeros(torch.broadcast_shapes(a.shape[1:], b.shape[1:]),
                       dtype=I64, device=a.device)
    t = [zero] * (L + 2)
    for i in range(L):
        bi = b[i]
        # multiplication step: t += a * b[i]
        c = zero
        for j in range(L):
            cs = t[j] + a[j] * bi + c
            t[j] = cs & mask
            c = cs >> w
        cs = t[L] + c
        t[L] = cs & mask
        t[L + 1] = cs >> w
        # reduction step: t += m * p, then shift down one limb
        m = (t[0] * n0) & mask
        cs = t[0] + m * p[0]
        c = cs >> w
        for j in range(1, L):
            cs = t[j] + m * p[j] + c
            t[j - 1] = cs & mask
            c = cs >> w
        cs = t[L] + c
        t[L - 1] = cs & mask
        t[L] = t[L + 1] + (cs >> w)
    # t[0..L] < 2p (t[L] in {0, 1}); one conditional subtract gives < p
    return _reduce_once(torch.stack(t[:L + 1]), curve)


def _deferred_step(t, a_pad, bi, p_pad, zero_row, curve: CurveParams):
    """One outer iteration of the deferred-carry loop: t += a b[i], then
    t += p m with m read off t[0] mod 2^w, then shift down one slot,
    folding t[0]'s carry into the new t[0]."""
    w = curve.log_limb_size
    t = t + a_pad * bi[None]
    m = (t[0] * curve.n0) & curve.limb_mask
    t = t + p_pad * m[None]
    c0 = t[0] >> w
    return torch.cat([(t[1] + c0)[None], t[2:], zero_row])


def _deferred_operands(a, b, curve: CurveParams):
    a, b = a.to(I64), b.to(I64)
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((curve.num_limbs,) + shape)
    zero_row = torch.zeros((1,) + shape, dtype=I64, device=a.device)
    a_pad = torch.cat([a, zero_row])                      # (L+1, batch)
    p_pad = limbs.const(curve.p_wide_limbs(), a_pad)
    return a_pad, b, p_pad, zero_row


def mont_mul_deferred(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
                      ) -> torch.Tensor:
    """Deferred-carry Montgomery multiply for limbs of at most 13 bits:
    2 L products of (2^w - 1)^2 accumulate in every slot with no carry
    between them (the headroom of `constants.deferred_carry_headroom`),
    so each outer step is one multiply-add over the whole limb axis; one
    ripple and one conditional subtract at the end."""
    L = curve.num_limbs
    w = curve.log_limb_size
    if w > 13:
        raise ValueError("mont_mul_deferred requires log_limb_size <= 13")
    if deferred_carry_headroom(L, w) <= 1:
        raise ValueError(f"mont_mul_deferred: {curve.name} would overflow "
                         "the uint32 accumulator of the JAX twin")
    a_pad, b, p_pad, zero_row = _deferred_operands(a, b, curve)
    t = torch.zeros_like(a_pad)
    for i in range(L):
        t = _deferred_step(t, a_pad, b[i], p_pad, zero_row, curve)
    # the ripple's final carry is provably 0: value < 2p
    return _reduce_once(_ripple(t, w), curve)


def mont_mul(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
             ) -> torch.Tensor:
    """The deferred-carry multiply for limbs of at most 13 bits, CIOS
    otherwise."""
    if curve.log_limb_size <= 13:
        return mont_mul_deferred(a, b, curve)
    return mont_mul_cios(a, b, curve)


def mont_sqr(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Squaring, as mont_mul(a, a)."""
    return mont_mul(a, a, curve)


def to_mont(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Standard -> Montgomery form: mont_mul(a, R^2) = a R mod p."""
    return mont_mul(a, limbs.const(curve.r2_limbs(), a).expand_as(a), curve)


def from_mont(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Montgomery -> standard form: mont_mul(a, 1) = a R^-1 mod p."""
    one = [1] + [0] * (curve.num_limbs - 1)
    return mont_mul(a, limbs.const(one, a).expand_as(a), curve)


def mont_mul_modified(a: torch.Tensor, b: torch.Tensor, curve: CurveParams
                      ) -> torch.Tensor:
    """The NSAFE carry-deferred multiply for mid-width limbs: carries wait
    over several outer steps and are folded by a full ripple when the
    uint32 headroom of the JAX twin would run out. w = 16 (NSAFE 1) is
    CIOS, w <= 13 the deferred multiply, w in {14, 15} the gated-fold
    loop below."""
    if curve.nsafe <= 1:
        return mont_mul_cios(a, b, curve)
    if curve.log_limb_size <= 13:
        return mont_mul_deferred(a, b, curve)
    L = curve.num_limbs
    w = curve.log_limb_size
    a_pad, b, p_pad, zero_row = _deferred_operands(a, b, curve)
    # safe steps between folds: two w-bit products a slot a step plus the
    # t[0] carry's fold-in, all below 2^32
    max_prod = ((1 << w) - 1) ** 2
    fold_every = max(1, ((1 << 32) - (1 << w))
                     // (2 * max_prod + (1 << (w + 5))))
    t = torch.zeros_like(a_pad)
    for i in range(L):
        t = _deferred_step(t, a_pad, b[i], p_pad, zero_row, curve)
        if (i + 1) % fold_every == 0 and (i + 1) < L:
            # value-preserving; the carry out of the top slot is zero
            t = _ripple(t, w)
    return _reduce_once(_ripple(t, w), curve)
