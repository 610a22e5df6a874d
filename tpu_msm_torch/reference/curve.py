"""Pure-Python big-int oracle for short-Weierstrass curves (y^2 = x^3 + b).

The port's own copy of `tpu_msm/reference/curve.py` (the port imports
nothing of `tpu_msm`): host decode and Horner use `INF`, `add`, `dbl`;
the tests and `chip_smoke.py` use the rest.

This is the trusted CPU reference the whole test pyramid checks against —
the role Arkworks `G::msm` / ark projective arithmetic plays in the
reference's tests (SURVEY.md §4; e.g. mopro-msm tests/cuzk/e2e.rs:14-63).
It intentionally mirrors the *exact same EFD formulas* the device kernels
use (add-2007-bl, dbl-2009-l, madd-2007-bl — reference
shader/curve/jacobian.metal:11-166).

Everything here is python-int exact — no floating point, no limbs.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

from ..constants import CurveParams

# A Jacobian point is a plain (x, y, z) int tuple; z == 0 means infinity.
Jac = Tuple[int, int, int]

INF: Jac = (0, 0, 0)


def is_inf(pt: Jac) -> bool:
    return pt[2] == 0


def neg(curve: CurveParams, pt: Jac) -> Jac:
    """Jacobian negation (x, -y, z). The groups have odd prime order, so
    y == 0 only at infinity."""
    x, y, z = pt
    p = curve.p
    return (x, (p - y) % p, z)


def dbl(curve: CurveParams, pt: Jac) -> Jac:
    """dbl-2009-l. Mirrors jacobian.metal `jacobian_dbl_2009_l` (:11-44)."""
    p = curve.p
    x1, y1, z1 = pt
    if z1 == 0 or y1 == 0:
        return INF
    a = (x1 * x1) % p
    b = (y1 * y1) % p
    c = (b * b) % p
    t = (x1 + b) % p
    d = (2 * ((t * t - a - c) % p)) % p
    e = (3 * a) % p
    f = (e * e) % p
    x3 = (f - 2 * d) % p
    y3 = (e * (d - x3) - 8 * c) % p
    z3 = (2 * y1 * z1) % p
    return (x3, y3, z3)


def add(curve: CurveParams, pt1: Jac, pt2: Jac) -> Jac:
    """add-2007-bl with the zero/equal shortcuts. Mirrors jacobian.metal
    `jacobian_add_2007_bl` (:46-100)."""
    p = curve.p
    x1, y1, z1 = pt1
    x2, y2, z2 = pt2
    if z1 == 0:
        return pt2
    if z2 == 0:
        return pt1
    z1z1 = (z1 * z1) % p
    z2z2 = (z2 * z2) % p
    u1 = (x1 * z2z2) % p
    u2 = (x2 * z1z1) % p
    s1 = (y1 * z2 * z2z2) % p
    s2 = (y2 * z1 * z1z1) % p
    if u1 == u2:
        if s1 == s2:
            return dbl(curve, pt1)
        return INF
    h = (u2 - u1) % p
    i = (4 * h * h) % p
    j = (h * i) % p
    r = (2 * (s2 - s1)) % p
    v = (u1 * i) % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * s1 * j) % p
    z3 = (((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % p * h) % p
    return (x3, y3, z3)


def madd(curve: CurveParams, pt1: Jac, pt2_affine: Tuple[int, int]) -> Jac:
    """madd-2007-bl (mixed add, z2 = 1). Mirrors jacobian.metal
    `jacobian_madd_2007_bl` (:104-166)."""
    p = curve.p
    x1, y1, z1 = pt1
    x2, y2 = pt2_affine
    if z1 == 0:
        return (x2, y2, 1)
    z1z1 = (z1 * z1) % p
    u2 = (x2 * z1z1) % p
    s2 = (y2 * z1 * z1z1) % p
    if x1 == u2:
        if y1 == s2:
            return dbl(curve, pt1)
        return INF
    h = (u2 - x1) % p
    hh = (h * h) % p
    i = (4 * hh) % p
    j = (h * i) % p
    r = (2 * (s2 - y1)) % p
    v = (x1 * i) % p
    x3 = (r * r - j - 2 * v) % p
    y3 = (r * (v - x3) - 2 * y1 * j) % p
    z3 = ((z1 + h) * (z1 + h) - z1z1 - hh) % p
    return (x3, y3, z3)


def scalar_mul(curve: CurveParams, pt: Jac, k: int) -> Jac:
    """Double-and-add. Mirrors jacobian.metal `jacobian_scalar_mul`
    (:168-193) generalized past u32 scalars."""
    acc = INF
    base = pt
    while k:
        if k & 1:
            acc = add(curve, acc, base)
        base = dbl(curve, base)
        k >>= 1
    return acc


def to_affine(curve: CurveParams, pt: Jac) -> Tuple[int, int] | None:
    """Jacobian -> affine; None for infinity."""
    x, y, z = pt
    if z == 0:
        return None
    p = curve.p
    zinv = pow(z, -1, p)
    zinv2 = (zinv * zinv) % p
    return (x * zinv2) % p, (y * zinv2 % p) * zinv % p


def jac_eq(curve: CurveParams, a: Jac, b: Jac) -> bool:
    """Projective (true group-element) equality — unlike the reference's
    limbwise `jacobian_eq` (curve/utils.metal:9-31), which is only equality
    of representatives."""
    return to_affine(curve, a) == to_affine(curve, b)


def on_curve(curve: CurveParams, pt: Jac) -> bool:
    aff = to_affine(curve, pt)
    if aff is None:
        return True
    x, y = aff
    p = curve.p
    return (y * y - (x * x * x + curve.b_coeff)) % p == 0


# ---------------------------------------------------------------------------
# MSM references
# ---------------------------------------------------------------------------


def msm_naive(curve: CurveParams, points: Sequence[Tuple[int, int]],
              scalars: Sequence[int]) -> Jac:
    """Sum_i k_i * P_i by schoolbook double-and-add. Slow, maximally
    trusted."""
    acc = INF
    for (x, y), k in zip(points, scalars):
        acc = add(curve, acc, scalar_mul(curve, (x, y, 1),
                                         k % curve.scalar_modulus))
    return acc


def decompose_signed(curve: CurveParams, scalar: int, window: int,
                     num_windows: int) -> List[int]:
    """Signed (wNAF-style) window decomposition with carry.

    CPU mirror of kernel 1's scalar path
    (shader/cuzk/convert_point_coords_and_decompose_scalars.metal:94-121):
    slice >= 2^(s-1)  =>  digit = slice - 2^s, carry = 1. Returns signed
    digits d_w with  scalar == sum_w d_w * 2^(s*w)  and |d_w| <= 2^(s-1).
    """
    l = 1 << window
    half = l >> 1
    digits = []
    carry = 0
    for w in range(num_windows):
        raw = ((scalar >> (w * window)) & (l - 1)) + carry
        if raw >= half:
            digits.append(raw - l)
            carry = 1
        else:
            digits.append(raw)
            carry = 0
    if carry != 0:
        raise ValueError("signed decomposition overflowed the last window")
    assert sum(d << (w * window) for w, d in enumerate(digits)) == scalar
    return digits


def msm_pippenger_signed(curve: CurveParams, points: Sequence[Tuple[int, int]],
                         scalars: Sequence[int], window: int = 13) -> Jac:
    """Signed-window Pippenger — the exact bucket semantics of the cuZK
    pipeline (decompose -> half-size buckets -> per-window reduction ->
    Horner by 2^s; metal_msm.rs:204-261 + smvp.metal:46-105), as a fast-ish
    CPU oracle for mid-size tests."""
    num_windows = -(-curve.scalar_bits // window)
    half = 1 << (window - 1)
    window_sums: List[Jac] = []
    digit_rows = [decompose_signed(curve, k % curve.scalar_modulus, window,
                                   num_windows) for k in scalars]
    for w in range(num_windows):
        buckets: List[Jac] = [INF] * half  # bucket i holds multiplier i+1
        for (pt, row) in zip(points, digit_rows):
            d = row[w]
            if d == 0:
                continue
            if d > 0:
                buckets[d - 1] = madd(curve, buckets[d - 1], pt)
            else:
                x, y = pt
                buckets[-d - 1] = madd(curve, buckets[-d - 1],
                                       (x, (curve.p - y) % curve.p))
        # running-sum reduction: sum_b (b+1) * buckets[b]
        m: Jac = INF
        g: Jac = INF
        for b in range(half - 1, -1, -1):
            m = add(curve, m, buckets[b])
            g = add(curve, g, m)
        window_sums.append(g)
    acc: Jac = INF
    for g in reversed(window_sums):
        for _ in range(window):
            acc = dbl(curve, acc)
        acc = add(curve, acc, g)
    return acc


# ---------------------------------------------------------------------------
# Test-vector generation (analogue of msm/utils/preprocess.rs gen_vectors)
# ---------------------------------------------------------------------------


def gen_points_scalars(curve: CurveParams, n: int, seed: int = 0
                       ) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Deterministic random affine points + scalars.

    Points are built as (small random multiples of G) combined pairwise so
    generating n points costs ~64 full scalar-muls + n adds instead of n
    scalar-muls (the reference generates via ark rand + mul, e2e tests use
    ark_std::test_rng — metal_msm.rs:698-731)."""
    rng = random.Random(seed)
    base_count = min(64, max(1, n))
    bases: List[Jac] = []
    g = (curve.gen_x, curve.gen_y, 1)
    for _ in range(base_count):
        k = rng.randrange(1, curve.scalar_modulus)
        bases.append(scalar_mul(curve, g, k))
    points: List[Tuple[int, int]] = []
    cur = bases[0]
    i = 0
    while len(points) < n:
        cur = add(curve, cur, bases[i % base_count])
        aff = to_affine(curve, cur)
        assert aff is not None
        points.append(aff)
        i += 1
    scalars = [rng.randrange(0, curve.scalar_modulus) for _ in range(n)]
    return points, scalars
