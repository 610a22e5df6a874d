"""The plain reference: exact MSMs over a short-Weierstrass curve
y^2 = x^3 + b in Python integers and NumPy.

Independent of the program: its own curve constants (from the
configuration file), affine formulas with an inversion an add, where
the program computes in Jacobian coordinates on limbs. It imports
nothing but the standard library and NumPy.

A cell's bases are K distinct points tiled to n (point i is base i mod
K, the last tile cut short), so by linearity

    sum_i k_i P_(i mod K) = sum_j (sum_(i = j mod K) k_i mod r) P_j,

and the reference works the expected MSM of n scalars out as a K-point
MSM of the aggregated scalars.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

Affine = Optional[Tuple[int, int]]   # None is the point at infinity


@dataclasses.dataclass(frozen=True)
class Curve:
    """y^2 = x^3 + b over F_p, with a generator of order r."""

    p: int
    r: int
    b: int
    gen: Tuple[int, int]

    @classmethod
    def from_config(cls, cfg: dict) -> "Curve":
        c = cfg["curve"]
        return cls(p=int(c["p"], 0), r=int(c["r"], 0), b=int(c["b"], 0),
                   gen=(int(c["gen_x"], 0), int(c["gen_y"], 0)))

    def on_curve(self, pt: Affine) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.b) % self.p == 0

    def neg(self, pt: Affine) -> Affine:
        return None if pt is None else (pt[0], (-pt[1]) % self.p)

    def add(self, a: Affine, b: Affine) -> Affine:
        if a is None:
            return b
        if b is None:
            return a
        p = self.p
        (x1, y1), (x2, y2) = a, b
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return x3, (lam * (x1 - x3) - y1) % p

    def mul(self, pt: Affine, k: int) -> Affine:
        """k pt by double-and-add, k taken mod r."""
        acc, k = None, k % self.r
        for bit in bin(k)[2:] if k else "":
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, pt)
        return acc

    def msm(self, points: Sequence[Affine], scalars: Sequence[int]) -> Affine:
        """sum_j k_j P_j: the scalars' bits walked from the top at once,
        one doubling a bit for all points."""
        ks = [k % self.r for k in scalars]
        acc = None
        for bit in range(max(ks, default=0).bit_length() - 1, -1, -1):
            acc = self.add(acc, acc)
            for pt, k in zip(points, ks):
                if k >> bit & 1:
                    acc = self.add(acc, pt)
        return acc

    def from_jacobian(self, x: int, y: int, z: int) -> Affine:
        """(x / z^2, y / z^3), or None where z = 0 mod p."""
        p = self.p
        if z % p == 0:
            return None
        zi = pow(z, -1, p)
        zi2 = zi * zi % p
        return x * zi2 % p, y * zi2 * zi % p


def aggregate(halfwords: np.ndarray, k_base: int, r: int,
              dropped_bits: int = 0) -> List[int]:
    """The aggregated scalars sum_(i = j mod K) k_i mod r of (H, n)
    16-bit scalar halfwords, little-endian rows. With `dropped_bits`,
    each scalar's lowest bits are cleared first (a scalar of that many
    bits less precision: the control's)."""
    H, n = halfwords.shape
    pad = -n % k_base
    if not 0 <= dropped_bits < 16:
        raise ValueError("dropped_bits must lie in [0, 16)")
    sums = np.zeros((H, k_base), dtype=np.int64)
    for h in range(H):
        row = halfwords[h]
        if h == 0 and dropped_bits:
            row = row & np.uint16(0xFFFF ^ ((1 << dropped_bits) - 1))
        # the last tile padded with zeros; at most 2^24 / K + 1 values
        # below 2^16 a sum: no int64 overflow
        sums[h] = np.pad(row, (0, pad)).reshape(-1, k_base).sum(
            axis=0, dtype=np.int64)
    return [sum(int(sums[h, j]) << (16 * h) for h in range(H)) % r
            for j in range(k_base)]


def expected_msm(curve: Curve, bases: Sequence[Affine],
                 halfwords: np.ndarray, dropped_bits: int = 0) -> Affine:
    """The MSM of the bases tiled to n and the (H, n) scalar halfwords."""
    agg = aggregate(halfwords, len(bases), curve.r, dropped_bits)
    return curve.msm(bases, agg)
