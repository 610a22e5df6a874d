"""GLV endomorphism scalar decomposition: parameter derivation and oracle.

The port's own copy of `tpu_msm/glv.py` (host-only, python ints; the port
imports nothing of `tpu_msm`). BN254 has j-invariant 0, so it has the
endomorphism phi(x, y) = (beta*x, y) with phi(P) = lambda*P on G1, where
beta^3 = 1 in Fp and lambda^3 = 1 mod r. Splitting each scalar
k = k1 + lambda*k2 with |k1|, |k2| ~ sqrt(r) turns an n-point 254-bit
MSM into a 2n-point ~128-bit MSM:

    sum_i k_i P_i  =  sum_i k1_i P_i  +  sum_i k2_i phi(P_i)

which halves the window count, and with it every per-window stage, at
the cost of doubling the point stream. Gated by `MSMConfig.glv`.

  * `derive(curve)`: all GLV constants from first principles:
      - lambda, beta: roots of x^2+x+1 mod r / mod p (Tonelli-Shanks
        sqrt of -3), paired by checking phi(G) == lambda*G on the curve
        with the python reference;
      - a short basis of the lattice {(x, y) : x + y*lambda = 0 mod r}
        from the extended-Euclid remainder sequence (consecutive
        remainders around sqrt(r));
      - fixed-point Babai-rounding multipliers g1, g2 = round(2^m*|b|/r),
        so the device decomposes with two bignum mul-shifts instead of a
        254-bit division.
  * `GLVParams.decompose(k)`: the oracle, bit-exactly the arithmetic the
    device performs (`cuzk/glv.py`) on python ints, with the proven bound
    |k1|, |k2| <= max_abs.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

from .constants import CurveParams

# fixed-point shift of the Babai rounding multipliers. A multiple of 16,
# so the device-side ">> M_SHIFT" is a halfword-limb slice; large enough
# (m >= r.bit_length() + 18) that the fixed-point error in c_i is < 2^-10
# and the rounding error bound |c_i - k*b/r| <= 1 holds with huge margin.
M_SHIFT = 272


def _sqrt_mod(a: int, p: int) -> int:
    """Tonelli-Shanks square root mod an odd prime; raises if a is a
    non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        raise ValueError("not a quadratic residue")
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # write p-1 = q * 2^s with q odd
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def _cube_roots_of_unity(m: int) -> Tuple[int, int]:
    """The two nontrivial cube roots of 1 mod m (roots of x^2 + x + 1):
    (-1 +/- sqrt(-3)) / 2. Requires m = 1 mod 3."""
    if m % 3 != 1:
        raise ValueError("no nontrivial cube roots of unity")
    s = _sqrt_mod(m - 3, m)
    inv2 = pow(2, -1, m)
    r1 = (s - 1) * inv2 % m
    r2 = (-s - 1) * inv2 % m
    assert (r1 * r1 + r1 + 1) % m == 0 and (r2 * r2 + r2 + 1) % m == 0
    return r1, r2


@dataclasses.dataclass(frozen=True)
class GLVParams:
    """Derived GLV constants for one curve (see `derive`).

    Basis (a1, b1), (a2, b2) of the lattice {(x,y): x + y*lam = 0 mod r},
    sign-normalized so det = a1*b2 - a2*b1 = +r, b1 <= 0 and b2 >= 0 —
    which makes both Babai multipliers g1 = round(2^m * b2 / r) and
    g2 = round(2^m * (-b1) / r) non-negative, so the device decomposition
    needs only unsigned bignum products (cuzk/glv.py)."""

    curve: CurveParams
    lam: int            # lambda: phi(P) = lam * P, lam^3 = 1 mod r
    beta: int           # phi(x, y) = (beta * x, y), beta^3 = 1 in Fp
    a1: int
    b1: int
    a2: int
    b2: int
    g1: int             # round(2^M_SHIFT * b2 / r)   (>= 0)
    g2: int             # round(2^M_SHIFT * -b1 / r)  (>= 0)
    max_abs: int        # proven bound: |k1|, |k2| <= max_abs

    @property
    def max_bits(self) -> int:
        """Bit width of the decomposed scalar magnitudes."""
        return self.max_abs.bit_length()

    def decompose(self, k: int) -> Tuple[int, int]:
        """k in [0, r) -> (k1, k2) signed ints with k1 + k2*lam = k mod r
        and |k_i| <= max_abs. Bit-exactly the device arithmetic
        (cuzk/glv.py split_scalars): two mul-shift roundings, two lattice
        combinations."""
        half = 1 << (M_SHIFT - 1)
        c1 = (k * self.g1 + half) >> M_SHIFT
        c2 = (k * self.g2 + half) >> M_SHIFT
        k1 = k - c1 * self.a1 - c2 * self.a2
        k2 = -c1 * self.b1 - c2 * self.b2
        return k1, k2

    def split_signed(self, k: int) -> Tuple[bool, int, bool, int]:
        """decompose + sign/magnitude form (what the device hands the
        window decomposition): (neg1, |k1|, neg2, |k2|)."""
        k1, k2 = self.decompose(k)
        return k1 < 0, abs(k1), k2 < 0, abs(k2)


@functools.lru_cache(maxsize=None)
def derive(curve: CurveParams) -> GLVParams:
    """Derive all GLV constants for a j-invariant-0 short-Weierstrass
    curve from first principles (no magic numbers)."""
    from .reference import curve as ref

    r = curve.scalar_modulus
    p = curve.p

    # --- lambda / beta pairing: phi(G) must equal lambda * G ---
    lams = _cube_roots_of_unity(r)
    betas = _cube_roots_of_unity(p)
    gen = (curve.gen_x, curve.gen_y, 1)
    lam = beta = None
    for lm in lams:
        target = ref.scalar_mul(curve, gen, lm)
        for bt in betas:
            cand = (bt * curve.gen_x % p, curve.gen_y, 1)
            if ref.jac_eq(curve, target, cand):
                lam, beta = lm, bt
                break
        if lam is not None:
            break
    if lam is None:
        raise ValueError(f"no (lambda, beta) pairing found for {curve.name}")

    # --- short basis from the extended-Euclid remainder sequence
    # (GLV'01 Lemma): s_i*r + t_i*lam = r_i  =>  (r_i, -t_i) is in the
    # lattice. Take the remainders straddling sqrt(r). ---
    rs = [r, lam]
    ts = [0, 1]
    while rs[-1] != 0:
        q = rs[-2] // rs[-1]
        rs.append(rs[-2] - q * rs[-1])
        ts.append(ts[-2] - q * ts[-1])
    sq = math.isqrt(r)
    l = max(i for i in range(len(rs) - 1) if rs[i] >= sq + 1)
    v1 = (rs[l + 1], -ts[l + 1])
    cand_a = (rs[l], -ts[l])
    cand_b = (rs[l + 2], -ts[l + 2]) if l + 2 < len(rs) else None
    norm = lambda v: v[0] * v[0] + v[1] * v[1]
    v2 = cand_a if (cand_b is None or norm(cand_a) <= norm(cand_b)) else cand_b
    for (a, b) in (v1, v2):
        assert (a + b * lam) % r == 0

    # --- sign normalization: det = +r, b1 <= 0, b2 >= 0 (see GLVParams).
    # The transform group {swap, negate-one, negate-both} always contains
    # a member achieving this. ---
    chosen = None
    for w1, w2 in ((v1, v2), (v2, v1)):
        for s1 in (1, -1):
            for s2 in (1, -1):
                a1, b1 = s1 * w1[0], s1 * w1[1]
                a2, b2 = s2 * w2[0], s2 * w2[1]
                if a1 * b2 - a2 * b1 == r and b1 <= 0 and b2 >= 0:
                    chosen = (a1, b1, a2, b2)
                    break
            if chosen:
                break
        if chosen:
            break
    assert chosen is not None, "no sign arrangement with det=+r found"
    a1, b1, a2, b2 = chosen

    g1 = (2 ** M_SHIFT * b2 + r // 2) // r
    g2 = (2 ** M_SHIFT * (-b1) + r // 2) // r

    # --- bound: with exact Babai rounding |c_i - k*q_i| <= 1/2; the
    # fixed-point mul-shift adds < 2^-10 (M_SHIFT >= bits(r) + 18), so
    # |c_i - t_i| <= 1 conservatively and
    # |k1| <= |a1| + |a2|, |k2| <= |b1| + |b2|. ---
    assert M_SHIFT >= r.bit_length() + 18
    max_abs = max(abs(a1) + abs(a2), abs(b1) + abs(b2))

    params = GLVParams(curve=curve, lam=lam, beta=beta,
                       a1=a1, b1=b1, a2=a2, b2=b2,
                       g1=g1, g2=g2, max_abs=max_abs)

    # self-check on a few deterministic scalars
    for k in (0, 1, 2, r - 1, r // 3, (r * 2) // 3, 0x1234567890ABCDEF):
        k1, k2 = params.decompose(k % r)
        assert (k1 + k2 * lam - k) % r == 0
        assert abs(k1) <= max_abs and abs(k2) <= max_abs
    return params
