"""Curve and limb-layout constants for the PyTorch/CUDA port.

A standalone copy of the part of `tpu_msm/constants.py` this package
needs (the port imports nothing of `tpu_msm`): the `CurveParams` bundle,
the limb helpers, the Montgomery, NSAFE and Barrett parameters of the
unsigned layers (`ops/field.py`, `ops/mont.py`, `ops/barrett.py`), the
headroom of their deferred-carry multiply, the signed fold interval of
the deferred-carry Montgomery loop, and the profiles of BN254 (BN254,
BN254_S12, BN254_S13, BN254_F13), of BLS12-377 (BLS12_377,
BLS12_377_S12, BLS12_377_S13, BLS12_377_F12) and TINY62.
Every derived quantity (R mod p, R^2, n0, k*p limbs) is computed here
from first principles; the CUDA kernels receive them as a device tensor
built by `cuzk/kernels.py`, never as literals in the sources.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple


def int_to_limbs(x: int, num_limbs: int, log_limb_size: int) -> List[int]:
    """Little-endian fixed-width limb decomposition of a non-negative int."""
    if x < 0:
        raise ValueError("int_to_limbs requires a non-negative integer")
    mask = (1 << log_limb_size) - 1
    out = []
    for _ in range(num_limbs):
        out.append(x & mask)
        x >>= log_limb_size
    if x != 0:
        raise ValueError("value does not fit in the requested limb layout")
    return out


def limbs_to_int(limbs, log_limb_size: int) -> int:
    acc = 0
    for i, l in enumerate(limbs):
        acc |= int(l) << (i * log_limb_size)
    return acc


def calc_rinv_and_n0(p: int, num_limbs: int, log_limb_size: int
                     ) -> Tuple[int, int]:
    """Montgomery parameters: rinv = R^-1 mod p, n0 = -p^-1 mod 2^w."""
    r = 1 << (num_limbs * log_limb_size)
    rinv = pow(r % p, -1, p)
    n0 = (-pow(p, -1, 1 << log_limb_size)) % (1 << log_limb_size)
    return rinv, n0


def calc_nsafe(log_limb_size: int) -> int:
    """How many unreduced limb-product terms fit a uint32 accumulator,
    halved (at least 1): 1 for w = 16, where every product is reduced at
    once (CIOS), more for the narrower limbs of `ops/mont.py`
    mont_mul_modified."""
    rhs = 1 << 32
    max_term = ((1 << log_limb_size) - 1) ** 2
    n = 0
    acc = 0
    while acc + max_term < rhs:
        acc += max_term
        n += 1
    return max(n // 2, 1)


def calc_barrett_mu(p: int, num_limbs: int, log_limb_size: int) -> int:
    """mu = floor(b^(2k) / p) with b = 2^w, k = num_limbs."""
    return (1 << (2 * num_limbs * log_limb_size)) // p


def deferred_carry_headroom(num_limbs: int, log_limb_size: int) -> float:
    """2^32 over the worst accumulation of the unsigned deferred-carry
    Montgomery multiply (`ops/mont.py` mont_mul_deferred): 2 products a
    limb an iteration for num_limbs iterations, plus the fold-ins of the
    t[0] carry. Above 1, no uint32 slot of that multiply can wrap."""
    max_prod = ((1 << log_limb_size) - 1) ** 2
    worst = 2 * num_limbs * max_prod
    worst += num_limbs * (worst >> log_limb_size)
    return (1 << 32) / worst


def signed_fold_interval(log_limb_size: int) -> int:
    """Safe iteration count between carry folds in the signed
    deferred-carry Montgomery loop (ops/rows.py mont_mul_rows).

    Each iteration adds two products of canonical w-bit limbs to an int32
    slot plus carry fold-ins bounded by 2^(w+6); K iterations between
    folds are safe when K * (2*(2^w-1)^2 + 2^(w+6)) < 2^31. w=12 gives 63
    (no fold at any registered L), w=13 gives 15 (one mid-loop fold)."""
    w = log_limb_size
    per_iter = 2 * ((1 << w) - 1) ** 2 + (1 << (w + 6))
    return max(1, ((1 << 31) - (1 << (w + 2))) // per_iter)


@dataclasses.dataclass(frozen=True)
class CurveParams:
    """One short-Weierstrass curve y^2 = x^3 + b with its limb layout."""

    name: str
    p: int                 # base-field modulus
    scalar_modulus: int    # group order (Fr modulus)
    b_coeff: int           # curve constant b
    gen_x: int
    gen_y: int
    num_limbs: int = 16
    log_limb_size: int = 16
    # A signed-lazy profile (ops/rows.py, csrc/field.cuh), the only kind
    # the port computes on; the 16-bit base profiles and the JAX
    # package's F profiles (its deferred-carry multiply) are data only.
    signed: bool = False

    def require_signed(self, who: str) -> None:
        """Raise unless the port's signed-lazy arithmetic holds this
        profile: a signed profile whose limbs have at most 13 bits (int16
        storage of the limb range (-2^w, 2^(w+1))) and whose radix has at
        least 7 bits of slack above p (every transient of the complete
        formulas, operands up to 54 p, must fit; the JAX package asserts
        the same floor for its signed profiles)."""
        slack = self.num_limbs * self.log_limb_size - self.p.bit_length()
        if not self.signed or self.log_limb_size > 13 or slack < 7:
            raise ValueError(
                f"{who}: {self.name} (L={self.num_limbs}, "
                f"w={self.log_limb_size}, {slack} bits of slack) is no "
                "signed profile with w <= 13 and slack >= 7")

    @functools.cached_property
    def limb_mask(self) -> int:
        return (1 << self.log_limb_size) - 1

    @functools.cached_property
    def mont_radix(self) -> int:
        return 1 << (self.num_limbs * self.log_limb_size)

    @functools.cached_property
    def r_mod_p(self) -> int:
        return self.mont_radix % self.p

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return (self.r_mod_p * self.r_mod_p) % self.p

    @functools.cached_property
    def rinv(self) -> int:
        return pow(self.mont_radix % self.p, -1, self.p)

    @functools.cached_property
    def n0(self) -> int:
        """-p^-1 mod 2^w."""
        return calc_rinv_and_n0(self.p, self.num_limbs,
                                self.log_limb_size)[1]

    @functools.cached_property
    def nsafe(self) -> int:
        return calc_nsafe(self.log_limb_size)

    @functools.cached_property
    def barrett_mu(self) -> int:
        return calc_barrett_mu(self.p, self.num_limbs, self.log_limb_size)

    @functools.cached_property
    def scalar_bits(self) -> int:
        return self.scalar_modulus.bit_length()

    @functools.cached_property
    def scalar_limbs_u32(self) -> int:
        return (self.scalar_bits + 31) // 32

    def p_limbs(self) -> List[int]:
        return int_to_limbs(self.p, self.num_limbs, self.log_limb_size)

    def p_wide_limbs(self) -> List[int]:
        return int_to_limbs(self.p, self.num_limbs + 1, self.log_limb_size)

    def mu_limbs(self) -> List[int]:
        return int_to_limbs(self.barrett_mu, self.num_limbs + 1,
                            self.log_limb_size)

    def r_limbs(self) -> List[int]:
        return int_to_limbs(self.r_mod_p, self.num_limbs, self.log_limb_size)

    def r2_limbs(self) -> List[int]:
        return int_to_limbs(self.r2_mod_p, self.num_limbs, self.log_limb_size)

    def to_mont(self, x: int) -> int:
        return (x * self.mont_radix) % self.p

    def from_mont(self, x: int) -> int:
        return (x * self.rinv) % self.p


# BN254 (alt_bn128) G1.
BN254 = CurveParams(
    name="bn254",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    scalar_modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    b_coeff=3,
    gen_x=1,
    gen_y=2,
    num_limbs=16,
    log_limb_size=16,
)

# Signed-lazy production profile: 22 limbs of 12 bits in int32.
BN254_S12 = dataclasses.replace(BN254, name="bn254_s12", num_limbs=22,
                                log_limb_size=12, signed=True)

# 13-bit signed profile: one value-preserving mid-loop carry fold in the
# Montgomery multiply (signed_fold_interval(13) == 15 < L = 21).
BN254_S13 = dataclasses.replace(BN254, name="bn254_s13", num_limbs=21,
                                log_limb_size=13, signed=True)

# The F profiles (the JAX package's deferred-carry multiply of
# ops/mont.py) are data only: `require_signed` refuses them, as it does
# the base profiles (BN254_F13 also has 6 bits of slack, under the floor).
BN254_F13 = dataclasses.replace(BN254, name="bn254_f13", num_limbs=20,
                                log_limb_size=13)

# BLS12-377 G1 (the curve of Aleo's snarkVM and of the ZPrize 2022 MSM
# track): y^2 = x^3 + 1 over a 377-bit field, 253-bit group order.
BLS12_377 = CurveParams(
    name="bls12_377",
    p=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    scalar_modulus=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    b_coeff=1,
    gen_x=0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    gen_y=0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    num_limbs=24,
    log_limb_size=16,
)

# Signed-lazy BLS12-377 profiles: 32 limbs of 12 bits (L w = 384, a
# multiple of 32: the word-wide multiply's last partial step vanishes),
# and 30 limbs of 13 bits (390 bits, one mid-loop fold as BN254_S13).
BLS12_377_S12 = dataclasses.replace(BLS12_377, name="bls12_377_s12",
                                    num_limbs=32, log_limb_size=12,
                                    signed=True)
BLS12_377_S13 = dataclasses.replace(BLS12_377, name="bls12_377_s13",
                                    num_limbs=30, log_limb_size=13,
                                    signed=True)
BLS12_377_F12 = dataclasses.replace(BLS12_377, name="bls12_377_f12",
                                    num_limbs=32, log_limb_size=12)

# Tiny 62-bit test curve (not cryptographic): y^2 = x^3 + 3, generator
# (1, 2), exact group order as scalar_modulus. Same code paths as BN254
# at L = 6 limbs, which keeps the CPU tests cheap.
TINY62 = CurveParams(
    name="tiny62",
    p=4611686018427387847,
    scalar_modulus=4611686020669838404,
    b_coeff=3,
    gen_x=1,
    gen_y=2,
    num_limbs=6,
    log_limb_size=12,
    signed=True,
)

CURVES = {c.name: c for c in (BN254, BN254_S12, BN254_S13, BN254_F13,
                               BLS12_377, BLS12_377_S12, BLS12_377_S13,
                               BLS12_377_F12, TINY62)}
