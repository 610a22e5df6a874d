"""Benchmark vector generation and the O(k_base) linearity check.

The port's own copy of `tpu_msm/utils/preprocess.py`: the generator, the
on-curve check of planar points, and the vector files (`vectors/`
beside the package; the same names and keys as the JAX package's, so
either package reads the other's files). Generating n independent
random points costs n oracle scalar-muls, so k_base true random points
are tiled to n with fresh random scalars; the MSM result is then
verifiable in O(k_base) oracle work by linearity:

    sum_i k_i * P_{i mod K} == sum_j (sum_{i = j mod K} k_i) * P_j
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from ..constants import CurveParams
from ..reference import curve as ref
from .limbs_conversion import points_to_planar

VECTOR_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "vectors")


def gen_base_points(curve: CurveParams, k: int, seed: int
                    ) -> List[Tuple[int, int]]:
    """k genuinely random affine points (oracle scalar-muls of G)."""
    rng = random.Random(seed)
    g = (curve.gen_x, curve.gen_y, 1)
    out = []
    for _ in range(k):
        p = ref.scalar_mul(curve, g, rng.randrange(1, curve.scalar_modulus))
        out.append(ref.to_affine(curve, p))
    return out


def gen_scalar_halfwords(curve: CurveParams, n: int, seed: int) -> np.ndarray:
    """(H, n) uint32 halfwords of uniform scalars < 2^(scalar_bits-1)."""
    rng = np.random.default_rng(seed)
    n_half = curve.scalar_limbs_u32 * 2
    hw = rng.integers(0, 1 << 16, size=(n_half, n), dtype=np.uint32)
    top_bits = (curve.scalar_bits - 1) - 16 * (n_half - 1)
    if top_bits <= 0:
        hw[n_half - 1] = 0
    else:
        hw[n_half - 1] &= (1 << top_bits) - 1
    return hw


def halfwords_to_ints(hw: np.ndarray) -> List[int]:
    """(H, n) 16-bit halfwords -> n python ints (little-endian)."""
    raw = np.ascontiguousarray(np.asarray(hw).T.astype("<u2")).tobytes()
    step = 2 * hw.shape[0]
    return [int.from_bytes(raw[i:i + step], "little")
            for i in range(0, len(raw), step)]


def gen_planar_inputs(curve: CurveParams, n: int, seed: int = 0,
                      k_base: int = 64):
    """Planar benchmark inputs: (xs, ys, halfwords, base_points). Points
    are the k_base random points tiled to n; scalars are fresh randoms."""
    k_base = min(k_base, n)
    base = gen_base_points(curve, k_base, seed)
    bx, by = points_to_planar(base, curve)
    reps = -(-n // k_base)
    xs = np.tile(bx, (1, reps))[:, :n].copy()
    ys = np.tile(by, (1, reps))[:, :n].copy()
    hw = gen_scalar_halfwords(curve, n, seed + 1)
    return xs, ys, hw, base


def aggregate_scalars(hw: np.ndarray, k_base: int, curve: CurveParams
                      ) -> List[int]:
    """Per-base aggregated scalars (mod r) for the linearity check:
    sum_{i = j mod k_base} k_i for each base j. Each 16-bit halfword row
    is summed per base in int64 (n / k_base values below 2^16 a sum), then
    one carry of the (H, k_base) column sums into an int a base."""
    hw = np.asarray(hw)
    H, n = hw.shape
    pad = (-n) % k_base
    sums = np.empty((H, k_base), dtype=np.int64)
    for h in range(H):
        row = hw[h].astype(np.int64) & 0xFFFF
        if pad:
            row = np.concatenate([row, np.zeros(pad, np.int64)])
        sums[h] = row.reshape(-1, k_base).sum(axis=0)
    r = curve.scalar_modulus
    return [sum(int(sums[h, j]) << (16 * h) for h in range(H)) % r
            for j in range(k_base)]


def expected_msm(base, hw, curve: CurveParams):
    """Oracle result of the tiled MSM in O(k_base) point work."""
    agg = aggregate_scalars(hw, len(base), curve)
    return ref.msm_pippenger_signed(curve, base, agg, window=8)


def validate_planar_points(xs: np.ndarray, ys: np.ndarray,
                           curve: CurveParams) -> None:
    """On-curve and in-field check of planar (L, n) coordinate arrays.
    Costs one bigint check a distinct point: columns are deduplicated
    first (in chunks of 2^20), so tiled vectors of k_base distinct points
    cost k_base checks. Raises ValueError naming the first offending
    point index."""
    w = curve.log_limb_size
    n = xs.shape[1]
    both = np.concatenate([xs, ys], axis=0).astype(np.int32, copy=False)
    p, b = curve.p, curve.b_coeff
    seen: set = set()
    CH = 1 << 20
    for lo in range(0, n, CH):
        cols = np.ascontiguousarray(both[:, lo:lo + CH].T)   # (ch, 2L)
        rec = cols.view(np.dtype((np.void, cols.shape[1] * 4))).ravel()
        _, uidx = np.unique(rec, return_index=True)
        for j in sorted(int(u) for u in uidx):
            key = rec[j].tobytes()
            if key in seen:
                continue
            seen.add(key)
            i = lo + j
            x = sum(int(v) << (w * k) for k, v in enumerate(xs[:, i]))
            y = sum(int(v) << (w * k) for k, v in enumerate(ys[:, i]))
            if not (0 <= x < p and 0 <= y < p):
                raise ValueError(
                    f"point {i}: coordinate out of field range (x={x:#x})")
            if (y * y - (x * x * x + b)) % p != 0:
                raise ValueError(f"point {i}: not on curve {curve.name} "
                                 f"(y^2 != x^3 + b mod p)")


# ---- persisted vectors ----


def vector_path(curve: CurveParams, n: int, seed: int) -> str:
    return os.path.join(VECTOR_DIR, f"{curve.name}_{n}x{seed}.npz")


def save_vectors(path: str, xs, ys, hw) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, xs=xs, ys=ys, hw=hw)


def load_or_gen_vectors(curve: CurveParams, n: int, seed: int = 0,
                        k_base: int = 64, check: bool = True):
    """File-backed vectors: generated once, then read back from
    `vector_path`. Returns (xs, ys, hw, base points). A file's points
    are checked on the curve (`validate_planar_points`) unless
    `check=False`, for trusted re-reads; freshly generated vectors are
    trusted by construction."""
    path = vector_path(curve, n, seed)
    base = gen_base_points(curve, min(k_base, n), seed)
    if os.path.exists(path):
        with np.load(path) as d:
            xs, ys, hw = d["xs"], d["ys"], d["hw"]
        if check:
            validate_planar_points(xs, ys, curve)
        return xs, ys, hw, base
    xs, ys, hw, base = gen_planar_inputs(curve, n, seed, k_base)
    save_vectors(path, xs, ys, hw)
    return xs, ys, hw, base
