"""Host helpers between the oracle's int points and planar Montgomery
limb arrays: the port of `tpu_msm/utils/testing.py`, for the tests of
the unsigned point layer (`ops/curve.py`)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..constants import CurveParams
from .limbs_conversion import ints_to_planar, planar_to_ints

JacInt = Tuple[int, int, int]


def jac_to_planar_mont(pts: Sequence[JacInt], curve: CurveParams
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Oracle Jacobian int tuples -> three (L, n) Montgomery planar arrays.
    Canonical infinity (z == 0) maps to all-zero coordinates."""
    L, w = curve.num_limbs, curve.log_limb_size
    xs = ints_to_planar([curve.to_mont(p[0]) if p[2] != 0 else 0
                         for p in pts], L, w)
    ys = ints_to_planar([curve.to_mont(p[1]) if p[2] != 0 else 0
                         for p in pts], L, w)
    zs = ints_to_planar([curve.to_mont(p[2]) for p in pts], L, w)
    return xs, ys, zs


def planar_mont_to_jac(x, y, z, curve: CurveParams) -> List[JacInt]:
    """Inverse of jac_to_planar_mont (Montgomery decode on the host);
    takes numpy arrays or CPU tensors."""
    w = curve.log_limb_size
    xi, yi, zi = (planar_to_ints(np.asarray(a), w) for a in (x, y, z))
    return [(curve.from_mont(a), curve.from_mont(b), curve.from_mont(c))
            for a, b, c in zip(xi, yi, zi)]


def affine_to_planar_mont(pts: Sequence[Tuple[int, int]], curve: CurveParams
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Affine int pairs -> two (L, n) Montgomery planar arrays."""
    L, w = curve.num_limbs, curve.log_limb_size
    xs = ints_to_planar([curve.to_mont(p[0]) for p in pts], L, w)
    ys = ints_to_planar([curve.to_mont(p[1]) for p in pts], L, w)
    return xs, ys
