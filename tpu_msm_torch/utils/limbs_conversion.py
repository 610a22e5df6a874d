"""Host-side packing between python ints and planar limb arrays (numpy).

The port's own copy of `tpu_msm/utils/limbs_conversion.py`.

Analogue of mopro-msm/src/msm/metal_msm/utils/limbs_conversion.rs:
`GenericLimbConversion` (:36-307) and `pack_affine_and_scalars` (:311-378).
The reference packs two 16-bit limbs per u32 word for the Metal buffers and
unpacks on-device; our device layout is directly planar (num_limbs, n)
uint32 with 16-bit values, so packing is a bytes -> u16 -> u32 view, done
with numpy bulk ops instead of rayon-chunked loops.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..constants import CurveParams


def ints_to_planar(values: Sequence[int], num_limbs: int,
                   log_limb_size: int = 16) -> np.ndarray:
    """Pack python ints -> (num_limbs, n) uint32 planar limb array (LE).

    Bulk path: serialize to little-endian bytes once, view as u16
    halfwords, then (for non-16-bit profiles) extract w-bit windows with
    vectorized shifts — the same window-extraction arithmetic the device
    uses for scalars (cuzk/decompose.py extract_windows)."""
    w = log_limb_size
    total_bits = num_limbs * w
    n_half = (total_bits + 15) // 16 + 1
    buf = b"".join(int(v).to_bytes(n_half * 2, "little") for v in values)
    hw = np.frombuffer(buf, dtype="<u2").reshape(len(values), n_half)
    hw = hw.astype(np.uint32)
    if w == 16:
        return np.ascontiguousarray(hw[:, :num_limbs].T)
    mask = np.uint32((1 << w) - 1)
    out = np.empty((num_limbs, len(values)), np.uint32)
    for k in range(num_limbs):
        bit = k * w
        i, off = bit >> 4, bit & 15
        val = hw[:, i] >> off
        if off:  # 16 - off < 16, high halfword contributes
            val = val | (hw[:, i + 1] << (16 - off))
        out[k] = val & mask
    return out


def planar_to_ints(arr: np.ndarray, log_limb_size: int = 16) -> List[int]:
    """Inverse of ints_to_planar: (num_limbs, n) limbs -> python ints."""
    arr = np.asarray(arr)
    out = []
    for col in arr.T:
        acc = 0
        for i in range(arr.shape[0] - 1, -1, -1):
            acc = (acc << log_limb_size) | int(col[i])
        out.append(acc)
    return out


def planar_signed_to_ints_modp(arr: np.ndarray, curve: CurveParams) -> List[int]:
    """Signed lazy limbs (ops/lazy.py) -> canonical field ints.

    The lazy pipeline's outputs carry relaxed representations (values in
    [0, 4p), limbs possibly negative); the exact integer is the signed
    limb-weighted sum, reduced mod p on the host — the role
    mont_reduction.rs raw_reduction plays for the reference's readbacks."""
    arr = np.asarray(arr)
    w = curve.log_limb_size
    out = []
    for col in arr.T:
        acc = 0
        for j in range(arr.shape[0] - 1, -1, -1):
            acc = (acc << w) + int(col[j])
        out.append((acc * curve.rinv) % curve.p)  # also Montgomery-decode
    return out


def points_to_planar(points: Sequence[Tuple[int, int]], curve: CurveParams
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Affine (x, y) int pairs -> two (num_limbs, n) planar arrays
    (standard form, not Montgomery — stage 1 encodes on device, mirroring
    pack_affine_and_scalars + convert kernel split)."""
    xs = ints_to_planar([p[0] for p in points], curve.num_limbs, curve.log_limb_size)
    ys = ints_to_planar([p[1] for p in points], curve.num_limbs, curve.log_limb_size)
    return xs, ys


def scalars_to_planar(scalars: Sequence[int], curve: CurveParams) -> np.ndarray:
    """Scalars -> (num_halfwords, n) uint32 array of 16-bit halfwords.

    num_halfwords covers ceil(scalar_bits/32)*2 halfwords (16 for <=256-bit
    scalar fields). Scalars are NOT reduced here; callers pass canonical
    (< r) scalars, matching Arkworks input semantics."""
    n_half = curve.scalar_limbs_u32 * 2
    return ints_to_planar(scalars, n_half, 16)
