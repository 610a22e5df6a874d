"""Pipeline stage 3 of the XLA path: bucket accumulation (the SMVP).

The port of `tpu_msm/cuzk/smvp.py` `bucket_accumulate`, the JAX
package's second device algorithm for the bucket sums, beside the
prefix scans of `pipeline_cuda.windows_device`:

  1. sort each window's points by bucket key (`cuzk/sort.py`);
  2. lay the sorted stream out column-major as R rows by C columns and
     walk the rows once: each step is one complete mixed add
     (`ops/complete.pmadd`, torch ops) on Wg x C lanes, restarted with
     the point itself at a run start;
  3. a lane that ends a bucket run (its key differs from the next key in
     global order) writes its running sum into the bucket array; each
     run ends at exactly one position, so no bucket is written twice;
  4. runs that cross columns are stitched by a segmented scan over the C
     trailing sums, in the odd/even order of XLA's `associative_scan`,
     each level one `kernels.padd_batch` launch; the exclusive prefixes
     are then added into the first run of each continuing column, one
     more `padd_batch`.

The JAX scatters drop their writes at the sentinel index B + 1 (an
out-of-range index under mode="drop"). Here the bucket array has one
spare slot, B + 1, which takes every such write and is never read: the
writes to it repeat and land in no set order on CUDA, and the real
indices of one scatter never repeat. The stitch combines in the same
order as XLA, so the buckets are bit-identical to the JAX function's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..config import MSMConfig
from ..ops import complete, lazy
from . import kernels, sort

Flagged = Tuple[torch.Tensor, torch.Tensor]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along the last axis (len(a) - len(b) in
    {0, 1})."""
    out = a.new_empty(a.shape[:-1] + (a.shape[-1] + b.shape[-1],))
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def associative_scan(combine: Callable[[Flagged, Flagged], Flagged],
                     elems: Flagged) -> Flagged:
    """Inclusive scan along the last axis of (points, flags) with the
    recursion of `jax.lax.associative_scan`: pairs are combined, the
    halved sequence is scanned, then the even positions are combined
    with the odd results. A non-commutative `combine` (a point sum under
    segment flags) then sees its operands in XLA's order, level by
    level."""
    pts, flags = elems
    m = pts.shape[-1]
    if m < 2:
        return elems
    odd = associative_scan(combine, combine(
        (pts[..., 0:-1:2], flags[..., 0:-1:2]),
        (pts[..., 1::2], flags[..., 1::2])))
    # at m == 2 XLA combines two empty slices; a launch of no lanes is
    # refused, so there the even part is the first element alone
    even = (pts[..., :1], flags[..., :1])
    if m > 2:
        left = odd if m % 2 else (odd[0][..., :-1], odd[1][..., :-1])
        rest = combine(left, (pts[..., 2::2], flags[..., 2::2]))
        even = (torch.cat([even[0], rest[0]], dim=-1),
                torch.cat([even[1], rest[1]], dim=-1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def bucket_accumulate(xs_m: torch.Tensor, ys_m: torch.Tensor,
                      digits: torch.Tensor, cfg: MSMConfig) -> torch.Tensor:
    """The bucket sums of one window group.

    xs_m, ys_m: (L, n) int32 Montgomery affine coordinates (canonical
        limbs, value < 2p), shared by the windows.
    digits: (Wg, n) signed digits of the group's windows.
    Returns (3, L, Wg, B) int32 stacked points, slot b holding bucket b+1
    (multiplier b+1)."""
    curve = cfg.curve
    dev = xs_m.device
    Wg, n = digits.shape
    C = min(cfg.columns, n)
    if n % C:
        raise ValueError(f"n={n} must be a multiple of columns={C}")
    R = n // C
    L = curve.num_limbs
    B = cfg.half_columns

    keys, neg_mask = sort.bucket_keys(digits)
    skeys, perm = sort.sort_by_bucket(keys)
    ssign = torch.gather(neg_mask, -1, perm)

    # negate y where the digit was negative (2p - y keeps values positive)
    sy_all = ys_m[:, perm]                                       # (L,Wg,n)
    sy_all = torch.where(ssign, lazy.neg(sy_all, curve, 2), sy_all)

    # column-major: global position g = c R + r
    def rows_first(a):                          # (..., Wg, n) -> (R, ...)
        return a.reshape(a.shape[:-1] + (C, R)).movedim(-1, 0).contiguous()

    sx = rows_first(xs_m[:, perm])                               # (R,L,Wg,C)
    sy = rows_first(sy_all)
    kt = rows_first(skeys.long())                                # (R,Wg,C)

    # run boundaries in global order: down each column, then the next
    first_next = torch.cat([kt[0, :, 1:], kt.new_full((Wg, 1), -1)], dim=-1)
    next_keys = torch.cat([kt[1:], first_next[None]])
    ends = kt != next_keys
    brk = torch.cat([torch.ones((1, Wg, C), dtype=torch.bool, device=dev),
                     kt[1:] != kt[:-1]])                         # run starts
    allsame = ~torch.any(brk[1:], dim=0)                         # (Wg, C)

    one_m = lazy.mont_one(curve, 2, dev)
    w_idx = torch.arange(Wg, device=dev)[:, None]
    spare = B + 1

    carry = complete.proj_infinity(curve, (Wg, C), dev)
    bucket = kernels.inf_stacked(curve, (Wg, B + 2), dev)    # + spare slot
    for r in range(R):
        summed = complete.pmadd(carry, sx[r], sy[r], curve)
        carry = complete.select(
            brk[r], complete.ProjPoint(sx[r], sy[r], one_m), summed)
        idx = torch.where(ends[r], kt[r], spare)
        bucket[:, :, w_idx, idx] = torch.stack(
            torch.broadcast_tensors(*carry))

    # ---- cross-column stitch ----
    key_first, key_last = kt[0], kt[-1]
    no = torch.zeros((Wg, 1), dtype=torch.bool, device=dev)
    cont = torch.cat([no, key_last[:, :-1] == key_first[:, 1:]], dim=-1)

    def comb(a: Flagged, b: Flagged) -> Flagged:
        s = kernels.padd_batch(a[0], b[0], curve)
        return torch.where(b[1], b[0], s), a[1] | b[1]

    trailing = torch.stack(carry)                                # (3,L,Wg,C)
    scanned, _ = associative_scan(comb, (trailing, (~allsame) | (~cont)))
    # exclusive prefix: the trailing-chain sum arriving at column c
    P = torch.cat([kernels.inf_stacked(curve, (Wg, 1), dev),
                   scanned[..., :-1]], dim=-1)

    cont_next = torch.cat([cont[:, 1:], no], dim=-1)
    inject = cont & ((~allsame) | (~cont_next))
    cur = bucket[:, :, w_idx, key_first]
    fixed = kernels.padd_batch(cur, P, curve)
    bucket[:, :, w_idx, torch.where(inject, key_first, spare)] = \
        torch.where(inject, fixed, cur)

    # drop the discard slot (digit 0) and the spare one
    return bucket[..., 1:B + 1]
