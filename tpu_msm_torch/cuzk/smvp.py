"""Pipeline stage 3 of the XLA path: bucket accumulation (the SMVP).

The port of `tpu_msm/cuzk/smvp.py` `bucket_accumulate`, the JAX
package's second device algorithm for the bucket sums, beside the
prefix scans of `pipeline_cuda.windows_device`:

  1. sort each window's points stably by bucket key |d|
     (`kernels.bucket_sort`, the main path's sort: the permutation of
     `cuzk/sort.py`'s stable sort, the sign in the payload);
  2. lay the sorted stream out column-major as R rows by C columns and
     walk the rows once (`kernels.smvp_rows`, one launch a group, the
     counterpart of the JAX function's lax.fori_loop): each step is one
     complete mixed add on Wg x C lanes, restarted with the point itself
     at a run start;
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
spare slot, B + 1, which the row walk leaves at infinity and which takes
every write of the inject's lanes that inject nothing; it is never read:
those writes repeat and land in no set order on CUDA, and the real
indices of one scatter never repeat. The stitch combines in the same
order as XLA, so the buckets are bit-identical to the JAX function's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..config import MSMConfig
from . import kernels

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
                      digits: torch.Tensor, cfg: MSMConfig,
                      pts_rows: torch.Tensor | None = None) -> torch.Tensor:
    """The bucket sums of one window group.

    xs_m, ys_m: (L, n) int32 Montgomery affine coordinates (canonical
        limbs, value < 2p), shared by the windows.
    digits: (Wg, n) signed digits of the group's windows.
    pts_rows: the (n, 2L) int16 row table of xs_m and ys_m
        (`pipeline_cuda.windows_device`'s), made here if not given.
    Returns (3, L, Wg, B) int32 stacked points, slot b holding bucket b+1
    (multiplier b+1)."""
    curve = cfg.curve
    dev = xs_m.device
    Wg, n = digits.shape
    C = min(cfg.columns, n)
    if n % C:
        raise ValueError(f"n={n} must be a multiple of columns={C}")
    R = n // C
    B = cfg.half_columns

    if pts_rows is None:
        pts_rows = torch.cat([xs_m, ys_m]).to(torch.int16).T.contiguous()
    pay, _ = kernels.bucket_sort(digits.to(torch.int16).contiguous(), B)
    skeys = torch.gather(digits.to(torch.int32).abs(), 1, (pay >> 1).long())
    bucket, trailing = kernels.smvp_rows(pts_rows, pay, skeys, curve, C, B)

    # each column's first and last key; keys are sorted, so a column
    # holds one run throughout where the two are equal
    kc = skeys.reshape(Wg, C, R).long()
    key_first, key_last = kc[..., 0], kc[..., -1]
    allsame = key_first == key_last                              # (Wg, C)
    w_idx = torch.arange(Wg, device=dev)[:, None]
    spare = B + 1

    # ---- cross-column stitch ----
    no = torch.zeros((Wg, 1), dtype=torch.bool, device=dev)
    cont = torch.cat([no, key_last[:, :-1] == key_first[:, 1:]], dim=-1)

    def comb(a: Flagged, b: Flagged) -> Flagged:
        s = kernels.padd_batch(a[0], b[0], curve)
        return torch.where(b[1], b[0], s), a[1] | b[1]

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
