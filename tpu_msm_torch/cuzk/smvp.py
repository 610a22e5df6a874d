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
     trailing sums, in the tree and operand order of XLA's
     `associative_scan`, and the exclusive prefixes are then added into
     the first run of each continuing column (`kernels.smvp_stitch`, one
     launch a group, in place on the buckets).

The JAX scatters drop their writes at the sentinel index B + 1 (an
out-of-range index under mode="drop"). Here the bucket array has one
spare slot, B + 1, which the row walk and the stitch leave at infinity
and which is never read. The stitch combines in the same order as XLA,
so the buckets are bit-identical to the JAX function's. On CUDA tensors
a group is two launches, `bucket_sort` (its own launches inside one
call) aside: `smvp_rows` and `smvp_stitch`.
"""

from __future__ import annotations

import torch

from ..config import MSMConfig
from . import kernels


def bucket_accumulate(xs_m: torch.Tensor | None, ys_m: torch.Tensor | None,
                      digits: torch.Tensor, cfg: MSMConfig,
                      pts_rows: torch.Tensor | None = None) -> torch.Tensor:
    """The bucket sums of one window group.

    xs_m, ys_m: (L, n) int32 Montgomery affine coordinates (canonical
        limbs, value < 2p), shared by the windows: the JAX function's
        arguments, read only where pts_rows is not given.
    digits: (Wg, n) signed digits of the group's windows.
    pts_rows: the (n, 2L) int16 row table of the points, as stage 1
        writes it (`pipeline_cuda.stage1`, the XLA path's caller); made
        from xs_m and ys_m by `kernels.row_table` if not given.
    Returns (3, L, Wg, B) int32 stacked points, slot b holding bucket b+1
    (multiplier b+1)."""
    curve = cfg.curve
    n = digits.shape[1]
    C = min(cfg.columns, n)
    if n % C:
        raise ValueError(f"n={n} must be a multiple of columns={C}")
    B = cfg.half_columns

    if pts_rows is None:
        pts_rows = kernels.row_table(xs_m, ys_m)
    pay, _ = kernels.bucket_sort(digits.to(torch.int16).contiguous(), B)
    skeys = torch.gather(digits.to(torch.int32).abs(), 1, (pay >> 1).long())
    bucket, trailing = kernels.smvp_rows(pts_rows, pay, skeys, curve, C, B)
    kernels.smvp_stitch(bucket, trailing, skeys, curve, C)

    # drop the discard slot (digit 0) and the spare one
    return bucket[..., 1:B + 1]
