"""The MSM device program on the H100: the counterpart of
`tpu_msm/cuzk/pipeline_pallas.py` (`_windows_device_pallas`).

  Stage 1  (`stage1`) from the wire tensors as staged (int16 or int32
           limbs, uint16 or int32 halfwords, read in place):
           `encode_rows`, the points' (n, 2L) int16 row table of their
           Montgomery forms, and `decompose_digits`, the (Wp, n) int16
           signed digits, zero from W up; under GLV `glv.glv_rows`:
           the doubled stream P ++ phi(P) as a (2n, 2L) table and the
           digits of |k1| ++ |k2|. Two launches; no torch op touches the
           stream. Under a window shard (w_shards > 1) keep the shard's
           block of whole window groups, a view, before the sort.
  Stage 2  `bucket_sort`: each window's digits sorted stably by |d|, the
           sign riding in the payload idx << 1 | sign, and the counts
           cnt[w, j] = #(|d| <= j), every bucket boundary; one call over
           all windows (an LSD radix sort on the card).
  Stage 3  per window group: prefix_scan (which gathers its own point
           rows), col_prefix over the column totals (read in place from
           the scan output), and
           `extract_buckets`: G = T + S at the B+1 region ends
           (infinity where cnt == 0) and bucket = G[1:] - G[:-1], written
           into the group's slice of the bucket tensor in one launch.
  Stage 4  pbpr_full -> (3, L, Wp) window sums.

Lane layout (the port's own; the TPU's (8, F8) sublane tiling is not
ported). Each window's n sorted positions form R = n / C rows by C
columns, column-major: position p sits in column c = p // R, row
r = p % R. Within a window group of Wg windows, lane f = (w mod Wg) * C + c,
F = Wg * C lanes. The scan output T is (3, L, R, F): T[:, :, r, f] is
the running sum of lane f after row r, so the prefix at position p of
window w is element r * F + f of the flattened (3, L, R * F) array, and
the column totals are T[:, :, R - 1]. The points-major row table is
(n, 2L) int16 (Montgomery x limbs, then y limbs); canonical limbs
< 2^w <= 2^13 fit int16 exactly.

There is no small-n fallback: every kernel takes any n that `pack` pads
to a multiple of `columns`, one point included.
"""

from __future__ import annotations

import torch

from ..config import MSMConfig
from . import glv as glv_dev
from . import kernels

I16 = torch.int16
I32 = torch.int32


bucket_counts = kernels.bucket_counts


def boundary_positions(skeys2: torch.Tensor, B: int, Wg: int, C: int, R: int):
    """Where each bucket region of each window ends in the scan output.

    From the (Wp, n) sorted keys: cnt (Wp, B+1), the `bucket_counts`; f,
    the lane of the last position below each boundary; and jt, that
    position's element r * F + f of the flattened (3, L, R * F) scan
    output (`kernels.boundary_lanes`). Both are clamped to position 0
    where cnt == 0."""
    cnt = bucket_counts(skeys2, B)
    return (cnt, *kernels.boundary_lanes(cnt, Wg, C, R))


def stage1(xs: torch.Tensor, ys: torch.Tensor, halfwords: torch.Tensor,
           cfg: MSMConfig):
    """The wire tensors -> (pts_rows, digits): the (n', 2L) int16 row
    table of the points' Montgomery forms and the (Wp, n') int16 signed
    digits, n' the stream's lanes (2n under GLV). Shared by both device
    programs and the sharded path."""
    if cfg.glv:
        return glv_dev.glv_rows(xs, ys, halfwords, cfg)
    return (kernels.encode_rows(xs, ys, cfg.curve),
            kernels.decompose_digits(halfwords, cfg.window_size,
                                     cfg.num_windows, cfg.padded_windows))


def windows_device(xs: torch.Tensor, ys: torch.Tensor,
                   halfwords: torch.Tensor, cfg: MSMConfig,
                   w_shards: int = 1, w_index: int = 0) -> torch.Tensor:
    """Planar inputs on one device -> (3, L, Wp) int32 window sums.

    xs, ys: (L, n) canonical standard-form limbs (int16 or int32).
    halfwords: (H, n) 16-bit scalar halfwords (uint16 or int32), with the
        two zero pad rows of `MSMPipeline.pack`.
    Each may be a slice of the columns of a wider array: stage 1 reads
    them in place. Under cfg.glv the stream has 2n lanes, and C, R, F and
    the row table follow it.

    w_shards > 1 runs stages 2 to 4 on the shard's contiguous block of
    whole window groups only, windows [w_index Wp_l, (w_index + 1) Wp_l)
    with Wp_l = Wp / w_shards, and returns (3, L, Wp_l): the window axis
    of a (points x windows) mesh (`parallel/sharded.py`). w_shards must
    divide num_groups."""
    curve = cfg.curve
    L = curve.num_limbs
    dev = xs.device
    n = (2 if cfg.glv else 1) * xs.shape[-1]       # stream lanes
    Wg, G = cfg.subtask_group, cfg.num_groups
    B, Wp = cfg.half_columns, cfg.padded_windows
    if w_shards < 1 or G % w_shards:
        raise ValueError(f"w_shards={w_shards} must divide num_groups={G}")
    if not 0 <= w_index < w_shards:
        raise ValueError(f"w_index={w_index} is not in [0, {w_shards})")
    C = min(cfg.columns, n)
    if n % C:
        raise ValueError(f"n={n} is not a multiple of columns={C}")
    R = n // C

    # ---- stage 1 ----
    pts_rows, digits = stage1(xs, ys, halfwords, cfg)
    # the shard's window groups, a view of whole rows; Wg divides Wp, so
    # the lanes of kernels.boundary_lanes stay right
    Wp, G = Wp // w_shards, G // w_shards
    digits = digits[w_index * Wp:(w_index + 1) * Wp]

    # ---- stage 2: one stable sort of all windows by |d|, and the counts
    pay_all, cnt_all = kernels.bucket_sort(digits, B)

    # ---- stage 3: per window group ----
    buckets = torch.empty((3, L, Wp, B), dtype=I16, device=dev)
    for g in range(G):
        sl = slice(g * Wg, (g + 1) * Wg)
        tbuf = kernels.prefix_scan(pts_rows, pay_all[sl], curve, C)
        S = kernels.col_prefix(kernels.column_totals(tbuf, Wg),
                               curve)                         # exclusive
        kernels.extract_buckets(tbuf, S, cnt_all, buckets, g, Wg, C, R,
                                curve)

    # ---- stage 4 ----
    return kernels.pbpr_full(buckets, curve, min(cfg.pbpr_threads, B))
