"""The MSM device program on the H100: the counterpart of
`tpu_msm/cuzk/pipeline_pallas.py` (`_windows_device_pallas`).

  Stage 1  widen the wire dtypes to int32; encode_mont on x and y;
           decompose_digits into int16 signed digits (under GLV,
           `glv.apply_glv`: the doubled stream P ++ phi(P) and the
           digits of |k1| ++ |k2|); pad the windows to Wp with zero
           digits.
  Stage 2  sign-packed keys |d| << 1 | sign and ONE torch.sort over all
           windows; the payload idx << 1 | sign rides the permutation.
           Every bucket boundary cnt[w, j] = #(keys < 2(j+1)) comes from
           torch.searchsorted on the sorted keys.
  Stage 3  per window group: prefix_scan (which gathers its own point
           rows), col_prefix over the column totals, G = T + S at the
           B+1 region ends through padd_batch (infinity where cnt == 0),
           and bucket = psub_batch(G[1:], G[:-1]).
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


def bucket_counts(skeys2: torch.Tensor, B: int) -> torch.Tensor:
    """cnt[w, j] = #(keys2[w] < 2(j+1)) for j = 0..B, from the sorted keys:
    the end of the digit-0 region (j = 0) and of each bucket's region."""
    Wp = skeys2.shape[0]
    q = (torch.arange(1, B + 2, dtype=I32, device=skeys2.device) * 2)
    return torch.searchsorted(skeys2, q.expand(Wp, B + 1).contiguous()
                              ).to(I32)


def boundary_positions(skeys2: torch.Tensor, B: int, Wg: int, C: int, R: int):
    """Where each bucket region of each window ends in the scan output.

    From the (Wp, n) sorted keys: cnt (Wp, B+1), the `bucket_counts`; f,
    the lane of the last position below each boundary; and jt, that
    position's element r * F + f of the flattened (3, L, R * F) scan
    output. Both are clamped to position 0 where cnt == 0."""
    Wp = skeys2.shape[0]
    cnt = bucket_counts(skeys2, B)
    p = (cnt - 1).clamp(min=0)
    f = (torch.arange(Wp, dtype=I32, device=skeys2.device) % Wg)[:, None] * C \
        + p // R
    return cnt, f, (p % R) * (Wg * C) + f


def windows_device(xs: torch.Tensor, ys: torch.Tensor,
                   halfwords: torch.Tensor, cfg: MSMConfig) -> torch.Tensor:
    """Planar inputs on one device -> (3, L, Wp) int32 window sums.

    xs, ys: (L, n) canonical standard-form limbs (int16 or int32).
    halfwords: (H, n) 16-bit scalar halfwords (uint16 or int32), with the
        two zero pad rows of `MSMPipeline.pack`.
    Under cfg.glv the stream has 2n lanes, and C, R, F and the row table
    follow it."""
    curve = cfg.curve
    L = curve.num_limbs
    dev = xs.device
    xs, ys, hw = xs.to(I32), ys.to(I32), halfwords.to(I32)
    n = (2 if cfg.glv else 1) * xs.shape[-1]       # stream lanes
    W, Wg, G = cfg.num_windows, cfg.subtask_group, cfg.num_groups
    B, Wp = cfg.half_columns, cfg.padded_windows
    C = min(cfg.columns, n)
    if n % C:
        raise ValueError(f"n={n} is not a multiple of columns={C}")
    R = n // C
    F = Wg * C

    # ---- stage 1 ----
    xm = kernels.encode_mont(xs.contiguous(), curve)
    ym = kernels.encode_mont(ys.contiguous(), curve)
    if cfg.glv:
        xm, ym, digits = glv_dev.apply_glv(xm, ym, hw, cfg)
    else:
        digits = kernels.decompose_digits(hw.contiguous(), cfg.window_size,
                                          W)
    if Wp > W:
        digits = torch.cat([digits, digits.new_zeros((Wp - W, n))])

    # ---- stage 2: one sort for all windows, boundaries by searchsorted ----
    d32 = digits.to(I32)
    keys2 = (d32.abs() << 1) | (d32 < 0).to(I32)
    skeys2, perm = torch.sort(keys2, dim=-1)
    pay_all = (perm.to(I32) << 1) | (skeys2 & 1)
    cnt_all, f_all, jt_all = boundary_positions(skeys2, B, Wg, C, R)
    pts_rows = torch.cat([xm, ym]).to(I16).T.contiguous()     # (n, 2L)
    inf_b1 = kernels.inf_stacked(curve, (Wg, 1), dev)

    # ---- stage 3: per window group ----
    buckets = torch.empty((3, L, Wp, B), dtype=I16, device=dev)
    for g in range(G):
        sl = slice(g * Wg, (g + 1) * Wg)
        tbuf = kernels.prefix_scan(pts_rows, pay_all[sl].contiguous(), curve,
                                   C)                         # (3, L, R, F)
        coltot = tbuf[:, :, R - 1].reshape(3, L, Wg, C).contiguous()
        S = kernels.col_prefix(coltot, curve)                 # exclusive
        Tall = tbuf.reshape(3, L, R * F)[:, :, jt_all[sl].long()]
        Sall = S.reshape(3, L, F)[:, :, f_all[sl].long()]     # (3,L,Wg,B+1)
        Gall = kernels.padd_batch(Tall, Sall, curve)
        # cnt == 0: nothing sorts below this boundary, G(-1) = infinity
        Gp = torch.where(cnt_all[sl] == 0, inf_b1, Gall)
        # bucket b (multiplier b+1) = G(end of its region) - G(previous end)
        buckets[:, :, sl] = kernels.psub_batch(Gp[..., 1:], Gp[..., :-1],
                                               curve, out_dtype=I16)

    # ---- stage 4 ----
    return kernels.pbpr_full(buckets, curve, min(cfg.pbpr_threads, B))
