"""Stage 3's bucket extraction: `kernels.extract_buckets`'s plain version
against the JAX package and against the torch sequence it replaced, and
csrc/extract_buckets.cu's blocks replayed, on CPU tensors.

The inputs are a real scan output T, its exclusive column prefix S and
the counts of `bucket_sort`, made by the port's own stages 1 to 3 on the
CPU. TINY62: against the JAX composition of pipeline_pallas.py:292-304,
a `jnp.take` of the flattened T and S (as `flat_gather` takes them), the
Pallas `padd_batch`, `jnp.where` and the Pallas `psub_batch` in
interpret mode. BN254_S12: against the torch sequence of the stage 3
that came before (two advanced-index gathers, `padd_batch`,
`torch.where`, `psub_batch` of the neighbours into the group's slice),
bit for bit. Edges: cnt == 0 at j = 0, an empty window, cnt == n, and
Wg = 1 and 4. The kernel's block split (runs of 19 buckets, the halo lane,
the last partial run) is replayed with the plain add and must give the
plain version's bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.constants import BN254_S12, TINY62
from tpu_msm_torch.cuzk import kernels, pipeline_cuda
from tpu_msm_torch.cuzk.pipeline import get_pipeline
from tpu_msm_torch.reference import curve as ref

torch.set_num_threads(1)

I16, I32 = torch.int16, torch.int32


def stage3_inputs(cfg, n, seed=5):
    """(tbuf, S, cnt, C, R) of window group 0 of n points: the port's
    stages 1 and 2 and the group's scan and column prefix, plain."""
    curve = cfg.curve
    L = curve.num_limbs
    pts, scalars = ref.gen_points_scalars(curve, n, seed=seed)
    xs, ys, hw = map(torch.from_numpy, get_pipeline(cfg, "cpu").pack(
        pts, scalars))
    xm = kernels.encode_mont(xs.to(I32), curve)
    ym = kernels.encode_mont(ys.to(I32), curve)
    digits = kernels.decompose_digits(hw.to(I32), cfg.window_size,
                                      cfg.num_windows)
    Wp, Wg = cfg.padded_windows, cfg.subtask_group
    digits = torch.cat([digits, digits.new_zeros((Wp - digits.shape[0],
                                                  digits.shape[1]))])
    n = digits.shape[1]
    C = min(cfg.columns, n)
    R = n // C
    pay, cnt = kernels.bucket_sort(digits, cfg.half_columns)
    rows = torch.cat([xm, ym]).to(I16).T.contiguous()
    tbuf = kernels.prefix_scan(rows, pay[:Wg].contiguous(), curve, C)
    coltot = tbuf[:, :, R - 1].reshape(3, L, Wg, C).contiguous()
    return tbuf, kernels.col_prefix(coltot, curve), cnt, C, R


def empty_buckets(cfg, Wp):
    """A (3, L, Wp, B) bucket tensor that is not zero, so that a write
    outside the group's slice would show."""
    g = torch.Generator().manual_seed(1)
    return torch.randint(-99, 99, (3, cfg.curve.num_limbs, Wp,
                                   cfg.half_columns), generator=g,
                         dtype=I16)


def old_stage3(tbuf, S, cnt, buckets, g, Wg, C, R, curve):
    """The stage 3 of pipeline_cuda.windows_device before the kernel, on
    its sorted-key boundaries (`boundary_positions`' lanes)."""
    L, F = curve.num_limbs, Wg * C
    f_all, jt_all = kernels.boundary_lanes(cnt, Wg, C, R)
    sl = slice(g * Wg, (g + 1) * Wg)
    inf_b1 = kernels.inf_stacked(curve, (Wg, 1))
    Tall = tbuf.reshape(3, L, R * F)[:, :, jt_all[sl].long()]
    Sall = S.reshape(3, L, F)[:, :, f_all[sl].long()]
    Gall = kernels.padd_batch(Tall, Sall, curve)
    Gp = torch.where(cnt[sl] == 0, inf_b1, Gall)
    buckets[:, :, sl] = kernels.psub_batch(Gp[..., 1:], Gp[..., :-1], curve,
                                           out_dtype=I16)
    return buckets


def jax_stage3(tbuf, S, cnt, g, Wg, C, R, jcurve):
    """pipeline_pallas.py:292-304 on the same T, S and counts: the
    region ends' lanes as pipeline_pallas computes them (in the port's
    (R, F) layout), `flat_gather`'s row take, the Pallas adds in
    interpret mode and the select."""
    L, F = jcurve.num_limbs, Wg * C
    cnt_g = jnp.asarray(cnt[g * Wg:(g + 1) * Wg].numpy())
    p = jnp.maximum(cnt_g - 1, 0)
    f = (jnp.arange(Wg, dtype=jnp.int32) % Wg)[:, None] * C + p // R
    jt = (p % R) * F + f

    def flat_gather(src, idx):
        pm = src.reshape(3 * L, src.shape[-1]).T
        return jnp.take(pm, idx.reshape(-1), axis=0).T.reshape(
            (3, L) + idx.shape)

    Tall = flat_gather(jnp.asarray(tbuf.numpy()).reshape(3, L, R * F), jt)
    Sall = flat_gather(jnp.asarray(S.numpy()).reshape(3, L, F), f)
    Gall = jk.padd_batch(Tall, Sall, jcurve)
    inf_b1 = jk.inf_stacked(jcurve, (Wg, 1))
    Gp = jnp.where((cnt_g == 0)[None, None], inf_b1, Gall)
    return np.asarray(jk.psub_batch(Gp[..., 1:], Gp[..., :-1], jcurve,
                                    out_dtype=jnp.int16))


TINY_CFG = MSMConfig(curve=TINY62, window_size=6, columns=16,
                     pbpr_threads=8, subtask_group=2)


def test_tiny62_against_jax_pallas():
    cfg = TINY_CFG
    Wg, Wp = cfg.subtask_group, cfg.padded_windows
    tbuf, S, cnt, C, R = stage3_inputs(cfg, 64)
    cnt = cnt.clone()
    cnt[0, 0] = 0                       # nothing at digit 0 in window 0
    cnt[1, -2:] = R * C                 # the last position
    got = kernels.extract_buckets(tbuf, S, cnt, empty_buckets(cfg, Wp), 0,
                                  Wg, C, R, TINY62)
    want = jax_stage3(tbuf, S, cnt, 0, Wg, C, R, jc.TINY62)
    assert got.dtype == I16
    assert np.array_equal(got[:, :, :Wg].numpy(), want)
    assert torch.equal(got[:, :, Wg:], empty_buckets(cfg, Wp)[:, :, Wg:])


S12_CFG = {1: MSMConfig(curve=BN254_S12, window_size=8, columns=32,
                        pbpr_threads=16, subtask_group=1),
           4: MSMConfig(curve=BN254_S12, window_size=8, columns=32,
                        pbpr_threads=16, subtask_group=4)}


@pytest.mark.parametrize("edge", ["real", "edges"])
@pytest.mark.parametrize("Wg", [1, 4])
def test_bn254_s12_against_old_sequence(Wg, edge):
    cfg = S12_CFG[Wg]
    Wp = cfg.padded_windows
    tbuf, S, cnt, C, R = stage3_inputs(cfg, 96)
    if edge == "edges":
        cnt = cnt.clone()
        cnt[:, 0] = 0                   # cnt == 0 at j = 0
        cnt[Wg - 1] = 0                 # an empty window
        cnt[0, -5:] = R * C             # cnt == n
    g = 0 if edge == "real" else Wp // Wg - 1
    got = kernels.extract_buckets(tbuf, S, cnt, empty_buckets(cfg, Wp), g,
                                  Wg, C, R, BN254_S12)
    want = old_stage3(tbuf, S, cnt, empty_buckets(cfg, Wp), g, Wg, C, R,
                      BN254_S12)
    assert torch.equal(got, want)


def test_boundary_positions_and_counts_agree():
    """The old stage 2's boundaries (the sorted packed keys) and
    `bucket_sort`'s counts give the same lanes."""
    cfg = S12_CFG[4]
    pts, scalars = ref.gen_points_scalars(BN254_S12, 64, seed=3)
    _, _, hw = get_pipeline(cfg, "cpu").pack(pts, scalars)
    digits = kernels.decompose_digits(torch.from_numpy(hw.astype(np.int32)),
                                      cfg.window_size, cfg.num_windows)
    d32 = digits.to(I32)
    keys2 = (d32.abs() << 1) | (d32 < 0).to(I32)
    cnt_old, f_old, jt_old = pipeline_cuda.boundary_positions(
        torch.sort(keys2, dim=-1)[0], cfg.half_columns, 4, 32, 2)
    _, cnt = kernels.bucket_sort(digits, cfg.half_columns)
    f, jt = kernels.boundary_lanes(cnt, 4, 32, 2)
    assert torch.equal(cnt, cnt_old)
    assert torch.equal(f, f_old) and torch.equal(jt, jt_old)


# ---------------------------------------------------------------------------
# csrc/extract_buckets.cu: its geometry and its blocks replayed
# ---------------------------------------------------------------------------


def replay(tbuf, S, cnt, buckets, g, Wg, C, R, curve):
    """The kernel's blocks, one after another: block k of window wl takes
    buckets b0 = (k mod chunks) J .. b0 + J - 1, adds G on its J + 1
    region ends (the halo b0 included), infinity where cnt == 0, then
    the neighbours' differences, and stores them at its run."""
    L, F, B = curve.num_limbs, Wg * C, cnt.shape[1] - 1
    geo = kernels.extract_buckets_geometry(Wg, B, L, curve.log_limb_size)
    J = geo.buckets_per_block
    chunks = geo.blocks // Wg
    f_all, jt_all = kernels.boundary_lanes(cnt, Wg, C, R)
    tflat, sflat = tbuf.reshape(3, L, R * F), S.reshape(3, L, F)
    one = kernels.inf_stacked(curve, (1,))[..., 0]
    for blk in range(geo.blocks):
        wl, b0 = blk // chunks, (blk % chunks) * J
        w = g * Wg + wl
        nA = min(J + 1, B + 1 - b0)
        js = torch.arange(b0, b0 + nA)
        G = kernels.padd_batch_plain(tflat[:, :, jt_all[w, js].long()],
                                     sflat[:, :, f_all[w, js].long()], curve)
        G[:, :, cnt[w, js] == 0] = one[:, :, None]
        buckets[:, :, w, b0:b0 + nA - 1] = kernels.psub_batch_plain(
            G[..., 1:], G[..., :-1], curve, out_dtype=I16)
    return buckets


@pytest.mark.parametrize("Wg,n,s", [(1, 96, 8), (4, 64, 6), (2, 32, 10)])
def test_kernel_blocks_replayed(Wg, n, s):
    """B = 128 (6 full runs of 19 and one of 14), 32 (a run of 13) and
    512 (26 runs and one of 18) buckets, with cnt == 0 and cnt == n lanes at
    run edges."""
    cfg = MSMConfig(curve=TINY62, window_size=s, columns=16, pbpr_threads=8,
                    subtask_group=Wg)
    Wp = cfg.padded_windows
    tbuf, S, cnt, C, R = stage3_inputs(cfg, n)
    cnt = cnt.clone()
    cnt[0, :20] = 0                     # the first run and the next halo
    cnt[Wg - 1, 37:40] = R * C
    got = replay(tbuf, S, cnt, empty_buckets(cfg, Wp), 0, Wg, C, R, TINY62)
    want = kernels.extract_buckets(tbuf, S, cnt, empty_buckets(cfg, Wp), 0,
                                   Wg, C, R, TINY62)
    assert torch.equal(got, want)


@pytest.mark.parametrize("L,w", [(22, 12), (21, 13), (32, 12), (30, 13),
                                 (6, 12)])
def test_geometry(L, w):
    for Wg, B in ((1, 1 << 15), (4, 1 << 12), (16, 1 << 15), (1, 1)):
        geo = kernels.extract_buckets_geometry(Wg, B, L, w)
        assert geo.lanes_per_block == 20 and geo.buckets_per_block == 19
        assert geo.threads == 128
        assert geo.blocks == Wg * -(-B // 19)
        # the lanes' words, the sums G, the positions and the constants
        assert geo.shared_bytes <= kernels.BLOCK_SHARED_BYTES
        assert geo.shared_bytes >= 4 * 20 * (15 * L + 1 + 3 * L)
    with pytest.raises(ValueError):
        kernels.extract_buckets_geometry(0, 4)


def test_wrapper_refusals():
    cfg = TINY_CFG
    L, Wp, B = 6, cfg.padded_windows, cfg.half_columns
    tbuf = torch.zeros((3, L, 4, 32), dtype=I16)
    S = torch.zeros((3, L, 32), dtype=I16)
    cnt = torch.zeros((Wp, B + 1), dtype=I32)
    buckets = torch.zeros((3, L, Wp, B), dtype=I16)
    with pytest.raises(ValueError):      # g past the last group
        kernels.extract_buckets(tbuf, S, cnt, buckets, Wp // 2, 2, 16, 4,
                                TINY62)
    with pytest.raises(ValueError):      # F is not Wg C
        kernels.extract_buckets(tbuf, S, cnt, buckets, 0, 2, 8, 4, TINY62)
    with pytest.raises(ValueError, match="meta"):
        kernels.extract_buckets(tbuf.to("meta"), S.to("meta"),
                                cnt.to("meta"), buckets.to("meta"), 0, 2, 16,
                                4, TINY62)
