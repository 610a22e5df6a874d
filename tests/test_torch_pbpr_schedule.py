"""The order in which pbpr_full's CUDA kernel computes, replayed on CPU
tensors, and its launch geometry.

The kernel computes only the scan sums that a later step reads, level by
level from the table that `kernels.pbpr_scan_levels` builds and the
wrapper hands it (`kernels._pbpr_levels`), passes points between levels as int16
through two exchange arrays, applies the mask where phase B first reads,
and runs the tail on one chain per window. `kernel_order` below does the
same with the plain point formulas (the second exchange array starts as
noise, so a sum read before it is written would show), and must give
`pbpr_full_plain`'s output bit for bit on TINY62 and BN254_S12, at
T = 1, T = B, one window and scans several levels deep. The geometry is
a pure function: stage 1 is pbpr_stage1's launch, every (half, window,
lane) sum of a level has exactly one owner among the chains of six
threads, and the scan launch never has more blocks than are resident."""

import numpy as np
import pytest
import torch

from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.ops import rows
from tpu_msm_torch.reference import curve as ref

from test_torch_pbpr import mont_buckets

torch.set_num_threads(1)

I16 = torch.int16


def level_items(Wp, T, sm, sg):
    """(half, window, lane) of each add of a level, in the kernel's order
    (csrc/pbpr_full.cu scan_kernel): the m half's lanes 0, sm, 2 sm, ...
    window by window, then the g half's with stride sg."""
    parts = []
    for half, stride in ((0, sm), (1, sg)):
        per = T // stride
        it = np.arange(Wp * per)
        parts.append((np.full(len(it), half), it // per, it % per * stride))
    return tuple(np.concatenate(a) for a in zip(*parts))


def kernel_order(buckets, curve, T):
    _, L, Wp, B = buckets.shape
    plane = 2 * Wp * T
    m, g = tk.pbpr_stage1_plain(buckets, curve, T)
    noise = torch.from_numpy(np.random.default_rng(5).integers(
        -2000, 2000, (3, L, plane)).astype(np.int16))
    arrays = [torch.cat([m, g], dim=2).reshape(3, L, plane).to(I16), noise]
    inf = tk.inf_stacked(curve, (1,))[..., 0]                       # (3, L)
    # the table as the kernel reads it: 3 ints a level
    levels = tk._pbpr_levels(T, torch.device("cpu")).reshape(-1, 3).tolist()
    bits = len(levels) // 2

    def read(src, f, at_inf):
        p = src[:, :, np.minimum(f, plane - 1)].to(torch.int32)
        return torch.where(torch.from_numpy(at_inf), inf[:, :, None], p)

    for lv, (k, sm, sg) in enumerate(levels):
        src, dst = arrays[lv & 1], arrays[(lv + 1) & 1]
        masked = lv == bits                       # phase B's first level
        h, w, t = level_items(Wp, T, sm, sg)
        f = (h * Wp + w) * T + t
        p1 = read(src, f, masked & ((h == 0) == (t == 0)))
        p2 = read(src, f + k, (t + k >= T) | (masked & (h == 1)))
        s = rows.padd_rows(tk._unstack(p1), tk._unstack(p2), curve)
        dst[:, :, f] = tk._stack(s).to(I16)
    src = arrays[(2 * bits) & 1]
    w = np.arange(Wp)
    m0 = tk._unstack(read(src, w * T, np.full(Wp, bits == 0)))
    for _ in range(max((B // T).bit_length() - 1, 0)):
        m0 = rows.pdbl_rows(m0, curve)
    g0 = tk._unstack(read(src, (Wp + w) * T, np.zeros(Wp, bool)))
    return tk._stack(rows.padd_rows(m0, g0, curve))


SHAPES = [(2, 8, 1), (2, 8, 8), (1, 16, 4), (3, 64, 8), (2, 32, 32),
          (1, 256, 64)]


@pytest.mark.parametrize("name", ["TINY62", "BN254_S12"])
@pytest.mark.parametrize("Wp,B,T", SHAPES)
def test_pbpr_full_kernel_order_is_the_plain_version(name, Wp, B, T):
    C = getattr(tc, name)
    pts, _ = ref.gen_points_scalars(C, Wp * B, seed=70 + B)
    kill = np.random.default_rng(71 + T).random((Wp, B)) < 0.3
    buckets = mont_buckets(C, pts, (Wp, B), kill)
    want = tk.pbpr_full_plain(buckets, C, T)
    assert torch.equal(kernel_order(buckets, C, T), want)


def test_pbpr_scan_levels():
    assert tk.pbpr_scan_levels(1) == []
    assert tk.pbpr_scan_levels(8) == [(1, 1, 2), (2, 1, 4), (4, 1, 8),
                                      (1, 2, 2), (2, 4, 4), (4, 8, 8)]
    # adds of the two scans a window: T log2 T + 3 (T - 1)
    for T in (2, 64, 512, 2048):
        adds = sum(T // sm + T // sg for _, sm, sg in tk.pbpr_scan_levels(T))
        assert adds == T * (T.bit_length() - 1) + 3 * (T - 1)


@pytest.mark.parametrize("T", [1, 2, 8, 512, 32768])
def test_pbpr_levels_table_is_the_scan_levels(T):
    """The device table the kernel runs from: pbpr_scan_levels, 3 int32 a
    level, an even number of levels (phase A, then phase B)."""
    table = tk._pbpr_levels(T, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.numel() % 6 == 0
    assert [tuple(r) for r in table.reshape(-1, 3).tolist()] == \
        tk.pbpr_scan_levels(T)


# (Wp, B, T): 2^20 and 2^16 without and with GLV, the edges chip_smoke.py
# runs, and T above the one-block-a-window limit of the kernel's first form
GEOMETRY_SHAPES = [(16, 32768, 512), (20, 4096, 256), (9, 32768, 512),
                   (12, 4096, 256), (16, 32768, 1024), (16, 32768, 2048),
                   (16, 32768, 1), (16, 32768, 32768), (1, 32768, 512),
                   (1, 32768, 32), (3, 64, 8)]


@pytest.mark.parametrize("per_sm,threads", [(2, 128), (1, 256)])
@pytest.mark.parametrize("Wp,B,T", GEOMETRY_SHAPES)
def test_pbpr_full_geometry_covers_every_sum_once(Wp, B, T, per_sm,
                                                  threads):
    sms, G = 132, tk.PBPR_STAGE1_THREADS_PER_CHAIN     # kAddG = 6
    geo = tk.pbpr_full_geometry(Wp, B, T, sms, per_sm, threads, G)
    # stage 1 is pbpr_stage1's launch: 12 threads a lane, 2 lanes a warp,
    # lane f = block * lanes a block + lane
    s1 = geo.stage1
    assert s1 == tk.pbpr_stage1_geometry(Wp, B, T, sms)
    lanes = Wp * T
    f = np.arange(s1.blocks * s1.lanes_per_block)
    assert np.array_equal(f[f < lanes], np.arange(lanes))
    assert (s1.blocks - 1) * s1.lanes_per_block < lanes
    warps = threads // 32
    # the scans: chains of G threads, 5 a warp (2 threads idle); chain c
    # takes adds c, c + chains, ... of every level
    assert geo.threads_per_add == G == 6
    assert geo.chains_per_block == warps * (32 // G) == warps * 5
    scan = geo.scan_blocks
    assert 1 <= scan <= sms * per_sm
    chains = scan * geo.chains_per_block
    busiest = 0
    for _, sm, sg in tk.pbpr_scan_levels(T):
        h, w, t = level_items(Wp, T, sm, sg)
        owner = np.arange(len(h)) % chains
        busiest = max(busiest, np.bincount(owner).max())
        # each add once: exactly the lanes of each half that are multiples
        # of its stride, in every window
        pts = np.sort((h * Wp + w) * T + t)
        need = np.concatenate([(hh * Wp + wi) * T + np.arange(0, T, st)
                               for hh, st in ((0, sm), (1, sg))
                               for wi in range(Wp)])
        assert np.array_equal(pts, need)
    assert geo.adds_per_chain == max(busiest, -(-Wp // chains))
    # no block idles unless the card has more room than the widest level
    widest = max([Wp] + [Wp * (T // sm + T // sg)
                         for _, sm, sg in tk.pbpr_scan_levels(T)])
    assert (scan - 1) * geo.chains_per_block < widest


def test_pbpr_full_geometry_more_than_wp_blocks_at_the_msm_shapes():
    for Wp, B, T in [(16, 32768, 512), (20, 4096, 256)]:
        geo = tk.pbpr_full_geometry(Wp, B, T, 132, 2, 128, 6)
        assert geo.stage1.blocks > Wp and geo.scan_blocks > Wp


def test_pbpr_full_geometry_refuses_no_resident_block():
    with pytest.raises(ValueError):
        tk.pbpr_full_geometry(16, 32768, 512, 132, 0, 128, 6)
    with pytest.raises(ValueError):
        tk.pbpr_full_geometry(16, 32768, 3, 132, 2, 128, 6)
    for threads, G in ((48, 6), (128, 33), (128, 0)):
        with pytest.raises(ValueError):
            tk.pbpr_full_geometry(16, 32768, 512, 132, 2, threads, G)


def test_pbpr_full_kernel_order_above_512_threads():
    """T above 512, the one block a window of the kernel's first form."""
    C = tc.TINY62
    Wp, B = 1, 2048
    pts, _ = ref.gen_points_scalars(C, 64, seed=80)
    kill = np.zeros((Wp, B), bool)
    kill[:, 64:] = True
    buckets = mont_buckets(C, pts * (B // 64), (Wp, B), kill)
    for T in (1024, 2048):
        got = tk.pbpr_full(buckets, C, T)
        assert torch.equal(got, kernel_order(buckets, C, T))
