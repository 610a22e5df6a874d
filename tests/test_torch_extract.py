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
Wg = 1 and 4. The kernel's persistent blocks (each walking its runs of
39 buckets, the loader staging run k + 1 before the adds of run k, the
halo lane, the masked last run of a window, the divisions by a multiply
and a shift) are replayed with the plain add and must give the plain
version's bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.constants import BN254_S12, TINY62, int_to_limbs
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
# csrc/extract_buckets.cu: its geometry and its persistent blocks replayed
# ---------------------------------------------------------------------------


def replay(tbuf, S, cnt, buckets, g, Wg, C, R, curve, sms, per_sm,
           order=None):
    """The kernel's blocks: block k takes runs k, k + blocks, ... of 39
    buckets, its loader warp staging run k + 1 (cnt, the positions by
    `fast_div`, the T and S gathers) once the add warps have copied run k
    into their lanes and before they add it. The lanes: G = T + S into
    each lane's q words, then one move (lane l's G, infinity where
    cnt == 0, as p of bucket l - 1 and, y negated, as q of bucket l),
    then the differences, stored at the run. The blocks run one after
    another in `order` (any order: each writes only its own runs)."""
    L, F, B = curve.num_limbs, Wg * C, cnt.shape[1] - 1
    geo = kernels.extract_buckets_geometry(Wg, B, sms, per_sm, L,
                                           curve.log_limb_size)
    lanes, J, rpw = geo.lanes_per_block, geo.buckets_per_run, \
        geo.runs_per_window
    by_r, by_rpw = kernels.fast_div(R), kernels.fast_div(rpw)
    div = lambda x, f: (x * f[0]) >> f[1]
    tflat, sflat = tbuf.reshape(3, L, R * F), S.reshape(3, L, F)
    one = kernels.inf_stacked(curve, (1,))[:, :, 0]
    kp4 = torch.tensor(int_to_limbs(4 * curve.p, L, curve.log_limb_size),
                       dtype=I32)
    staged = []                         # runs staged and not yet added

    def stage(run):
        """The loader: one run into the staging buffer."""
        wl = div(run, by_rpw)
        assert wl == run // rpw
        b0 = (run - wl * rpw) * J
        nA = min(lanes, B + 1 - b0)
        c = cnt[g * Wg + wl, b0:b0 + nA]
        p = (c - 1).clamp(min=0)
        q = torch.tensor([div(int(v), by_r) for v in p], dtype=torch.int64)
        assert torch.equal(q, p.long() // R)
        f = wl * C + q
        jt = (p - q * R) * F + f
        t = torch.zeros((3, L, lanes), dtype=I16)
        s = torch.zeros((3, L, lanes), dtype=I16)
        t[:, :, :nA] = tflat[:, :, jt]
        s[:, :, :nA] = sflat[:, :, f]
        staged.append(dict(t=t, s=s, zero=c == 0, wl=wl, b0=b0, nA=nA))

    blocks = range(geo.blocks) if order is None else order
    for k in blocks:
        runs = list(range(k, geo.runs, geo.blocks))
        assert len(runs) <= geo.runs_per_block
        stage(runs[0])
        for i, run in enumerate(runs):
            st = staged.pop(0)
            p1, p2 = st["t"].to(I32), st["s"].to(I32)   # the lanes' copy
            if i + 1 < len(runs):
                stage(runs[i + 1])      # run k + 1 in flight during the adds
            nA = st["nA"]
            G = kernels.padd_batch_plain(p1[..., :nA], p2[..., :nA], curve)
            G[:, :, st["zero"]] = one[:, :, None]
            p_b = G[..., 1:]                             # lane l - 1's p
            q_b = G.clone()
            q_b[1] = kp4[:, None] - q_b[1]               # y -> 4p - y
            out = kernels.padd_batch_plain(p_b, q_b[..., :nA - 1], curve)
            w = g * Wg + st["wl"]
            buckets[:, :, w, st["b0"]:st["b0"] + nA - 1] = out.to(I16)
        assert not staged
    return buckets, geo


@pytest.mark.parametrize("Wg,n,s", [(1, 96, 8), (4, 64, 6), (2, 32, 10)])
def test_kernel_blocks_replayed(Wg, n, s):
    """Real inputs: B = 128 (3 full runs of 39 and one of 11), 32 (one
    run of 32) and 512 (13 runs and one of 5) buckets, with cnt == 0 and
    cnt == n lanes at run edges; a card of one SM of 2 blocks, so that a
    block walks several runs of several windows."""
    cfg = MSMConfig(curve=TINY62, window_size=s, columns=16, pbpr_threads=8,
                    subtask_group=Wg)
    Wp = cfg.padded_windows
    tbuf, S, cnt, C, R = stage3_inputs(cfg, n)
    cnt = cnt.clone()
    cnt[0, :41] = 0                     # the first run and the next halo
    cnt[Wg - 1, 37:40] = R * C
    got, geo = replay(tbuf, S, cnt, empty_buckets(cfg, Wp), 0, Wg, C, R,
                      TINY62, 1, 2)
    assert geo.runs_per_block > 1
    want = kernels.extract_buckets(tbuf, S, cnt, empty_buckets(cfg, Wp), 0,
                                   Wg, C, R, TINY62)
    assert torch.equal(got, want)


@pytest.mark.parametrize("Wg,B,C,R,curve", [
    (1, 40, 64, 4, TINY62), (2, 79, 32, 8, TINY62), (3, 39, 16, 5, TINY62),
    (1, 1, 8, 2, TINY62), (2, 118, 32, 3, BN254_S12)])
def test_kernel_runs_synthetic(Wg, B, C, R, curve):
    """Lazy limbs from a seed and sorted counts: a window whose last run is
    one bucket (B = 40, 79) or none (B = 39, 118: whole runs), B = 1;
    cnt == 0 at j = 0 .. 2 and cnt == n at the top; blocks in a shuffled
    order, each walking runs of several windows; the group g = 1."""
    rng = np.random.default_rng(B)
    L, F, Wp = curve.num_limbs, Wg * C, 2 * Wg
    lazy = lambda shape: torch.from_numpy(rng.integers(
        0, 1 << curve.log_limb_size, (3, L) + shape).astype(np.int16))
    tbuf, S = lazy((R, F)), lazy((F,))
    cnt = torch.from_numpy(np.sort(rng.integers(0, R * C + 1, (Wp, B + 1)),
                                   axis=1).astype(np.int32))
    cnt[:, :3] = 0
    cnt[:, -1] = R * C
    bk = torch.from_numpy(rng.integers(-9, 9, (3, L, Wp, B)).astype(np.int16))
    geo = kernels.extract_buckets_geometry(Wg, B, 1, 2, L,
                                           curve.log_limb_size)
    order = rng.permutation(geo.blocks).tolist()
    got, _ = replay(tbuf, S, cnt, bk.clone(), 1, Wg, C, R, curve, 1, 2,
                    order)
    want = kernels.extract_buckets_plain(tbuf, S, cnt, bk.clone(), 1, Wg, C,
                                         R, curve)
    assert torch.equal(got, want)


@pytest.mark.parametrize("L,w", [(22, 12), (21, 13), (32, 12), (30, 13),
                                 (6, 12)])
def test_geometry(L, w):
    for Wg, B, sms, per_sm in ((1, 1 << 15, 132, 3), (4, 1 << 12, 132, 3),
                               (16, 1 << 15, 132, 2), (1, 1, 132, 3),
                               (9, 1 << 15, 1, 1)):
        geo = kernels.extract_buckets_geometry(Wg, B, sms, per_sm, L, w)
        assert geo.lanes_per_block == 40 and geo.buckets_per_run == 39
        assert geo.threads == 32 * 9
        assert geo.runs_per_window == -(-B // 39)
        assert geo.runs == Wg * geo.runs_per_window
        # a persistent grid: the resident blocks, one wave, each block
        # its share of the runs
        assert geo.blocks == min(geo.runs, sms * per_sm)
        assert geo.waves == 1 and geo.blocks_per_sm == per_sm
        assert (geo.runs_per_block - 1) * geo.blocks < geo.runs
        assert geo.runs <= geo.runs_per_block * geo.blocks
        # the lanes' words, the staging of T and S, the constants
        assert geo.shared_bytes <= kernels.BLOCK_SHARED_BYTES
        assert geo.shared_bytes >= 4 * 40 * (15 * L + 1) + 2 * 2 * 3 * L * 40
    with pytest.raises(ValueError):
        kernels.extract_buckets_geometry(0, 4, 132, 3)
    with pytest.raises(ValueError):
        kernels.extract_buckets_geometry(1, 4, 132, 0)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 39, 106, 128, 841, 8192,
                               12345677, (1 << 31) - 1])
def test_fast_div(d):
    """csrc/extract_buckets.cu's division by a multiply and a shift, at
    the divisors it meets (R, the runs of a window) and the ends of its
    range, on dividends at the ends and from a seed."""
    m, s = kernels.fast_div(d)
    rng = np.random.default_rng(d)
    xs = [0, 1, d - 1, d, d + 1, 2 * d - 1, (1 << 31) - 2, (1 << 31) - 1]
    xs += rng.integers(0, 1 << 31, 3000).tolist()
    for x in xs:
        if 0 <= x < 1 << 31:
            assert (x * m) >> s == x // d, (x, d)
            assert x * m < 1 << 64              # the kernel's 64-bit product
    with pytest.raises(ValueError):
        kernels.fast_div(0)


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
