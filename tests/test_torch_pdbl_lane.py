"""The doubling kernel of csrc/pdbl_batch.cu, replayed in Python on the
words of the word-wide multiply, and its launch geometry.

`pdbl_replay` walks the kernel's blocks over F lanes as
`pdbl_batch_geometry` gives them: the row movers (every (row, lane)
element loaded and stored once, by threads that take consecutive lanes
of one row), the lane's shared words (the point, then DblScratch: P0..P4
and T0..T2), and the doubling of csrc/padd_lane.cuh `DblPhases` with the
G = 4 threads of a lane taking product g of levels 1 and 3 (thread 0
level 2's) and limbs g, g + G, ... of the adds, each product `mul_words` of
tests/test_torch_mul_wide.py. Between two warp barriers it records which
words each thread reads and writes (`Interval` of
tests/test_torch_stage1_globalize.py) and fails on any word that one
thread writes and another touches. It must give `pdbl_batch_plain` bit
for bit on TINY62 and BN254_S12 at F = 1, a warp's 8 lanes and one
either side, 16, 333 and 32,769 lanes, on 132 SMs and on 4, with
infinity lanes and limbs at both ends of the lazy ledger;
and the JAX package's doubling: the Pallas kernel in interpret mode on
TINY62, `tpu_msm.ops.complete.pdbl` on BN254_S12. No tolerance: every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm.ops.complete import ProjPoint, pdbl
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk

from test_torch_mul_wide import SHARED_MAX, Words, limbs, mul_words
from test_torch_stage1_globalize import Interval

torch.set_num_threads(1)

CURVES = {"tiny62": tc.TINY62, "bn254_s12": tc.BN254_S12}
JAX_CURVES = {"tiny62": jc.TINY62, "bn254_s12": jc.BN254_S12}
G = tk.PDBL_THREADS_PER_DOUBLING


class Doubling:
    """csrc/padd_lane.cuh `DblPhases` on one lane's words, (words, lanes)
    int32 memory: the point at 0 (x, y, z), P_k at 3 L + k L, T_k at
    8 L + k L. `run` takes the four warp barriers in order; those in
    `drop` are left out (to plant a race)."""

    def __init__(self, curve):
        L = curve.num_limbs
        self.L, self.K = L, Words(curve)
        self.b3m = limbs([curve.to_mont(3 * curve.b_coeff)], curve)
        self.kp6 = limbs([6 * curve.p], curve)

    def run(self, m, drop=()):
        L, K = self.L, self.K
        X, Y, Z = 0, L, 2 * L
        P = lambda k: 3 * L + k * L
        T = lambda k: 8 * L + k * L
        seg = lambda off: m[off:off + L]
        iv = Interval({})

        def barrier(k):
            nonlocal iv
            if k not in drop:
                iv.check()                            # __syncwarp
                iv = Interval({})

        def products(ops):
            for g in range(G):
                for j in range(g, len(ops), G):
                    a, b, o = ops[j]
                    iv.read(g, a, L), iv.read(g, b, L)
                    m[o:o + L] = mul_words(seg(a), seg(b), K)
                    iv.write(g, o, L)

        # level 1: y y, y z, z z, x y
        products([(Y, Y, P(0)), (Y, Z, P(1)), (Z, Z, P(2)), (X, Y, P(3))])
        barrier(0)
        # level 2, thread 0: (z z) b3m, b3m from the block's constants
        iv.read(0, P(2), L)
        m[P(4):P(4) + L] = mul_words(
            seg(P(2)), np.repeat(self.b3m, m.shape[1], axis=1), K)
        iv.write(0, P(4), L)
        barrier(1)
        # the adds, limb by limb
        a, e = seg(P(0)).copy(), seg(P(4)).copy()
        m[T(0):T(0) + L] = a * 8
        m[T(1):T(1) + L] = a - e * 3 + self.kp6
        m[T(2):T(2) + L] = a + e
        for g in range(G):
            for i in range(g, L, G):
                iv.read(g, P(0) + i, 1), iv.read(g, P(4) + i, 1)
                for k in range(3):
                    iv.write(g, T(k) + i, 1)
        barrier(2)
        # level 3 into the point's words and P0
        products([(P(4), T(0), Y), (P(1), T(0), Z), (T(1), T(2), P(0)),
                  (T(1), P(3), X)])
        barrier(3)
        # the sum, in place
        m[X:X + L] = seg(X) * 2
        m[Y:Y + L] = seg(Y) + seg(P(0))
        for g in range(G):
            for i in range(g, L, G):
                for r in (X + i, Y + i, P(0) + i):
                    iv.read(g, r, 1)
                iv.write(g, X + i, 1), iv.write(g, Y + i, 1)
        iv.check()                                    # __syncthreads


def pdbl_replay(p: np.ndarray, curve, sms: int = 132,
                drop=()) -> np.ndarray:
    """csrc/pdbl_batch.cu on (3, L, F) int32 points: every lane at once
    (they share their schedule)."""
    L, w = curve.num_limbs, curve.log_limb_size
    F = p.shape[-1]
    geo = tk.pdbl_batch_geometry(F, sms, L, w)
    lpb = geo.lanes_per_block
    assert geo.threads_per_doubling == G and geo.threads == lpb * G
    stride = 11 * L | 1
    rows = p.reshape(3 * L, F)
    m = np.zeros((stride, F), np.int32)           # lane f's words: column f
    out = np.zeros_like(rows)

    def movers(load: bool) -> None:
        """Thread t of each block moves lane t mod lpb of rows t div lpb,
        + G, ...: each element once, a row's lanes on consecutive
        threads."""
        seen = np.zeros((3 * L, F), np.int64)
        for t in range(geo.threads):
            ll, r0 = t % lpb, t // lpb
            f = np.arange(geo.blocks) * lpb + ll
            f = f[f < F]
            for row in range(r0, 3 * L, G):
                if load:
                    m[row, f] = rows[row, f]
                else:
                    out[row, f] = m[row, f]
                seen[row, f] += 1
        assert (seen == 1).all()

    movers(True)
    # lane l of a block is threads l G .. l G + G - 1: one warp
    for lane in range(lpb):
        assert (lane * G) // 32 == (lane * G + G - 1) // 32
    Doubling(curve).run(m, drop)
    movers(False)
    return out.reshape(3, L, F)


def lazy_points(curve, rng, F: int) -> np.ndarray:
    """(3, L, F) lazy points: limbs in (-2^w, 2^(w+1)), 30 % of them at
    either end of that ledger, the top limb small; lane 0 and every
    fifth lane at infinity; lanes 1 to 4, 6 and 7 with x = 0, 1, p - 1,
    p, 2p - 1 and 4p - 1 (y and z beside them below 4p) in canonical
    limbs."""
    L, w = curve.num_limbs, curve.log_limb_size
    a = rng.integers(-(1 << w) + 1, 1 << (w + 1), (3, L, F))
    ends = rng.random(a.shape) < 0.3
    a = np.where(ends, np.where(rng.random(a.shape) < 0.5, -(1 << w) + 1,
                                (1 << (w + 1)) - 1), a)
    a[:, L - 1] = np.abs(a[:, L - 1]) % 8 + 1
    p = curve.p
    for f, v in zip((1, 2, 3, 4, 6, 7), (0, 1, p - 1, p, 2 * p - 1,
                                          4 * p - 1)):
        if f < F:
            a[:, :, f] = limbs([v, (v + 7) % (4 * p), (3 * v) % (4 * p)],
                               curve).T
    a[..., ::5] = tk.inf_stacked(curve, ()).numpy()[..., None]
    return a.astype(np.int32)


def plain(p: np.ndarray, curve) -> np.ndarray:
    got = tk.pdbl_batch_plain(torch.from_numpy(p), curve)
    assert got.dtype == torch.int32
    return got.numpy()


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("F", [1, 7, 8, 9, 16, 333, 32_769])
@pytest.mark.parametrize("name", ["tiny62", "bn254_s12"])
def test_pdbl_replay_is_the_plain_version(name, F, sms):
    """F = 1, one warp's 8 lanes and one either side, the reduction
    path's 16, blocks of several warps (333 on 4 SMs) and the 2^20
    stand-in's 32,769."""
    curve = CURVES[name]
    p = lazy_points(curve, np.random.default_rng(F + sms), F)
    assert np.array_equal(pdbl_replay(p, curve, sms), plain(p, curve))


def test_pdbl_replay_tiny_vs_pallas():
    """The replay against the JAX package's Pallas kernel in interpret
    mode, on TINY62."""
    p = lazy_points(tc.TINY62, np.random.default_rng(21), 19)
    want = np.asarray(jk.pdbl_batch(jnp.asarray(p), jc.TINY62))
    assert np.array_equal(pdbl_replay(p, tc.TINY62), want)


def test_pdbl_replay_s12_vs_complete_pdbl():
    """The replay against `tpu_msm.ops.complete.pdbl` on BN254_S12."""
    p = lazy_points(tc.BN254_S12, np.random.default_rng(31), 17)
    jp = jnp.asarray(p)
    want = np.asarray(jnp.stack(tuple(pdbl(ProjPoint(jp[0], jp[1], jp[2]),
                                           jc.BN254_S12))))
    assert np.array_equal(pdbl_replay(p, tc.BN254_S12), want)


@pytest.mark.parametrize("drop", [0, 1, 2, 3])
def test_pdbl_replay_race_check_fires(drop):
    """Leave out one warp barrier and the check fails: a word written by
    one thread and read by another in the same interval."""
    curve = tc.TINY62
    p = lazy_points(curve, np.random.default_rng(5), 9)
    with pytest.raises(AssertionError):
        pdbl_replay(p, curve, drop=(drop,))


# ---------------------------------------------------------------------------
# pdbl_batch_geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("F", [1, 7, 8, 9, 16, 17, 528, 1_056, 1_057,
                               4_224, 32_769, 1 << 20])
@pytest.mark.parametrize("sms", [132, 4])
def test_pdbl_geometry_fits_and_covers(F, sms):
    for c in CURVES.values():
        geo = tk.pdbl_batch_geometry(F, sms, c.num_limbs, c.log_limb_size)
        per_warp = 32 // G
        assert geo.threads_per_doubling == G == 4
        assert 1 <= geo.warps <= tk.PDBL_MAX_WARPS
        assert geo.threads == 32 * geo.warps <= 1024
        assert geo.lanes_per_block == geo.warps * per_warp
        assert geo.shared_bytes <= SHARED_MAX
        # every lane in exactly one block, no empty block
        assert (geo.blocks - 1) * geo.lanes_per_block < F
        assert geo.blocks * geo.lanes_per_block >= F
        # the fewest warps a block that keep to one block an SM
        if geo.warps < tk.PDBL_MAX_WARPS:
            assert geo.blocks <= sms
        if geo.warps > 1:
            assert -(-F // ((geo.warps - 1) * per_warp)) > sms


def test_pdbl_geometry_spreads_the_reduction_paths_lanes():
    """16 lanes (`bucket_reduce` at 2^20): one warp a block, 2 blocks."""
    geo = tk.pdbl_batch_geometry(16, 132)
    assert (geo.threads_per_doubling, geo.warps, geo.blocks) == (4, 1, 2)


@pytest.mark.parametrize("args", [(0, 132), (8, 0), (8, 132, 0),
                                  (8, 132, 22, 0)])
def test_pdbl_geometry_refuses_bad_calls(args):
    with pytest.raises(ValueError):
        tk.pdbl_batch_geometry(*args)
