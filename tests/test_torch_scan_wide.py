"""The two kernels of stage 3 on the word-wide multiply, replayed in
Python: csrc/prefix_scan.cu's lane step and csrc/col_prefix.cu's levels,
and the launch geometry of col_prefix.

`ScanStep` runs one step of a prefix_scan lane as the kernel runs it on
the lane's shared words (`LaneMem`: the running point, the row with its
sign applied, the sums x1 + y1 and x2 + y2, six products, six operands,
each a segment of L | 1 words):
the two levels of six products, each `mul_words` of
tests/test_torch_mul_wide.py (csrc/mul_wide.cuh's multiply on 32-bit
words) on Field::pmadd's operands in its order, the adds between the
levels with the kernel's 2p and 4p offsets, G threads of a lane taking
products g, g + G, ... and limbs g, g + G, ..., and between two warp
barriers every word each thread reads and writes, failing on any word
that one thread writes and another touches. It must give
`rows.pmadd_rows` and the JAX package's `pmadd_rows` bit for bit on
TINY62, BN254_S12 and BLS12_377_S12, on lazy limbs at both ends of the
(-2^w, 2^(w+1)) ledger, infinity, P + P and P + (-P); `scan_replay`
walks whole lanes down their columns and must give `prefix_scan_plain`,
the Pallas kernel in interpret mode (TINY62) and the JAX rows chain
(BN254_S12).

`col_prefix_replay` runs col_prefix's levels as the kernel's blocks run
them, at the geometry `col_prefix_geometry` gives: a column a lane of
six threads, the lanes' points fetched row by row from int16 exchange
arrays (infinity where a shift leaves the window; level 0 reads the
input at c - 1 and c - 2), the running point kept in shared memory from
level to level where a lane holds one column and fetched again where it
holds several, the add in the four phases of csrc/padd_lane.cuh with
the race check of tests/test_torch_stage1_globalize.py, the sums stored
as int16 into the array the next level reads. It must give
`col_prefix_plain` and, on TINY62, the JAX `col_prefix` in interpret
mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm.ops import rows as jrows
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.ops import rows

from test_torch_mul_wide import Words, limbs, mul_words
from test_torch_scan_edges import (affine_multiples, col_inputs, mont_limbs,
                                   scan_by_pallas, scan_by_rows, scan_inputs)
from test_torch_stage1_globalize import Interval, Phases

torch.set_num_threads(1)

NAMES = ["tiny62", "bn254_s12", "bls12_377_s12"]
CURVES = {name: tc.CURVES[name] for name in NAMES}
JAX_CURVES = {name: jc.CURVES[name] for name in NAMES}


# ---------------------------------------------------------------------------
# prefix_scan: one step of a lane
# ---------------------------------------------------------------------------


class ScanStep:
    """csrc/scan_lane.cuh `pmadd_shared` (prefix_scan.cu's lane step),
    with the unpack of the row before it, on (words, lanes) int32 memory
    laid out as `LaneMem`.
    `run` takes the step's five warp barriers in order (after the
    unpack, after each of the four phases); those in `drop` are left out,
    to plant a race."""

    def __init__(self, curve, G):
        L = curve.num_limbs
        S = self.S = L | 1                    # a segment's words
        self.L, self.G, self.K = L, G, Words(curve)
        self.X1, self.Y1, self.Z1 = 0, S, 2 * S
        self.X2, self.Y2, self.U, self.V = 3 * S, 4 * S, 5 * S, 6 * S
        self.P, self.T, self.words = 7 * S, 13 * S, 19 * S
        kp = lambda k: limbs([k * curve.p], curve)
        self.kp2, self.kp4 = kp(2), kp(4)
        self.b3 = np.int32(3 * curve.b_coeff)
        self.b3m = limbs([curve.to_mont(3 * curve.b_coeff)], curve)
        self.one = limbs([curve.r_mod_p], curve)

    def load(self, p1: np.ndarray) -> np.ndarray:
        """Lane words with the running point (3, L, lanes) in place."""
        m = np.zeros((self.words, p1.shape[-1]), np.int32)
        for c, off in enumerate((self.X1, self.Y1, self.Z1)):
            m[off:off + self.L] = p1[c]
        return m

    def infinity(self, lanes: int) -> np.ndarray:
        m = np.zeros((self.words, lanes), np.int32)
        m[self.Y1:self.Y1 + self.L] = self.one
        return m

    def run(self, m, x2, y2, neg, drop=()):
        L, S, G, K = self.L, self.S, self.G, self.K
        seg = lambda off: m[off:off + L]
        iv = Interval({})

        def barrier(k):
            nonlocal iv
            if k not in drop:
                iv.check()                            # __syncwarp(mask)
                iv = Interval({})

        def by_limb(reads, writes):
            for g in range(G):
                for i in range(g, L, G):
                    for off in reads:
                        iv.read(g, off + i, 1)
                    for off in writes:
                        iv.write(g, off + i, 1)

        # the unpack: the row, y -> 2p - y where the sign is set, the sums
        m[self.X2:self.X2 + L] = x2
        m[self.Y2:self.Y2 + L] = np.where(neg, self.kp2 - y2, y2)
        m[self.U:self.U + L] = seg(self.X1) + seg(self.Y1)
        m[self.V:self.V + L] = seg(self.X2) + seg(self.Y2)
        by_limb([self.X1, self.Y1], [self.X2, self.Y2, self.U, self.V])
        barrier(0)
        # level 1: x1 x2, y1 y2, (x1 + y1)(x2 + y2), y2 z1, x2 z1, z1 b3m
        a = [self.X1, self.Y1, self.U, self.Y2, self.X2, self.Z1]
        b = [self.X2, self.Y2, self.V, self.Z1, self.Z1, None]
        for g in range(G):
            for j in range(g, 6, G):
                o = self.P + j * S
                iv.read(g, a[j], L)
                if b[j] is None:                      # b3m, a constant
                    bw = np.broadcast_to(self.b3m, seg(a[j]).shape)
                else:
                    iv.read(g, b[j], L)
                    bw = seg(b[j])
                m[o:o + L] = mul_words(seg(a[j]), bw, K)
                iv.write(g, o, L)
        barrier(1)
        # the adds: t3 t4 t1 yz z3 t0
        P = [seg(self.P + k * S).copy() for k in range(6)]
        T = [P[2] - (P[0] + P[1]) + self.kp4, P[3] + seg(self.Y1),
             P[1] - P[5] + self.kp2, (P[4] + seg(self.X1)) * self.b3,
             P[1] + P[5], P[0] * np.int32(3)]
        for k in range(6):
            m[self.T + k * S:self.T + k * S + L] = T[k]
        by_limb([self.P + k * S for k in range(6)] + [self.X1, self.Y1],
                [self.T + k * S for k in range(6)])
        barrier(2)
        # level 2: t3 t1, t4 yz, t1 z3, yz t0, z3 t4, t0 t3
        second = [2, 3, 4, 5, 1, 0]
        for g in range(G):
            for j in range(g, 6, G):
                ta, tb = self.T + j * S, self.T + second[j] * S
                iv.read(g, ta, L), iv.read(g, tb, L)
                m[self.P + j * S:self.P + j * S + L] = mul_words(
                    seg(ta), seg(tb), K)
                iv.write(g, self.P + j * S, L)
        barrier(3)
        # the sum into the running point
        P = [seg(self.P + k * S).copy() for k in range(6)]
        m[self.X1:self.X1 + L] = P[0] - P[1] + self.kp2
        m[self.Y1:self.Y1 + L] = P[2] + P[3]
        m[self.Z1:self.Z1 + L] = P[4] + P[5]
        by_limb([self.P + k * S for k in range(6)],
                [self.X1, self.Y1, self.Z1])
        barrier(4)                          # the next step's wait + barrier
        return np.stack([seg(self.X1), seg(self.Y1), seg(self.Z1)])


def lazy(curve, rng, shape):
    """Lazy limbs in the (-2^w, 2^(w+1)) ledger, three in ten at its two
    ends; the top limb small."""
    L, w = curve.num_limbs, curve.log_limb_size
    a = rng.integers(-(1 << w) + 1, 1 << (w + 1), shape)
    ends = rng.random(shape) < 0.3
    a = np.where(ends, np.where(rng.random(shape) < 0.5, -(1 << w) + 1,
                                (1 << (w + 1)) - 1), a)
    a[:, L - 1] = np.abs(a[:, L - 1]) % 8 + 1
    return a.astype(np.int32)


def step_inputs(curve, rng, n):
    """(p1 (3, L, n), x2, y2 (L, n), neg (n,)): lazy running points and
    rows, and in lanes 0 to 3 infinity + P, P + P, P + (-P) and
    P + (-P) by the sign bit, on real points."""
    L = curve.num_limbs
    p1 = lazy(curve, rng, (3, L, n))
    x2, y2 = lazy(curve, rng, (2, L, n))
    neg = rng.integers(0, 2, n).astype(bool)
    (ax, ay), (bx, by) = affine_multiples(curve, 2)
    mont = lambda v: np.array(mont_limbs(curve, v), np.int32)
    one = limbs([curve.r_mod_p], curve)[:, 0]
    p1[:, :, 0] = np.stack([0 * one, one, 0 * one])          # infinity
    x2[:, 0], y2[:, 0], neg[0] = mont(ax), mont(ay), False
    p1[:, :, 1] = np.stack([mont(bx), mont(by), one])         # P + P
    x2[:, 1], y2[:, 1], neg[1] = mont(bx), mont(by), False
    p1[:, :, 2] = np.stack([mont(ax), mont(ay), one])         # P + (-P)
    x2[:, 2], y2[:, 2], neg[2] = mont(ax), mont(curve.p - ay), False
    p1[:, :, 3] = np.stack([mont(bx), mont(by), one])         # by the sign
    x2[:, 3], y2[:, 3], neg[3] = mont(bx), mont(by), True
    return p1, x2, y2, neg


@pytest.mark.parametrize("G", tk.SCAN_THREADS_PER_LANE)
@pytest.mark.parametrize("name", NAMES)
def test_scan_step_is_pmadd_rows(name, G):
    """One step on the words, against the port's and the JAX package's
    pmadd_rows on the same running points and sign-applied rows."""
    curve = CURVES[name]
    n = 24
    p1, x2, y2, neg = step_inputs(curve, np.random.default_rng(3), n)
    step = ScanStep(curve, G)
    m = step.load(p1)
    got = step.run(m, x2, y2, neg)
    y = np.where(neg, limbs([2 * curve.p], curve) - y2, y2)
    t = torch.from_numpy
    want = rows.pmadd_rows(rows.ProjRows(*map(t, p1)), t(x2), t(y), curve)
    assert np.array_equal(got, torch.stack(tuple(want)).numpy())
    jw = jrows.pmadd_rows(jrows.ProjRows(*(jrows.from_stacked(jnp.asarray(c))
                                           for c in p1)),
                          jrows.from_stacked(jnp.asarray(x2)),
                          jrows.from_stacked(jnp.asarray(y)), JAX_CURVES[name])
    assert np.array_equal(got, np.asarray(jnp.stack(
        [jnp.stack(jw.x), jnp.stack(jw.y), jnp.stack(jw.z)])))
    # the lanes mean what they say: infinity + P is P, P + (-P) infinity
    val = lambda col: sum(int(v) << (curve.log_limb_size * i)
                          for i, v in enumerate(col)) % curve.p
    assert val(got[2, :, 0]) != 0 and val(got[2, :, 1]) != 0
    assert val(got[2, :, 2]) == 0 and val(got[2, :, 3]) == 0


@pytest.mark.parametrize("drop", [0, 1, 2, 3])
@pytest.mark.parametrize("G", tk.SCAN_THREADS_PER_LANE)
def test_scan_step_race_check_fires(G, drop):
    """Leave out one of the step's warp barriers and the check fails: a
    word one thread writes and another reads in the same interval."""
    curve = CURVES["tiny62"]
    p1, x2, y2, neg = step_inputs(curve, np.random.default_rng(5), 6)
    step = ScanStep(curve, G)
    m = step.load(p1)
    with pytest.raises(AssertionError):
        step.run(m, x2, y2, neg, drop=(drop,))


class RunStep(ScanStep):
    """The same step on csrc/scan_lane.cuh `RunMem`, the row walk's
    (csrc/smvp_rows.cu) 14 segments: T's six in the places of z1, the
    row, the two sums and one more, P after them."""

    def __init__(self, curve, G):
        super().__init__(curve, G)
        S = self.S
        self.Z1, self.X2, self.Y2, self.U, self.V = (2 * S, 3 * S, 4 * S,
                                                      5 * S, 6 * S)
        self.T, self.P, self.words = 2 * S, 8 * S, 14 * S


@pytest.mark.parametrize("G", tk.SCAN_THREADS_PER_LANE)
@pytest.mark.parametrize("name", NAMES)
def test_run_step_is_pmadd_rows(name, G):
    """The row walk's step on RunMem, whose T overlays words that level 1
    reads: the same sums as pmadd_rows, and no word that one thread
    writes is read by another between two barriers (the check of
    `run`)."""
    curve = CURVES[name]
    n = 24
    p1, x2, y2, neg = step_inputs(curve, np.random.default_rng(4), n)
    step = RunStep(curve, G)
    assert step.words == 14 * (curve.num_limbs | 1)
    got = step.run(step.load(p1), x2, y2, neg)
    y = np.where(neg, limbs([2 * curve.p], curve) - y2, y2)
    t = torch.from_numpy
    want = rows.pmadd_rows(rows.ProjRows(*map(t, p1)), t(x2), t(y), curve)
    assert np.array_equal(got, torch.stack(tuple(want)).numpy())
    # and two steps in a row, the second from the first's sum
    x3, y3 = np.roll(x2, 1, axis=1), np.roll(y2, 1, axis=1)
    m = step.load(p1)
    step.run(m, x2, y2, neg)
    got2 = step.run(m, x3, y3, neg)
    y3s = np.where(neg, limbs([2 * curve.p], curve) - y3, y3)
    want2 = rows.pmadd_rows(want, t(x3), t(y3s), curve)
    assert np.array_equal(got2, torch.stack(tuple(want2)).numpy())


@pytest.mark.parametrize("drop", [0, 1, 2, 3])
@pytest.mark.parametrize("G", tk.SCAN_THREADS_PER_LANE)
def test_run_step_race_check_fires(G, drop):
    """On RunMem too, leaving out one of the step's warp barriers fails
    the check."""
    curve = CURVES["tiny62"]
    p1, x2, y2, neg = step_inputs(curve, np.random.default_rng(6), 6)
    step = RunStep(curve, G)
    with pytest.raises(AssertionError):
        step.run(step.load(p1), x2, y2, neg, drop=(drop,))


def scan_replay(table: np.ndarray, pay: np.ndarray, curve, C: int,
                G: int) -> np.ndarray:
    """csrc/prefix_scan.cu on the (n, 2L) int16 table and (Wg, n) payload:
    every lane f = wl * C + c at once from infinity, step r reading
    payload c * R + r of window wl; returns (3, L, R, Wg * C) int16."""
    L = curve.num_limbs
    Wg, n = pay.shape
    R, F = n // C, Wg * C
    f = np.arange(F)
    wl, c = f // C, f % C
    step = ScanStep(curve, G)
    m = step.infinity(F)
    out = np.empty((3, L, R, F), np.int16)
    for r in range(R):
        v = pay[wl, c * R + r]
        row = table[v >> 1].astype(np.int32).T             # (2L, F)
        out[:, :, r] = step.run(m, row[:L], row[L:], (v & 1) != 0)
    return out


def ledger_table(curve, rng, n):
    """A (n, 2L) int16 row table with limbs at the ledger's ends."""
    x, y = lazy(curve, rng, (2, curve.num_limbs, n))
    return np.concatenate([x, y]).T.astype(np.int16).copy()


SCAN_CASES = [("twice_in_a_row", 2), ("negative_follows", 5),
              ("ledger_ends", 3)]


def scan_case(curve, case, R, Wg=2, C=3):
    if case == "ledger_ends":
        rng = np.random.default_rng(17)
        n = C * R
        table = ledger_table(curve, rng, n)
        pay = np.stack([(rng.permutation(n) << 1) | rng.integers(0, 2, n)
                        for _ in range(Wg)]).astype(np.int32)
        return None, None, pay, table
    return scan_inputs(curve, Wg, C, R, case)


@pytest.mark.parametrize("G", tk.SCAN_THREADS_PER_LANE)
@pytest.mark.parametrize("case,R", SCAN_CASES)
@pytest.mark.parametrize("name", NAMES)
def test_scan_replay_is_the_plain_version(name, case, R, G):
    """Whole lanes through infinity (P + (-P), and on from it), P + P and
    rows with limbs at the ledger's ends, against prefix_scan_plain."""
    curve = CURVES[name]
    _, _, pay, table = scan_case(curve, case, R)
    got = scan_replay(table, pay, curve, 3, G)
    want = tk.prefix_scan_plain(torch.from_numpy(table), torch.from_numpy(pay),
                                curve, 3)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("G", tk.SCAN_THREADS_PER_LANE)
def test_scan_replay_tiny_vs_pallas(G):
    """TINY62: against the JAX Pallas scan kernel in interpret mode."""
    J, T = jc.TINY62, tc.TINY62
    Wg, C, R = 2, 4, 4
    X, Y, pay, table = scan_inputs(T, Wg, C, R, "negative_follows")
    assert np.array_equal(scan_replay(table, pay, T, C, G),
                          scan_by_pallas(J, X, Y, pay, Wg, C, R))


def test_scan_replay_s12_vs_jax_pmadd_chain():
    """BN254_S12: against the JAX package's rows chain of pmadd_rows."""
    J, T = jc.BN254_S12, tc.BN254_S12
    Wg, C, R = 2, 3, 4
    X, Y, pay, table = scan_inputs(T, Wg, C, R, "twice_in_a_row")
    assert np.array_equal(scan_replay(table, pay, T, C, 6),
                          scan_by_rows(J, X, Y, pay, Wg, C, R))


# ---------------------------------------------------------------------------
# col_prefix: the levels on the shared add
# ---------------------------------------------------------------------------


def col_prefix_replay(coltot: np.ndarray, curve, geo,
                      drop=None) -> np.ndarray:
    """csrc/col_prefix.cu on (3, L, Wg, C) int16 column totals at launch
    geometry `geo` (a `ColPrefixGeometry`); `drop` names one of the add's
    three inner warp barriers to leave out. Returns (3, L, Wg, C) int16."""
    _, L, Wg, C = coltot.shape
    plane = Wg * C
    levels = max(C.bit_length() - 1, 1)
    span = geo.blocks * geo.lanes_per_block      # lanes of the grid
    own_one = plane <= span
    P1, S, P2 = 0, 3 * L, 9 * L                  # msm::PaddLane
    m = np.zeros((15 * L | 1, span), np.int32)
    one = limbs([curve.r_mod_p], curve)[:, 0]
    inf = np.concatenate([np.zeros(L, np.int32), one, np.zeros(L, np.int32)])
    ph = Phases(curve)
    src = coltot.reshape(3 * L, plane)
    out = np.empty((3 * L, plane), np.int16)
    scratch = np.empty_like(out)
    lane = np.arange(span)                       # block * lanes + l
    for lv in range(levels):
        k = 1 << lv
        dst = scratch if (levels - 1 - lv) & 1 else out
        off_cur, off_sh = (1, 2) if lv == 0 else (0, k)
        for base in range(0, plane, span):       # the blocks' rounds
            idx = lane + base
            live = idx < plane
            c = idx % C

            def fetch(off):
                at = np.clip(idx - off, 0, plane - 1)
                v = src[:, at].astype(np.int32)
                return np.where((c < off)[None], inf[:, None], v)

            if lv == 0 or not own_one:
                m[P1:P1 + 3 * L] = np.where(live, fetch(off_cur),
                                            m[P1:P1 + 3 * L])
            m[P2:P2 + 3 * L] = np.where(live, fetch(off_sh), m[P2:P2 + 3 * L])
            iv = Interval({})
            for phase in ("level1", "mid", "level2", "finish"):
                if phase == "level1":
                    ph.level1(m, iv, 0, P1, P2, S)
                elif phase == "finish":
                    ph.finish(m, iv, 0, S, P1)
                else:
                    getattr(ph, phase)(m, iv, 0, S)
                if phase != drop:
                    iv.check()                  # __syncwarp(mask)
                    iv = Interval({})
            dst[:, idx[live]] = m[P1:P1 + 3 * L, live].astype(np.int16)
        src = dst
    return out.reshape(3, L, Wg, C)


def geometry(Wg, C, sms, per_sm, curve):
    return tk.col_prefix_geometry(Wg, C, sms, per_sm, 64,
                                  tk.COL_PREFIX_THREADS_PER_LANE,
                                  curve.num_limbs, curve.log_limb_size)


def lazy_columns(curve, rng, Wg, C):
    """(3, L, Wg, C) int16 columns: lazy limbs at the ledger's ends,
    a quarter at infinity, an equal neighbour (a doubling) and a column
    followed by its negative."""
    a = lazy(curve, rng, (3, curve.num_limbs, Wg, C))
    inf = tk.inf_stacked(curve, ()).numpy()
    a = np.where(rng.random((Wg, C)) < 0.25, inf[:, :, None, None], a)
    if C >= 6:
        a[..., 3] = a[..., 2]
        a[..., 5] = tk.pneg_stacked(torch.from_numpy(a[..., 4]), curve).numpy()
    return a.astype(np.int16)


# (Wg, C, sms, blocks an SM): one column; C = 2; one lane a column over
# several blocks; more columns than resident lanes (2 and 10 a lane)
COL_SHAPES = [(1, 1, 132, 14), (2, 2, 132, 14), (3, 32, 132, 14),
              (3, 32, 2, 2), (2, 64, 1, 1)]


@pytest.mark.parametrize("Wg,C,sms,per_sm", COL_SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_col_prefix_replay_is_the_plain_version(name, Wg, C, sms, per_sm):
    curve = CURVES[name]
    ct = lazy_columns(curve, np.random.default_rng(Wg * 100 + C), Wg, C)
    geo = geometry(Wg, C, sms, per_sm, curve)
    got = col_prefix_replay(ct, curve, geo)
    want = tk.col_prefix_plain(torch.from_numpy(ct), curve)
    assert got.dtype == np.int16 and np.array_equal(got, want.numpy())


@pytest.mark.parametrize("case", ["Wg3_infinity", "Wg3_equal_neighbours",
                                  "Wg3_negative_follows"])
@pytest.mark.parametrize("sms,per_sm", [(132, 14), (1, 1)])
def test_col_prefix_replay_tiny_vs_pallas(case, sms, per_sm):
    """TINY62, real points: against the JAX col_prefix in interpret mode,
    with one column a lane and with every column on one block's lanes."""
    J, T = jc.TINY62, tc.TINY62
    ct = col_inputs(T, case)
    want = np.asarray(jk.col_prefix(jnp.asarray(ct), J))
    got = col_prefix_replay(ct, T, geometry(3, 8, sms, per_sm, T))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("drop", ["level1", "mid", "level2"])
def test_col_prefix_replay_race_check_fires(drop):
    curve = CURVES["tiny62"]
    ct = lazy_columns(curve, np.random.default_rng(1), 1, 8)
    with pytest.raises(AssertionError):
        col_prefix_replay(ct, curve, geometry(1, 8, 132, 14, curve), drop)


# ---------------------------------------------------------------------------
# col_prefix_geometry
# ---------------------------------------------------------------------------

# (Wg, C, sms, blocks an SM): the [edge] and main-path shapes of
# chip_smoke.py (2^16, 2^20, SCHEDULE), the [latency] windows, small cards
GEO_SHAPES = [(1, 1, 132, 14), (1, 2, 132, 14), (3, 32, 132, 14),
              (4, 2048, 132, 14), (5, 64, 132, 14), (1, 8192, 132, 14),
              (16, 8192, 132, 14), (16, 8192, 132, 1), (5, 8192, 7, 3),
              (3, 4, 1, 1), (1, 32, 132, 14)]


@pytest.mark.parametrize("Wg,C,sms,per_sm", GEO_SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_col_prefix_geometry_covers_and_fits(name, Wg, C, sms, per_sm):
    """Every column on exactly one lane, the busiest lane
    `columns_per_lane` columns, never more blocks than resident, no idle
    block unless the card holds more lanes than columns, the block's
    shared bytes under the 48 KB of static shared memory."""
    curve = CURVES[name]
    geo = geometry(Wg, C, sms, per_sm, curve)
    total = Wg * C
    assert geo.threads_per_lane == 6 and geo.columns_per_warp == 5
    assert geo.lanes_per_block == geo.warps * 5 and geo.threads == 64
    assert 1 <= geo.blocks <= sms * per_sm
    span = geo.blocks * geo.lanes_per_block
    owner = np.concatenate([np.arange(l, total, span) for l in range(span)])
    assert np.array_equal(np.sort(owner), np.arange(total))
    assert geo.columns_per_lane == len(range(0, total, span))
    assert (geo.blocks - 1) * geo.lanes_per_block < total
    L = curve.num_limbs
    assert geo.shared_bytes == 4 * (10 * (15 * L | 1)
                                    + tk._static_shared_words(
                                        L, curve.log_limb_size))
    assert geo.shared_bytes <= 48 * 1024


def test_col_prefix_geometry_main_shapes():
    """On 132 SMs at 14 resident blocks: 2^20 (8192 columns) one column a
    lane; SCHEDULE (131,072) several, every resident block launched."""
    one = geometry(1, 8192, 132, 14, CURVES["bn254_s12"])
    assert one.blocks == 820 and one.columns_per_lane == 1
    many = geometry(16, 8192, 132, 14, CURVES["bn254_s12"])
    assert many.blocks == 132 * 14 and many.columns_per_lane == 8


def test_col_prefix_movers_cover_each_element_once():
    """The block's movers (csrc/col_prefix.cu): element (row, lane ll)
    by thread ll + lanes * (row mod step), step = threads // lanes; every
    (row, lane) of a block moved by exactly one thread, at every count of
    live lanes."""
    geo = geometry(1, 8192, 132, 14, CURVES["bn254_s12"])
    lanes, threads = geo.lanes_per_block, geo.threads
    step = threads // lanes
    for L in (6, 22, 32):
        for nl in (1, 7, lanes):
            seen = np.zeros((3 * L, lanes), int)
            for t in range(threads):
                ll, r0 = t % lanes, t // lanes
                if r0 < step and ll < nl:
                    for row in range(r0, 3 * L, step):
                        seen[row, ll] += 1
            assert (seen[:, :nl] == 1).all() and not seen[:, nl:].any()


@pytest.mark.parametrize("args", [(0, 8, 132, 14, 64), (1, 0, 132, 14, 64),
                                  (1, 8, 0, 14, 64), (1, 8, 132, 0, 64),
                                  (1, 8, 132, 14, 48), (1, 8, 132, 14, 0)])
def test_col_prefix_geometry_refuses_bad_launches(args):
    with pytest.raises(ValueError):
        tk.col_prefix_geometry(*args)
    with pytest.raises(ValueError):
        tk.col_prefix_geometry(1, 8, 132, 14, 64, 0)


# ---------------------------------------------------------------------------
# prefix_scan_geometry's rule of threads per lane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [6, 21, 22, 30, 32])
def test_prefix_scan_rule_by_limbs(L):
    """G = 2 only at L <= 22 and only where G = 2's blocks come one to an
    SM while G = 6 needs four blocks on some SM (7,921 to 8,448 lanes on
    132 SMs); G = 6 at every lane count at L = 30 and 32, where the
    [scan-lanes] sweep found G = 6 level or faster once the lane's
    segments were padded."""
    for lanes in (1, 2048, 5632, 7920, 7921, 8192, 8448, 8449, 16384,
                  131072):
        G, blocks, per_block = tk.prefix_scan_geometry(lanes, 132,
                                                       num_limbs=L)
        band = 7921 <= lanes <= 8448
        assert G == (2 if band and L <= tk.SCAN_G2_MAX_LIMBS else 6)
        assert (blocks - 1) * per_block < lanes <= blocks * per_block
        if G == 2:
            assert blocks <= 132 < -(-lanes // 20) / 3
    with pytest.raises(ValueError):
        tk.prefix_scan_geometry(8192, 132, num_limbs=0)


@pytest.mark.parametrize("L", [6, 21, 22, 30, 32])
def test_scan_lane_segments_fall_on_distinct_banks(L):
    """The reason for segments of L | 1 words: at the same limb, the six
    threads of a lane at G = 6 read six different segments (level 1's a
    operands), and those fall on six different banks at every profile;
    with segments of L words they do not at L = 32."""
    S = L | 1
    a_ops = [0, 1, 5, 4, 3, 2]                # X1 Y1 U Y2 X2 Z1
    assert len({(k * S) % 32 for k in a_ops}) == 6
    if L == 32:
        assert len({(k * L) % 32 for k in a_ops}) == 1
