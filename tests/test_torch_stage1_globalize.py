"""The lane schedules of csrc/pbpr_stage1.cu and csrc/globalize.cu,
replayed in Python on the words of the word-wide multiply, and their
launch geometry.

`stage1_replay` runs a pbpr_stage1 lane as the kernel runs it: the
lane's shared words (m, g, two bucket buffers, the scratch of the m add
and of the g add), the bucket elements fetched as the kernel fetches
them (an int32 element as its own word, an int16 one as the 4-byte word
that holds it, unpacked by the parity of its index), the next bucket in
flight while a step computes, and the m add of step j beside the g add
of step j - 1, each in the four phases of csrc/padd_lane.cuh with its
six threads' products (`mul_words` of tests/test_torch_mul_wide.py) and
limbs. Between two warp barriers it records which words each thread
reads and writes, and which are in flight, and fails on any word that
one thread writes and another touches. It must give `pbpr_stage1_plain`
bit for bit on TINY62 and BN254_S12, int16 and int32 buckets, T = 1,
T = B and a middle T, with infinity buckets and limbs at the ledger's
ends. `globalize_replay` walks the padd kernel's blocks over the R F
positions as `padd_batch_geometry` gives them: the row movers, q read
from S at position mod F, the add of tests/test_torch_mul_wide.py
`padd_lane`, the stores."""

from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.ops.complete import ProjPoint, padd, proj_infinity
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk

from test_torch_mul_wide import Words, limbs, mul_words, padd_lane

torch.set_num_threads(1)

CURVES = {"tiny62": tc.TINY62, "bn254_s12": tc.BN254_S12}
G = tk.PBPR_STAGE1_THREADS_PER_CHAIN      # threads of an add
Q = 2 * G                                 # threads of a lane


# ---------------------------------------------------------------------------
# a warp's barrier intervals, with every word each thread touches
# ---------------------------------------------------------------------------


class Interval:
    """The accesses of the lane's threads between two warp barriers."""

    def __init__(self, inflight):
        self.reads = defaultdict(set)
        self.writes = defaultdict(set)
        # cp.async words in flight during the interval, by the thread that
        # issued them: no other thread may touch them
        self.inflight = {q: set(w) for q, w in inflight.items()}

    def read(self, q, lo, n):
        self.reads[q].update(range(lo, lo + n))

    def write(self, q, lo, n):
        self.writes[q].update(range(lo, lo + n))

    def check(self):
        threads = set(self.reads) | set(self.writes)
        for a in threads:
            for b in threads - {a}:
                clash = self.writes[a] & (self.reads[b] | self.writes[b])
                assert not clash, (a, b, sorted(clash)[:4])
        for owner, words in self.inflight.items():
            for b in threads - {owner}:
                clash = words & (self.reads[b] | self.writes[b])
                assert not clash, (owner, b, sorted(clash)[:4])


class Phases:
    """csrc/padd_lane.cuh `Phases` on (words, lanes) int32 memory: p1 and
    p2 at word offsets, the scratch at s (P at s, T at s + 6 L); thread g
    (0 .. G-1) of the add at thread index `base + g` of the lane."""

    def __init__(self, curve):
        L = curve.num_limbs
        self.L, self.K = L, Words(curve)
        kp = lambda k: limbs([k * curve.p], curve)[:, 0][:, None]
        self.kp2, self.kp4 = kp(2), kp(4)
        self.kpb3x2 = kp(2 * 3 * curve.b_coeff)
        self.b3 = np.int32(3 * curve.b_coeff)

    def level1(self, m, iv, base, p1, p2, s):
        L = self.L
        for g in range(G):
            q = base + g
            for j in range(g, 6, G):
                o = s + j * L
                if j < 3:
                    a, b = p1 + j * L, p2 + j * L
                    iv.read(q, a, L), iv.read(q, b, L)
                else:
                    u, v = (L if j == 4 else 0), (L if j == 3 else 2 * L)
                    t = s + 6 * L + j * L
                    for r in (p1 + u, p1 + v, p2 + u, p2 + v):
                        iv.read(q, r, L)
                    m[o:o + L] = m[p1 + u:p1 + u + L] + m[p1 + v:p1 + v + L]
                    m[t:t + L] = m[p2 + u:p2 + u + L] + m[p2 + v:p2 + v + L]
                    iv.write(q, t, L)
                    a, b = o, t
                m[o:o + L] = mul_words(m[a:a + L], m[b:b + L], self.K)
                iv.write(q, o, L)

    def mid(self, m, iv, base, s):
        L = self.L
        P = [m[s + k * L:s + (k + 1) * L].copy() for k in range(6)]
        t2 = P[2] * self.b3
        T = [P[3] - (P[0] + P[1]) + self.kp4, P[4] - (P[1] + P[2]) + self.kp4,
             P[1] - t2 + self.kpb3x2,
             (P[5] - (P[0] + P[2]) + self.kp4) * self.b3, P[1] + t2,
             P[0] * np.int32(3)]
        for k in range(6):
            m[s + 6 * L + k * L:s + 6 * L + (k + 1) * L] = T[k]
        for g in range(G):
            for i in range(g, L, G):
                for k in range(6):
                    iv.read(base + g, s + k * L + i, 1)
                    iv.write(base + g, s + 6 * L + k * L + i, 1)

    def level2(self, m, iv, base, s):
        L = self.L
        for g in range(G):
            for j in range(g, 6, G):
                b = j + 2 if j < 4 else 5 - j
                ta, tb = s + 6 * L + j * L, s + 6 * L + b * L
                iv.read(base + g, ta, L), iv.read(base + g, tb, L)
                m[s + j * L:s + (j + 1) * L] = mul_words(
                    m[ta:ta + L], m[tb:tb + L], self.K)
                iv.write(base + g, s + j * L, L)

    def finish(self, m, iv, base, s, out):
        L = self.L
        P = [m[s + k * L:s + (k + 1) * L].copy() for k in range(6)]
        m[out:out + L] = P[0] - P[1] + self.kp2
        m[out + L:out + 2 * L] = P[2] + P[3]
        m[out + 2 * L:out + 3 * L] = P[4] + P[5]
        for g in range(G):
            for i in range(g, L, G):
                for k in range(6):
                    iv.read(base + g, s + k * L + i, 1)
                for c in range(3):
                    iv.write(base + g, out + c * L + i, 1)


# ---------------------------------------------------------------------------
# pbpr_stage1
# ---------------------------------------------------------------------------


def stage1_replay(buckets: np.ndarray, curve, T: int):
    """csrc/pbpr_stage1.cu on (3, L, Wp, B) int16 or int32 buckets: every
    lane at once (they share their schedule), returns (m, g) as
    (3, L, Wp, T) int32."""
    _, L, Wp, B = buckets.shape
    Bt = B // T
    M_, G_, BK = 0, 3 * L, 6 * L                     # csrc LaneMem
    SM, SG = 12 * L, 24 * L
    words = 36 * L
    plane = Wp * B
    f = np.arange(Wp * T)
    top = (f // T) * B + (f % T) * Bt + Bt - 1       # per lane
    flat = np.ascontiguousarray(buckets).reshape(-1)
    as_words = flat.view(np.int32)                    # little-endian words
    small = flat.dtype == np.int16
    ph = Phases(curve)
    m = np.zeros((words, Wp * T), np.int32)
    one = limbs([curve.r_mod_p], curve)[:, 0]

    def fetch(e):                                     # the word for element e
        return as_words[e >> 1] if small else as_words[e]

    def unpack(v, e):
        if not small:
            return v
        hi = (v >> 16).astype(np.int16)
        lo = (v & 0xFFFF).astype(np.uint16).view(np.int16)
        return np.where(e & 1, hi, lo).astype(np.int32)

    inflight = {}
    iv = Interval(inflight)
    for q in range(Q):                                # m = g = infinity
        for i in range(q, L, Q):
            for base in (M_, G_):
                m[base + i] = 0
                m[base + L + i] = one[i]
                m[base + 2 * L + i] = 0
                for c in range(3):
                    iv.write(q, base + c * L + i, 1)
    pending = {}                                      # word -> fetched value
    for q in range(Q):                                # bucket 0 in flight
        for k in range(q, 3 * L, Q):
            pending[BK + k] = fetch(k * plane + top)
        inflight[q] = {BK + k for k in range(q, 3 * L, Q)}
    for j in range(Bt + 1):
        bk = BK + (j & 1) * 3 * L
        if j < Bt:
            for q in range(Q):
                iv.inflight.setdefault(q, set()).update(inflight.get(q, ()))
                inflight.pop(q, None)                 # cp.async.wait_all
                for k in range(q, 3 * L, Q):
                    m[bk + k] = unpack(pending.pop(bk + k), k * plane + top - j)
                    iv.read(q, bk + k, 1), iv.write(q, bk + k, 1)
                if j + 1 < Bt:
                    nxt = BK + ((j + 1) & 1) * 3 * L
                    for k in range(q, 3 * L, Q):
                        pending[nxt + k] = fetch(k * plane + top - j - 1)
                    inflight[q] = {nxt + k for k in range(q, 3 * L, Q)}
                    iv.inflight.setdefault(q, set()).update(inflight[q])
        iv.check()                                    # __syncwarp
        # (chain base thread, its accumulator, p2, its scratch)
        on = [(0, M_, bk, SM)] if j < Bt else []
        on += [(G, G_, M_, SG)] if j > 0 else []
        for step in ("level1", "mid", "level2"):
            iv = Interval(inflight)
            for base, acc, p2, s in on:
                if step == "level1":
                    ph.level1(m, iv, base, acc, p2, s)
                else:
                    getattr(ph, step)(m, iv, base, s)
            iv.check()                                # __syncwarp
        iv = Interval(inflight)
        for base, acc, _, s in on:
            ph.finish(m, iv, base, s, acc)
    iv.check()
    assert not pending and not any(inflight.values())
    out = lambda base: m[base:base + 3 * L].reshape(3, L, Wp, T)
    return out(M_), out(G_)


def lazy_buckets(curve, rng, Wp, B, dtype):
    """Lazy (3, L, Wp, B) buckets with limbs at both ends of the
    (-2^w, 2^(w+1)) ledger, and some buckets at infinity."""
    L, w = curve.num_limbs, curve.log_limb_size
    a = rng.integers(-(1 << w) + 1, 1 << (w + 1), (3, L, Wp, B))
    ends = rng.random(a.shape) < 0.3
    a = np.where(ends, np.where(rng.random(a.shape) < 0.5, -(1 << w) + 1,
                                (1 << (w + 1)) - 1), a)
    a[:, L - 1] = np.abs(a[:, L - 1]) % 8 + 1
    inf = tk.inf_stacked(curve, ()).numpy()
    kill = rng.random((Wp, B)) < 0.25
    a = np.where(kill, inf[:, :, None, None], a)
    return a.astype(dtype)


STAGE1_SHAPES = [(3, 8, 1), (2, 8, 8), (2, 16, 4)]     # T = 1, T = B, middle


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("Wp,B,T", STAGE1_SHAPES)
@pytest.mark.parametrize("name", ["tiny62", "bn254_s12"])
def test_stage1_replay_is_the_plain_version(name, Wp, B, T, dtype):
    curve = CURVES[name]
    b = lazy_buckets(curve, np.random.default_rng(B * 10 + T), Wp, B, dtype)
    Bt = B // T
    if Bt >= 3:                       # P + P in the m chain and the g chain
        top = np.arange(T) * Bt + Bt - 1
        b[..., top - 2] = b[..., top]
    m, g = stage1_replay(b, curve, T)
    pm, pg = tk.pbpr_stage1_plain(torch.from_numpy(b), curve, T)
    assert np.array_equal(m, pm.numpy()) and np.array_equal(g, pg.numpy())


def test_stage1_replay_vs_jax_padd_loop():
    """The replay against the JAX package's loop of ops.complete.padd (as
    tests/test_pallas.py runs it) on BN254_S12."""
    C = jc.BN254_S12
    Wp, B, T = 2, 8, 2
    Bt = B // T
    b = lazy_buckets(tc.BN254_S12, np.random.default_rng(9), Wp, B, np.int16)
    jb = jnp.asarray(b.astype(np.int32))
    mw = gw = proj_infinity(C, (Wp, T))
    for j in range(Bt):
        idx = jnp.arange(T) * Bt + (Bt - 1 - j)
        mw = padd(mw, ProjPoint(jb[0][:, :, idx], jb[1][:, :, idx],
                                jb[2][:, :, idx]), C)
        gw = padd(gw, mw, C)
    m, g = stage1_replay(b, tc.BN254_S12, T)
    assert np.array_equal(m, np.asarray(jnp.stack(mw)))
    assert np.array_equal(g, np.asarray(jnp.stack(gw)))


def test_stage1_replay_finds_a_race():
    """The replay's check is live: a lane whose g add reads m in the
    interval where the m add writes it fails."""
    iv = Interval({})
    iv.read(G, 0, 4)
    iv.write(0, 2, 1)
    with pytest.raises(AssertionError):
        iv.check()
    iv = Interval({3: {7}})
    iv.read(5, 7, 1)
    with pytest.raises(AssertionError):
        iv.check()


# ---------------------------------------------------------------------------
# pbpr_stage1_geometry
# ---------------------------------------------------------------------------

# (Wp, B, T): 2^20 and 2^16 without and with GLV, the [edge] and
# [latency] shapes of chip_smoke.py, and a lane count above one wave
GEOMETRY_SHAPES = [(16, 32768, 512), (20, 4096, 256), (9, 32768, 512),
                   (12, 4096, 256), (3, 64, 1), (16, 512, 512), (7, 96, 32),
                   (1, 256, 8), (1, 2048, 8), (16, 32768, 2048),
                   (64, 32768, 512)]


@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("Wp,B,T", GEOMETRY_SHAPES)
def test_stage1_geometry_covers_and_fits(Wp, B, T, sms):
    for c in CURVES.values():
        L = c.num_limbs
        geo = tk.pbpr_stage1_geometry(Wp, B, T, sms, L, c.log_limb_size)
        assert geo.threads_per_chain == G == 6 and geo.lanes_per_warp == 2
        assert 1 <= geo.warps <= tk.PBPR_STAGE1_MAX_WARPS
        assert geo.threads == 32 * geo.warps
        assert geo.lanes_per_block == geo.warps * geo.lanes_per_warp
        # the kernel's lane index of each active thread: every lane once,
        # by Q threads
        blk, tid = np.divmod(np.arange(geo.blocks * geo.threads),
                             geo.threads)
        lw = (tid & 31) // Q
        f = blk * geo.lanes_per_block + (tid >> 5) * 2 + lw
        f = f[(lw < 2) & (f < Wp * T)]
        assert np.array_equal(np.bincount(f, minlength=Wp * T),
                              np.full(Wp * T, Q))
        # shared memory: the lanes' words and the constants
        bits = L * c.log_limb_size
        static = 8 * L + 3 + bits // 32 + 1 + -(-bits // 32)
        assert geo.shared_bytes == 4 * (geo.lanes_per_block * (36 * L + 1)
                                        + static)
        assert geo.shared_bytes <= tk.BLOCK_SHARED_BYTES == 232_448
        # what an SM holds, and the waves that follow
        per = geo.blocks_per_sm
        assert per >= 1
        assert per * (geo.shared_bytes + 1024) <= tk.SM_SHARED_BYTES
        assert per * geo.threads * tk.PBPR_STAGE1_REGISTERS <= 65_536
        assert per <= 32 and per * geo.warps <= 64
        assert geo.waves == -(-geo.blocks // (sms * per))
        # no fewer waves with other warps a block; the fewest warps among
        # the launches of as few waves
        for warps in range(1, tk.PBPR_STAGE1_MAX_WARPS + 1):
            lpb = 2 * warps
            shared = 4 * (lpb * (36 * L + 1) + static)
            p = min(32, 64 // warps, 65_536 // (64 * 32 * warps),
                    tk.SM_SHARED_BYTES // (shared + 1024))
            blocks = -(-Wp * T // lpb)
            waves = -(-blocks // (sms * p))
            assert waves >= geo.waves
            if warps < geo.warps:
                assert waves > geo.waves


def test_stage1_geometry_one_wave_at_the_main_shapes():
    """The 8,192 lanes at 2^20 and 5,120 at 2^16 are resident at once on
    132 SMs."""
    for shape in ((16, 32768, 512), (20, 4096, 256)):
        assert tk.pbpr_stage1_geometry(*shape, 132).waves == 1


def test_stage1_store_movers_cover_each_row_once():
    """The block's stores: element (row, lane) of m and g by exactly one
    thread, for every block shape the geometry picks."""
    L = tc.BN254_S12.num_limbs
    for Wp, B, T in GEOMETRY_SHAPES[:9]:
        geo = tk.pbpr_stage1_geometry(Wp, B, T, 132)
        lpb, n = geo.lanes_per_block, Wp * T
        for blk in {0, geo.blocks - 1}:
            nl = min(n - blk * lpb, lpb)
            seen = []
            rstep = geo.threads // lpb
            for tid in range(geo.threads):
                ll, r0 = tid % lpb, tid // lpb
                if r0 < rstep and ll < nl:
                    seen += [(row, ll) for row in range(r0, 6 * L, rstep)]
            assert sorted(seen) == [(r, x) for r in range(6 * L)
                                    for x in range(nl)]


def test_stage1_geometry_refuses_bad_launches():
    for args in ((0, 8, 8, 132), (2, 8, 3, 132), (2, 8, 8, 0),
                 (2, 0, 1, 132)):
        with pytest.raises(ValueError):
            tk.pbpr_stage1_geometry(*args)
    with pytest.raises(ValueError):           # a lane over a block's memory
        tk.pbpr_stage1_geometry(1, 8, 8, 132, num_limbs=1700)


# ---------------------------------------------------------------------------
# globalize
# ---------------------------------------------------------------------------


def globalize_replay(tbuf: np.ndarray, s: np.ndarray, curve, out_dtype):
    """csrc/globalize.cu over (3, L, R, F) T and (3, L, F) S: the blocks
    of `padd_batch_geometry` over the n = R F positions, each mover
    thread's loads (T at its position, S at position mod F) and stores,
    the add of each lane (tests/test_torch_mul_wide.py `padd_lane`).
    Returns the output and, for every position, the S lane it read."""
    _, L, R, F = tbuf.shape
    n = R * F
    geo = tk.padd_batch_geometry(n, 132, L, curve.log_limb_size)
    t_rows = tbuf.reshape(3 * L, n)
    s_rows = s.reshape(3 * L, F)
    p = np.zeros((3 * L, n), tbuf.dtype)
    q = np.zeros((3 * L, n), tbuf.dtype)
    s_lane = np.full(n, -1)
    lpb = geo.lanes_per_block
    rstep = geo.threads // lpb
    for blk in range(geo.blocks):
        f0 = blk * lpb
        nl = min(n - f0, lpb)
        for tid in range(geo.threads):
            ll, r0 = tid % lpb, tid // lpb
            if r0 >= rstep or ll >= nl:
                continue
            f = f0 + ll
            fq = (f & 0xFFFFFFFF) % F                  # in 32 bits
            for row in range(r0, 3 * L, rstep):
                p[row, f] = t_rows[row, f]
                q[row, f] = s_rows[row, fq]
            s_lane[f] = fq
    out = padd_lane(p.reshape(3, L, n), q.reshape(3, L, n), curve, False,
                    tbuf.dtype)
    return out.reshape(3, L, R, F).astype(out_dtype), s_lane


GLOBALIZE_SHAPES = [(3, 1), (1, 37), (5, 333), (2, 20), (4, 41)]
TORCH_DTYPES = {np.int16: torch.int16, np.int32: torch.int32}


@pytest.mark.parametrize("R,F", GLOBALIZE_SHAPES)
@pytest.mark.parametrize("name", ["tiny62", "bn254_s12"])
def test_globalize_replay_is_the_plain_version(name, R, F):
    """All four dtype pairs; S = T's first row (P + P), its negative
    (P + (-P)) and infinity at S's first three lanes; S read at position
    mod F, also where F is no multiple of a block's 20 lanes."""
    curve = CURVES[name]
    rng = np.random.default_rng(R * 100 + F)
    L, w = curve.num_limbs, curve.log_limb_size
    tb = rng.integers(-(1 << w) + 1, 1 << (w + 1), (3, L, R, F))
    tb[:, L - 1] = np.abs(tb[:, L - 1]) % 8 + 1
    s = rng.integers(-(1 << w) + 1, 1 << (w + 1), (3, L, F))
    s[:, L - 1] = np.abs(s[:, L - 1]) % 8 + 1
    s[..., 0] = tb[:, :, 0, 0]
    if F > 2:
        s[..., 1] = tk.pneg_stacked(torch.from_numpy(tb[:, :, 0, 1]),
                                    curve).numpy()
        s[..., 2] = tk.inf_stacked(curve, ()).numpy()
    for dt_in in (np.int16, np.int32):
        for dt_out in (np.int16, np.int32):
            a, b = tb.astype(dt_in), s.astype(dt_in)
            got, lane = globalize_replay(a, b, curve, dt_out)
            want = tk.globalize_plain(torch.from_numpy(a), torch.from_numpy(b),
                                      curve, TORCH_DTYPES[dt_out])
            assert np.array_equal(got, want.numpy())
            assert np.array_equal(lane, np.arange(R * F) % F)


def test_globalize_geometry_is_padd_batch_over_the_positions():
    """At the 2^20 shapes (R = 128, F = 8,192): 52,429 blocks of four
    warps, 20 lanes each, about 50 waves of the 1,056 that 132 SMs hold
    at 8 blocks an SM."""
    geo = tk.padd_batch_geometry(128 * 8192, 132)
    assert (geo.warps, geo.lanes_per_block, geo.blocks) == (4, 20, 52_429)
    assert geo.shared_bytes <= 232_448
    assert 49 <= geo.blocks / (132 * 8) <= 50


def test_globalize_refuses_bad_inputs():
    C = tc.TINY62
    t = torch.zeros((3, 6, 2, 5), dtype=torch.int16)
    with pytest.raises(ValueError):
        tk.globalize(t, torch.zeros((3, 6, 4), dtype=torch.int16), C)
    with pytest.raises(ValueError):
        tk.globalize(t, torch.zeros((3, 6, 5), dtype=torch.int32), C)
