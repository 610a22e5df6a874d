"""pbpr_full's CUDA kernel (csrc/pbpr_full.cu) replayed in Python on the
words of the word-wide multiply, against its plain version and the JAX
package.

`pbpr_replay` runs the kernel as it runs on the card:
  - stage 1 is the lanes of csrc/pbpr_lane.cuh, which pbpr_stage1.cu runs
    too: `stage1_replay` of tests/test_torch_stage1_globalize.py (the
    m add and the g add at once, six threads each, the bucket words in
    flight, every thread's reads and writes checked between warp
    barriers), then the block's row movers as `pbpr_stage1_geometry`
    places them, m and g stored as int16 to half 0 and half 1 of the
    first exchange array, every element once;
  - each scan level from the table the wrapper hands the kernel
    (`kernels._pbpr_levels`), every add a chain of six threads: the two
    points loaded limb g, g + 6, ... by thread g (infinity past the end
    and where the mask reads, on phase B's first level), the add of
    csrc/padd_lane.cuh in four phases (`Phases` of
    tests/test_torch_stage1_globalize.py, each product `mul_words` of
    tests/test_torch_mul_wide.py), each thread storing the limbs it
    summed, as int16, to the other exchange array (the second one
    starts as noise, so a sum read before it is written would show);
  - the tail, one chain a window: m lane 0 doubled log2(B / T) times on
    four of its threads (`Doubling` of tests/test_torch_pdbl_lane.py),
    then the add of g lane 0.
Between two warp barriers it records the words each thread reads and
writes (`Interval`) and fails on a word that one thread writes and
another touches; a barrier left out (a planted race) must fail. It must
give `pbpr_full_plain` bit for bit on TINY62 and BN254_S12 at T = 1,
T = B, T above 512 and scans several levels deep, on lazy buckets with
limbs at both ends of the ledger and infinity buckets; the JAX Pallas
kernel in interpret mode on TINY62 bit for bit; and the JAX package's
non-Pallas reduction (`tpu_msm.cuzk.pbpr.bucket_reduce`, another order of
adds) on BN254_S12 by group value, on real points written with limbs at
the ledger's ends. No tolerance: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import kernels as jk
from tpu_msm.cuzk import pbpr as jpbpr
from tpu_msm.ops.complete import ProjPoint
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import planar_signed_to_ints_modp

from test_torch_pbpr import mont_buckets
from test_torch_pbpr_schedule import level_items
from test_torch_pdbl_lane import Doubling
from test_torch_stage1_globalize import (Interval, Phases, lazy_buckets,
                                         stage1_replay)

torch.set_num_threads(1)

CURVES = {"tiny62": tc.TINY62, "bn254_s12": tc.BN254_S12}
G = tk.PBPR_STAGE1_THREADS_PER_CHAIN        # kAddG: threads of an add
# barriers of a scan add, in order (csrc/pbpr_full.cu scan_add)
BARRIERS = ("load", "level1", "mid", "level2")


def replay_stage1(buckets: np.ndarray, curve, T: int) -> np.ndarray:
    """Stage 1 of the kernel: the lanes, then the stores of m and g as
    int16 (m_out = the array, g_out = the array + Wp T, rows 2 Wp T
    apart), every element of the first exchange array once."""
    _, L, Wp, B = buckets.shape
    m, g = stage1_replay(buckets, curve, T)
    n = Wp * T
    geo = tk.pbpr_stage1_geometry(Wp, B, T, 132, L, curve.log_limb_size)
    lpb = geo.lanes_per_block
    rstep = geo.threads // lpb
    lanes = np.concatenate([m.reshape(3 * L, n), g.reshape(3 * L, n)])
    flat = np.zeros(3 * L * 2 * n, np.int16)
    seen = np.zeros(flat.shape, np.int64)
    for tid in range(geo.threads):
        ll, r0 = tid % lpb, tid // lpb
        if r0 >= rstep:
            continue
        f = np.arange(geo.blocks) * lpb + ll
        f = f[f < n]
        for r in range(r0, 6 * L, rstep):
            idx = (r % (3 * L)) * 2 * n + (n if r >= 3 * L else 0) + f
            flat[idx] = lanes[r, f].astype(np.int16)
            seen[idx] += 1
    assert (seen == 1).all()
    return flat.reshape(3 * L, 2 * n)


def load(iv: Interval, L: int, at: int) -> None:
    """Thread g loads limbs g, g + G, ... of each coordinate at `at`."""
    for q in range(G):
        for i in range(q, L, G):
            for c in range(3):
                iv.write(q, at + c * L + i, 1)


def store(iv: Interval, L: int, at: int) -> None:
    for q in range(G):
        for i in range(q, L, G):
            for c in range(3):
                iv.read(q, at + c * L + i, 1)


class Chain:
    """The words of an add (msm::PaddLane: P1, then the scratch with P2 in
    its T) for a batch of adds, and the add's phases with every barrier
    but those in `drop`."""

    def __init__(self, curve, n: int, drop=()):
        L = self.L = curve.num_limbs
        self.P1, self.S, self.P2 = 0, 3 * L, 9 * L
        self.m = np.zeros((15 * L, n), np.int32)
        self.ph = Phases(curve)
        self.drop = set(drop)
        self.iv = Interval({})

    def barrier(self, name: str) -> None:
        if name not in self.drop:
            self.iv.check()                        # __syncwarp
            self.iv = Interval({})

    def add(self) -> None:
        """Level 1 to finish; the sum in P1, its limbs g, g + G, ... of
        each coordinate written by thread g."""
        m, ph = self.m, self.ph
        ph.level1(m, self.iv, 0, self.P1, self.P2, self.S)
        self.barrier("level1")
        ph.mid(m, self.iv, 0, self.S)
        self.barrier("mid")
        ph.level2(m, self.iv, 0, self.S)
        self.barrier("level2")
        ph.finish(m, self.iv, 0, self.S, self.P1)


def pbpr_replay(buckets: np.ndarray, curve, T: int, drop=()) -> np.ndarray:
    """csrc/pbpr_full.cu on (3, L, Wp, B) int16 buckets: (3, L, Wp) int32."""
    _, L, Wp, B = buckets.shape
    plane = 2 * Wp * T
    noise = np.random.default_rng(5).integers(-2000, 2000, (3 * L, plane))
    arrays = [replay_stage1(buckets, curve, T), noise.astype(np.int16)]
    inf = tk.inf_stacked(curve, (1,)).numpy().reshape(3 * L, 1)
    levels = tk._pbpr_levels(T, torch.device("cpu")).reshape(-1, 3).tolist()
    bits = len(levels) // 2
    assert len(levels) == 2 * bits

    def read(src, f, at_inf):
        p = src[:, np.minimum(f, plane - 1)].astype(np.int32)
        return np.where(at_inf, inf, p)

    for lv, (k, sm, sg) in enumerate(levels):
        src, dst = arrays[lv & 1], arrays[(lv + 1) & 1]
        masked = 2 * lv == len(levels)             # phase B's first level
        h, w, t = level_items(Wp, T, sm, sg)
        f = (h * Wp + w) * T + t
        c = Chain(curve, len(f), drop)
        c.m[c.P1:c.P1 + 3 * L] = read(src, f, masked & ((h == 0) == (t == 0)))
        c.m[c.P2:c.P2 + 3 * L] = read(src, f + k,
                                      (t + k >= T) | (masked & (h == 1)))
        load(c.iv, L, c.P1)
        load(c.iv, L, c.P2)
        c.barrier("load")
        c.add()
        store(c.iv, L, c.P1)
        dst[:, f] = c.m[c.P1:c.P1 + 3 * L].astype(np.int16)
        # no barrier before the chain's next add: its loads join this
        # interval
        load(c.iv, L, c.P1)
        load(c.iv, L, c.P2)
        c.iv.check()
    # the tail: after an even number of levels the sums are in array 0
    src = arrays[0]
    w = np.arange(Wp)
    c = Chain(curve, Wp, drop)
    c.m[c.P1:c.P1 + 3 * L] = read(src, w * T, np.full(Wp, bits == 0))
    load(c.iv, L, c.P1)
    c.barrier("load")
    dbl = Doubling(curve)
    for _ in range(max((B // T).bit_length() - 1, 0)):
        dbl.run(c.m, drop=({1} if "doubling" in c.drop else ()))
    c.m[c.P2:c.P2 + 3 * L] = read(src, (Wp + w) * T, np.zeros(Wp, bool))
    load(c.iv, L, c.P2)
    c.barrier("load")
    c.add()
    store(c.iv, L, c.P1)
    c.iv.check()
    return c.m[c.P1:c.P1 + 3 * L].reshape(3, L, Wp)


def ledger_buckets(curve, Wp: int, B: int, seed: int) -> np.ndarray:
    """Lazy int16 buckets with limbs at both ends of the ledger and a
    quarter at infinity."""
    return lazy_buckets(curve, np.random.default_rng(seed), Wp, B, np.int16)


# (Wp, B, T): T = 1 (no scan level, the mask read by the tail), T = B (no
# doubling), a middle T, scans three levels deep over three windows, and
# T above 512 (one block a window of the kernel's first form)
SHAPES = [(2, 8, 1), (2, 8, 8), (1, 16, 4), (3, 64, 8), (1, 1024, 1024)]


@pytest.mark.parametrize("Wp,B,T", SHAPES)
@pytest.mark.parametrize("name", sorted(CURVES))
def test_pbpr_replay_is_the_plain_version(name, Wp, B, T):
    curve = CURVES[name]
    b = ledger_buckets(curve, Wp, B, seed=B * 10 + T)
    got = pbpr_replay(b, curve, T)
    want = tk.pbpr_full_plain(torch.from_numpy(b), curve, T)
    assert got.dtype == np.int32 and np.array_equal(got, want.numpy())
    assert torch.equal(tk.pbpr_full(torch.from_numpy(b), curve, T), want)


@pytest.mark.parametrize("Wp,B,T", [(2, 8, 1), (1, 16, 16), (1, 1024, 1024)])
def test_pbpr_replay_vs_pallas_tiny(Wp, B, T):
    """Against the JAX Pallas kernel in interpret mode (about 30 s a
    shape, its compile)."""
    b = ledger_buckets(tc.TINY62, Wp, B, seed=3 * B + T)
    want = np.asarray(jk.pbpr_full(jnp.asarray(b), jc.TINY62, T))
    assert np.array_equal(pbpr_replay(b, tc.TINY62, T), want)


def spread_to_ledger_ends(b: np.ndarray, curve, rng) -> np.ndarray:
    """The same values with limbs moved to the ledger's ends: limb i takes
    2^w from limb i + 1 (limb i in [2^w, 2^(w+1)), limb i + 1 one less,
    down to -1), at random limbs below the top one."""
    w = curve.log_limb_size
    out = b.astype(np.int32).copy()
    L = out.shape[1]
    for i in range(0, L - 1, 2):
        pick = rng.random(out.shape[:1] + out.shape[2:]) < 0.6
        out[:, i] += np.where(pick, 1 << w, 0)
        out[:, i + 1] -= np.where(pick, 1, 0)
    assert (out < (1 << (w + 1))).all() and (out > -(1 << w)).all()
    return out.astype(np.int16)


def decode(out: np.ndarray, curve) -> list:
    xs, ys, zs = (planar_signed_to_ints_modp(out[c], curve) for c in range(3))
    return [ref.INF if z == 0 else (x * pow(z, -1, curve.p) % curve.p,
                                    y * pow(z, -1, curve.p) % curve.p, 1)
            for x, y, z in zip(xs, ys, zs)]


@pytest.mark.parametrize("Wp,B,T", [(2, 8, 1), (2, 8, 8), (1, 1024, 1024)])
def test_pbpr_replay_vs_jax_bucket_reduce_bn254(Wp, B, T):
    """Real points (Montgomery form, Z = 1) written with limbs at the
    ledger's ends, a quarter of the buckets at infinity: the replay equals
    the JAX package's two-stage reduction window by window in the group
    (about 15 to 40 s a shape, its compile)."""
    C, JC = tc.BN254_S12, jc.BN254_S12
    pts, _ = ref.gen_points_scalars(C, 64, seed=90 + T)
    kill = np.random.default_rng(91 + B).random((Wp, B)) < 0.25
    reps = -(-Wp * B // len(pts))
    b = mont_buckets(C, (pts * reps)[:Wp * B], (Wp, B), kill).numpy()
    b = spread_to_ledger_ends(b, C, np.random.default_rng(92))
    got = pbpr_replay(b, C, T)
    assert np.array_equal(got, tk.pbpr_full_plain(torch.from_numpy(b), C,
                                                  T).numpy())
    jcfg = JaxConfig(curve=JC, window_size=B.bit_length(),
                     columns=max(16, 2 * B), pbpr_threads=T, subtask_group=Wp,
                     backend="xla")
    jb = jnp.asarray(b.astype(np.int32))
    want = np.asarray(jnp.stack(jpbpr.bucket_reduce(
        ProjPoint(jb[0], jb[1], jb[2]), jcfg)))
    for w, (a, e) in enumerate(zip(decode(got, C), decode(want, C),
                                   strict=True)):
        assert ref.jac_eq(C, a, e), w


@pytest.mark.parametrize("drop", BARRIERS + ("doubling",))
def test_pbpr_replay_finds_a_planted_race(drop):
    """Each warp barrier of a scan add, and one of the tail's doublings,
    left out: the replay's race check must fail."""
    b = ledger_buckets(tc.TINY62, 1, 16, seed=4)
    with pytest.raises(AssertionError):
        pbpr_replay(b, tc.TINY62, 4, drop={drop})


def test_pbpr_replay_stage1_stores_cover_the_exchange_array():
    """The stage-1 stores of m and g land where the scan reads them: half
    h, window w, lane t at (h Wp + w) T + t, as int16."""
    C = tc.BN254_S12
    Wp, B, T = 3, 64, 8
    b = ledger_buckets(C, Wp, B, seed=6)
    m, g = tk.pbpr_stage1_plain(torch.from_numpy(b), C, T)
    want = torch.cat([m, g], dim=2).reshape(3 * C.num_limbs, 2 * Wp * T)
    assert np.array_equal(replay_stage1(b, C, T), want.to(torch.int16).numpy())


@pytest.mark.parametrize("name", ["bn254_s12", "bn254_s13", "bls12_377_s12",
                                  "bls12_377_s13"])
def test_stage1_register_cap_costs_no_wave(name, monkeypatch):
    """The stage-1 kernels' register cap (csrc/pbpr_lane.cuh
    stage1_registers): at L <= 22 the 8,192 lanes of the 2^20 MSM take one
    wave at 64 registers and would take two at 72; above, 96 registers
    take no more waves than 64 at the MSM's shapes, the lanes' shared
    memory bounding them first."""
    curve = tc.CURVES[name]
    L, w = curve.num_limbs, curve.log_limb_size
    cap = tk.pbpr_stage1_registers(L)
    assert cap == (64 if L <= 22 else 96)
    for shape in [(16, 32768, 512), (17, 32768, 512), (20, 4096, 256)]:
        waves = tk.pbpr_stage1_geometry(*shape, 132, L, w).waves
        monkeypatch.setattr(tk, "pbpr_stage1_registers", lambda _: 64)
        assert tk.pbpr_stage1_geometry(*shape, 132, L, w).waves == waves
        monkeypatch.setattr(tk, "pbpr_stage1_registers", lambda _: 72)
        more = tk.pbpr_stage1_geometry(*shape, 132, L, w).waves
        monkeypatch.undo()
        if L <= 22 and shape[0] * shape[2] == 8192:
            assert waves == 1 < more
