"""The stitch across columns of the port's XLA path,
`kernels.smvp_stitch`, on CPU tensors (its plain version).

`smvp_stitch_plain` against the JAX `bucket_accumulate` bit for bit at
TINY62 (BN254_S12 in tests/test_torch_smvp_stitch_bn254.py): C in {1, 2,
3, 5, 7, 100, 256} (odd C where n is below the columns, R = 1), every
key equal, every column its own run, every digit 0; one jit of the JAX
function a shape (tests/_torch_twin.py runs it so too). On those cases
the phases of csrc/smvp_stitch.cu replayed on CPU tensors from the
tables the kernel reads (`_torch_stitch.kernel_replay`: the levels with
an add by the closed form, only their adding pairs, P from the trailing
sums where no level adds). The level
schedule (`kernels.smvp_stitch_levels`) against the recursion of
`kernels.associative_scan`: on a combine whose results name their tree
at every C up to 300 and more, and with complete adds at BN254_S12 at
C in {1, 2, 3, 5, 100, 2048, 8192}. Then `smvp_stitch_geometry`, the
wrapper's launch against a fake library, its refusals, the plain version
on CPU tensors and no second path when the kernel cannot launch."""

import numpy as np
import pytest
import torch

import _torch_stitch as st
from tpu_msm_torch import _build
from tpu_msm_torch import constants as tc
from tpu_msm_torch.constants import int_to_limbs
from tpu_msm_torch.cuzk import kernels

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

I16, I32 = torch.int16, torch.int32

# (C, R, s, kind): the JAX cases at TINY62; one jit a (C, R, s)
CASES = ([(1, 8, 4, "random"), (2, 4, 4, "random"), (3, 1, 4, "random"),
          (5, 1, 4, "random"), (100, 1, 4, "random")]
         + [(7, 1, 4, k) for k in st.KINDS]
         + [(256, 2, 10, k) for k in st.KINDS])
IDS = [f"C{C}-R{R}-{k}" for C, R, _, k in CASES]


@pytest.mark.parametrize("C,R,s,kind", CASES, ids=IDS)
def test_stitch_matches_jax_tiny62(C, R, s, kind):
    st.check_against_jax("tiny62", C, R, s, kind)


# ---------------------------------------------------------------------------
# the level schedule
# ---------------------------------------------------------------------------


def _mix(a, b):
    """A combine that is neither commutative nor associative on values
    in [0, 32749), under segment flags: its results name the exact tree
    of combinations."""
    (av, af), (bv, bf) = a, b
    return torch.where(bf, bv, (av * 181 + bv) % 32749), af | bf


@pytest.mark.parametrize("Cs", [range(1, 100), range(100, 301),
                                (511, 512, 513, 1000, 2047, 2048, 8191,
                                 8192)], ids=["1-99", "100-300", "wide"])
def test_levels_replay_the_recursion(Cs):
    for C in Cs:
        rng = np.random.default_rng(C)
        v = torch.from_numpy(rng.integers(0, 32749, C))
        f = torch.from_numpy(rng.random(C) < 0.25)
        want = kernels.associative_scan(_mix, (v, f))
        for lv in kernels.smvp_stitch_levels(C):
            a, b = (torch.tensor(x) for x in zip(*lv))
            assert not set(a.tolist()) & set(b.tolist())
            v[b], f[b] = _mix((v[a], f[a]), (v[b], f[b]))
        assert torch.equal(v, want[0]) and torch.equal(f, want[1]), C


def random_points(curve, shape, seed):
    """(3, L, *shape) int32 canonical limbs of random values below p."""
    rng = np.random.default_rng(seed)
    L, w = curve.num_limbs, curve.log_limb_size
    count = 3 * int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(48), "little") % curve.p
            for _ in range(count)]
    limbs = np.array([int_to_limbs(v, L, w) for v in vals], dtype=np.int32)
    return torch.from_numpy(limbs.T.reshape((L, 3) + tuple(shape))
                            ).transpose(0, 1).contiguous()


@pytest.mark.parametrize("C", [1, 2, 3, 5, 100, 2048, 8192])
def test_schedule_replay_matches_associative_scan(C):
    """The kernel's tables replayed with complete adds at BN254_S12, an
    add only where b is not flagged, against `associative_scan` on
    `padd_batch_plain`, bit for bit, points and flags."""
    curve = tc.BN254_S12
    pts = random_points(curve, (1, C), C)
    flags = torch.from_numpy(np.random.default_rng(C).random((1, C)) < 0.2)

    def comb(a, b):
        s = kernels.padd_batch_plain(a[0], b[0], curve)
        return torch.where(b[1], b[0], s), a[1] | b[1]

    want = kernels.associative_scan(comb, (pts, flags))
    scan, f = pts.clone(), flags.clone()
    st.replay_levels(scan, f, curve, C)
    assert torch.equal(scan, want[0]) and torch.equal(f, want[1])
    pairs, starts = kernels._stitch_schedule(C, torch.device("cpu"))
    levels = kernels.smvp_stitch_levels(C)
    assert starts.tolist()[-1] == len(pairs) == sum(map(len, levels))
    assert pairs[:, :2].tolist() == [list(p) for lv in levels for p in lv]
    assert pairs.tolist() == [list(p) for p in kernels.smvp_stitch_pairs(C)]


# ---------------------------------------------------------------------------
# the geometry and the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Wg,C,per_sm", [(1, 8192, 11), (4, 2048, 11),
                                         (16, 8192, 11), (1, 1, 1),
                                         (3, 7, 2), (1, 8192, 1)])
def test_geometry(Wg, C, per_sm):
    """Lanes of 6 threads, 10 a block of 64 threads; one lane an item of
    the widest level (Wg C) up to the resident blocks, then several; the
    pass before the first barrier decides Wg times the schedule's pairs,
    spread over every thread of the grid."""
    geo = kernels.smvp_stitch_geometry(Wg, C, 132, per_sm, 64)
    assert geo.threads_per_lane == 6 and geo.lanes_per_block == 10
    assert geo.blocks == min(-(-Wg * C // 10), 132 * per_sm)
    assert geo.blocks * geo.lanes_per_block * geo.items_per_lane >= Wg * C
    assert geo.levels == len(kernels.smvp_stitch_levels(C))
    assert geo.shared_bytes <= kernels.BLOCK_SHARED_BYTES
    assert geo.pair_items == Wg * len(kernels.smvp_stitch_pairs(C))
    assert (geo.blocks * geo.threads * geo.pairs_per_thread
            >= geo.pair_items)
    if (Wg, C, per_sm) == (1, 8192, 11):
        assert (geo.blocks, geo.items_per_lane, geo.levels) == (820, 1, 25)
        assert (geo.pair_items, geo.pairs_per_thread) == (16369, 1)
    if (Wg, C) == (16, 8192):
        assert geo.blocks == 1452 and geo.items_per_lane == 10
    for bad in ((0, C, 132, per_sm, 64), (Wg, C, 132, 0, 64),
                (Wg, C, 132, per_sm, 48)):
        with pytest.raises(ValueError):
            kernels.smvp_stitch_geometry(*bad)


class FakeLib:
    """Records each launch of the stitch; returns `rc`."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def msm_smvp_stitch(self, L, w, bucket, trailing, keys, scan, masks,
                        pairs, starts, Wg, C, R, B2, levels, G, blocks,
                        consts, wide, stream):
        self.calls.append((L, w, Wg, C, R, B2, levels, G, blocks, pairs,
                           starts))
        self.masks = masks
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's kernel path on CPU tensors, against a fake library
    and launch limits; the plain version must not run."""
    lib = FakeLib()
    monkeypatch.setattr(kernels, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_smvp_stitch_limits",
                        lambda curve, dev: (132, 11, 64, 6))
    monkeypatch.setattr(_build, "library", lambda: lib)

    def no_plain(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(kernels, "smvp_stitch_plain", no_plain)
    kernels.reset_launches()
    return lib


def stitch_args(curve, Wg, C, R, B):
    L = curve.num_limbs
    return (torch.zeros((3, L, Wg, B + 2), dtype=I32),
            torch.zeros((3, L, Wg, C), dtype=I32),
            torch.zeros((Wg, C * R), dtype=I32), curve, C)


def test_wrapper_launches_once(fake_card):
    """The 2^20 shape: one window of 8,192 columns of 2 rows (the row
    count is the keys' length over C), 25 levels, 820 blocks."""
    c = tc.BN254_S12
    Wg, C, R, B = 1, 8192, 2, 32768
    args = stitch_args(c, Wg, C, R, B)
    assert kernels.smvp_stitch(*args) is args[0]
    geo = kernels.smvp_stitch_geometry(Wg, C, 132, 11, 64)
    pairs, starts = kernels._stitch_schedule(C, torch.device("cpu"))
    assert fake_card.calls == [(c.num_limbs, c.log_limb_size, Wg, C, R,
                                B + 2, 25, 6, 820, pairs.data_ptr(),
                                starts.data_ptr())]
    assert kernels.LAUNCHES["smvp_stitch"] == 1
    launched = dict(kernels.LAUNCHED["smvp_stitch"])
    # the kernel's block 0 writes the levels it ran past the blocks' words
    mask = launched.pop("ran_mask")
    assert mask.shape == (1,) and mask.dtype == torch.int64
    assert mask.data_ptr() == fake_card.masks + 8 * geo.blocks
    assert launched == geo._asdict()
    assert len(_build.SIGNATURES["msm_smvp_stitch"]) == 19


def test_no_second_path(fake_card, monkeypatch):
    """A failed launch raises, and so does a library that cannot be
    built: neither falls back to the plain version."""
    args = stitch_args(tc.TINY62, 2, 4, 3, 8)
    fake_card.rc = 1
    with pytest.raises(RuntimeError, match="smvp_stitch"):
        kernels.smvp_stitch(*args)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built")

    monkeypatch.setattr(_build, "library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.smvp_stitch(*args)


def test_wrapper_refusals(fake_card):
    c = tc.TINY62
    bucket, trailing, keys, _, _ = stitch_args(c, 2, 4, 3, 8)
    for args in ((bucket, trailing, keys[:, :11], c, 4),    # C does not divide
                 (bucket, trailing[..., :3], keys, c, 4),   # trailing's C
                 (bucket[..., :1], trailing, keys, c, 4),   # no spare slot
                 (bucket, trailing, keys[:1], c, 4),        # keys' windows
                 (bucket[:, :5], trailing[:, :5], keys, c, 4),   # limbs
                 (bucket, trailing, keys, c, 0),
                 (bucket[0], trailing, keys, c, 4),
                 (bucket.long(), trailing, keys, c, 4),     # dtypes
                 (bucket, trailing.to(I16), keys, c, 4),
                 (bucket, trailing, keys.long(), c, 4),
                 (bucket.transpose(2, 3).contiguous().transpose(2, 3),
                  trailing, keys, c, 4),                    # not contiguous
                 stitch_args(tc.BN254, 2, 4, 3, 8)):       # 16-bit limbs
        with pytest.raises(ValueError):
            kernels.smvp_stitch(*args)
    assert fake_card.calls == [] and set(kernels.LAUNCHES.values()) == {0}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "smvp_stitch_plain",
                        lambda *a: calls.append(a) or "plain")
    args = stitch_args(tc.TINY62, 2, 4, 3, 8)
    assert kernels.smvp_stitch(*args) == "plain"
    assert len(calls) == 1
