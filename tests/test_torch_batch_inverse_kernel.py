"""`batch_inverse`'s kernel (csrc/batch_inverse.cu on the tree of
csrc/batch_inv.cuh) on CPU tensors: its launches replayed, its plan and
its wrapper.

The replay (tests/_torch_tree.py) runs the launches of
`kernels.batch_inverse_geometry` as the kernel's threads run them (the
register subtrees, blocks of 2^b leaves with b = 1, 2 and 3 as well as
the kernel's 1,024, the top levels and the root's chain, the way down
block by block) and must give plain `batch_inverse`'s bits: canonical
limbs below 2p, which are not unique, so any other tree or operand
order would show. At K = 1 to 257, with zeros of limbs 0 and of p and
lazy limbs, at BN254_S12 and BLS12_377_S12; once against the JAX
`batch_inverse`. Every node's value is written once going up, every
inverse once in a node's place at the levels where launches meet, every
element's once at the end, and so at K = 2^20 - 3 with the kernel's own
plan. The wrapper: the CPU path, the plan it launches (a fake library
records it), its refusals. No tolerance."""

import functools
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import _torch_tree as tree
import tpu_msm_torch
from tpu_msm import constants as jc
from tpu_msm.ops import inverse as jinverse
from tpu_msm_torch import _build
from tpu_msm_torch import constants as tc
from tpu_msm_torch.constants import BLS12_377_S12, BN254_S12
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.ops import inverse
from tpu_msm_torch.utils.limbs_conversion import ints_to_planar

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

CURVES = {c.name: c for c in (BN254_S12, BLS12_377_S12)}
# (threads_log, reg_log) of the replayed plan: blocks of 2 leaves (one
# thread of 2), of 4 (two threads of 2; four threads of 1, no register
# levels), of 8 (two threads of 4), and the kernels' own (256 threads of
# 4 leaves: one launch up to 1,024 leaves)
SPLITS = {"b1": (0, 1), "b2": (1, 1), "b2_shared": (2, 0), "b3": (1, 2),
          "kernel": (kernels.TREE_THREADS_LOG, kernels.TREE_REG_LOG)}
KS = (1, 2, 3, 5, 24, 28, 64, 100, 257)


@functools.lru_cache(maxsize=None)
def elements(name: str, K: int) -> torch.Tensor:
    """(L, K) lazy limbs of random Montgomery values below 2p, with zeros
    by value: limbs of 0 and of p where K allows, the first and a middle
    lane."""
    c = CURVES[name]
    rng = random.Random(K * 7 + c.num_limbs)
    vals = [rng.randrange(1, 2 * c.p) for _ in range(K)]
    if K > 1:
        vals[0] = 0
    if K > 2:
        vals[K // 2] = c.p
    t = torch.from_numpy(ints_to_planar(vals, c.num_limbs, c.log_limb_size
                                        ).astype(np.int32))
    # the same values as signed lazy limbs: a unit of the next limb
    # borrowed into a random half of the limbs below the top
    move = torch.from_numpy(np.random.default_rng(K).random(
        t[:-1].shape) < 0.5).to(torch.int32)
    t[:-1] += move << c.log_limb_size
    t[1:] -= move
    return t


@functools.lru_cache(maxsize=None)
def plain(name: str, K: int) -> torch.Tensor:
    return inverse.batch_inverse(elements(name, K), CURVES[name])


def launched_levels(geo) -> set:
    """Levels where a launch's leaves sit above level 0: the inverses of
    those nodes are written in their place."""
    return {ln.lo for ln in geo.launches if ln.lo > 0}


def check_counts(geo, counts, sunk) -> None:
    """Every node's value once going up, every inverse once in the place
    of a node at the levels where launches meet, every element's flag
    and inverse once."""
    for l in range(geo.levels + 1):
        assert (counts["values"][l] == 1).all(), l
        want = 1 if l in launched_levels(geo) else 0
        assert (counts["inverses"][l] == want).all(), l
    assert (counts["zero"] == 1).all()
    assert (sunk == 1).all()


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(CURVES))
def test_replay_matches_plain(name, split, K):
    c = CURVES[name]
    geo = kernels.batch_inverse_geometry(K, *SPLITS[split])
    got, counts, sunk = tree.tree_inverse(elements(name, K), c, geo)
    assert got.dtype == torch.int32
    assert torch.equal(got, plain(name, K))
    check_counts(geo, counts, sunk)


def test_replay_matches_jax():
    """K = 100 on blocks of 8 leaves (two up launches, the top, two down)
    against the JAX `batch_inverse` on the same canonical limbs."""
    c, K = BN254_S12, 100
    a = inverse.reduce_once(elements(c.name, K), c)
    a[:, K // 2] = torch.tensor(c.p_limbs())           # zero by value, p
    geo = kernels.batch_inverse_geometry(K, *SPLITS["b3"])
    got, _, _ = tree.tree_inverse(a, c, geo)
    want = jinverse.batch_inverse(jnp.asarray(a.numpy()),
                                  jc.CURVES[c.name])
    assert np.array_equal(np.asarray(want), got.numpy())
    assert torch.equal(got, inverse.batch_inverse(a, c))


def index_replay(geo):
    """`replay` on one-limb stand-ins, for the writes alone."""
    one = torch.zeros(1, 1, dtype=torch.int32)
    sunk = np.zeros(geo.K, np.int64)

    def sink(f, inv, zero):
        np.add.at(sunk, f.numpy(), 1)

    counts = tree.replay(
        geo, 1, one, lambda a, b: a + b, lambda r: r,
        lambda f: (torch.zeros(1, len(f), dtype=torch.int32),
                   torch.zeros(len(f), dtype=torch.bool)), sink)
    return counts, sunk


@pytest.mark.parametrize("K", (1, 1024, 1025, (1 << 16) - 3, (1 << 20) - 3))
def test_kernel_plan_writes_every_node_once(K):
    """The kernels' own plan, up to K = 2^20 - 3 points: one launch up
    to 1,024, three above; every node written once."""
    geo = kernels.batch_inverse_geometry(K)
    assert len(geo.launches) == (1 if geo.Kp <= 1024 else 3)
    check_counts(geo, *index_replay(geo))


@pytest.mark.parametrize("K", (1, 2, 3, 1000, 1024, 1025, 4096,
                               (1 << 20) - 3, 1 << 20, (1 << 20) + 1,
                               1 << 21, 123_456_789))
def test_geometry(K):
    geo = kernels.batch_inverse_geometry(K)
    b = kernels.TREE_THREADS_LOG + kernels.TREE_REG_LOG
    assert geo.Kp == 1 << max((K - 1).bit_length(), 0)
    assert geo.Kp >= K > geo.Kp // 2
    assert geo.levels == geo.Kp.bit_length() - 1
    assert geo.block_log == b and geo.scratch_nodes == 2 * geo.Kp
    L = geo.launches
    if geo.Kp <= 1 << b:
        assert len(L) == 1
    elif geo.Kp <= 1 << 2 * b:
        assert len(L) == 3
    tops = [ln for ln in L if ln.roles & kernels.TREE_ROOT]
    assert len(tops) == 1 and tops[0].roles == 7 and tops[0].blocks == 1
    top = L.index(tops[0])
    ups, downs = L[:top], L[top + 1:]
    assert all(u.roles == kernels.TREE_UP for u in ups)
    assert list(downs) == [u._replace(roles=kernels.TREE_DOWN)
                           for u in reversed(ups)]
    lo = 0
    for ln in ups + (tops[0],):
        assert ln.lo == lo
        assert ln.blocks << (ln.lo + ln.n) == geo.Kp
        assert 0 <= ln.d <= kernels.TREE_REG_LOG and ln.d <= ln.n
        assert ln.n - ln.d <= kernels.TREE_THREADS_LOG
        lo += ln.n
    assert lo == geo.levels
    assert all(u.n == b and u.d == kernels.TREE_REG_LOG for u in ups)


def test_geometry_refusals():
    for args in ((0,), (5, 8, 3), (5, -1, 2), (5, 0, 0)):
        with pytest.raises(ValueError):
            kernels.batch_inverse_geometry(*args)


def test_batch_inverse_cpu_path(monkeypatch):
    """CPU tensors take the plain version, no library, no launch; the
    batch shape comes back; int16 limbs give the int32 bits."""
    def refuse(*_):
        raise AssertionError("a CUDA call on the CPU path")

    monkeypatch.setattr(_build, "library", refuse)
    kernels.reset_launches()
    c = BN254_S12
    a = elements(c.name, 24)
    got = kernels.batch_inverse(a, c)
    assert torch.equal(got, plain(c.name, 24))
    shaped = kernels.batch_inverse(a.reshape(c.num_limbs, 4, 6), c)
    assert torch.equal(shaped.reshape(got.shape), got)
    assert torch.equal(kernels.batch_inverse(a.to(torch.int16), c), got)
    assert set(kernels.LAUNCHES.values()) == {0}
    assert tpu_msm_torch.batch_inverse is kernels.batch_inverse
    assert kernels.batch_inverse_plain is inverse.batch_inverse


class FakeLib:
    """Records each launch of the tree kernels; returns `rc`."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def msm_batch_inverse(self, L, w, a, K, out, zero, scratch, Kp, lo, n,
                          d, roles, blocks, consts, words, stream):
        self.calls.append(("batch_inverse", L, w, K, Kp, lo, n, d, roles,
                           blocks, words))
        return self.rc

    def msm_to_affine(self, L, w, x, y, z, K, ax, ay, inf, scratch, Kp, lo,
                      n, d, roles, blocks, consts, words, stream):
        self.calls.append(("to_affine", L, w, K, Kp, lo, n, d, roles, blocks,
                           words))
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' kernel path on CPU tensors, against a fake library."""
    lib = FakeLib()
    monkeypatch.setattr(kernels, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    kernels.reset_launches()
    return lib


@pytest.mark.parametrize("K", (1, 28, 5000))
def test_wrappers_launch_the_plan(fake_card, K):
    """Both wrappers launch the plan of `batch_inverse_geometry`, one
    count a launch, the constants' words beside; an error code raises."""
    c = BN254_S12
    L, w = c.num_limbs, c.log_limb_size
    geo = kernels.batch_inverse_geometry(K)
    words = len(kernels._affine_consts_host(c))
    a = torch.zeros((L, K), dtype=torch.int16)
    out = kernels.batch_inverse(a, c)
    assert out.shape == (L, K) and out.dtype == torch.int32
    p = torch.zeros((3, L, K), dtype=torch.int32)
    ax, ay, inf = kernels.to_affine(p, c)
    assert ax.shape == ay.shape == (L, K) and inf.shape == (K,)
    want = [(name, L, w, K, geo.Kp, *ln[1:4], ln.roles, ln.blocks, words)
            for name in ("batch_inverse", "to_affine")
            for ln in geo.launches]
    assert fake_card.calls == want
    assert kernels.LAUNCHES["batch_inverse"] == len(geo.launches)
    assert kernels.LAUNCHES["to_affine"] == len(geo.launches)
    assert kernels.LAUNCHED["batch_inverse"]["plan"] == [
        tuple(ln) for ln in geo.launches]
    fake_card.rc = 1
    with pytest.raises(RuntimeError):
        kernels.batch_inverse(a, c)


def test_wrapper_refusals(fake_card):
    """Wrong L and an unsigned profile are refused before any launch;
    K = 0 launches nothing."""
    c = BN254_S12
    with pytest.raises(ValueError):
        kernels.batch_inverse(torch.zeros((c.num_limbs + 1, 4),
                                          dtype=torch.int32), c)
    with pytest.raises(ValueError, match=tc.BN254.name):
        kernels.batch_inverse(torch.zeros((tc.BN254.num_limbs, 4),
                                          dtype=torch.int32), tc.BN254)
    empty = kernels.batch_inverse(torch.zeros((c.num_limbs, 0, 3),
                                              dtype=torch.int32), c)
    assert empty.shape == (c.num_limbs, 0, 3)
    assert fake_card.calls == [] and set(kernels.LAUNCHES.values()) == {0}


def test_other_devices_refused():
    """A tensor neither on the CPU nor on a CUDA device."""
    with pytest.raises(ValueError):
        kernels.batch_inverse(torch.zeros((22, 2), device="meta"), BN254_S12)
