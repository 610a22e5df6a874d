"""Stage 2 of the port's device program: `kernels.bucket_sort`'s plain
version against the JAX package, and csrc/bucket_sort.cu's passes
replayed in numpy, on CPU tensors.

The plain version sorts each window stably by |d|, the sign in the
payload idx << 1 | sign, and counts cnt[w, j] = #(|d| <= j). Held here:
cnt against the JAX `_bucket_counts` (tpu_msm/cuzk/pipeline_pallas.py)
on its block path and its flat path; the key order against
`jax.lax.sort` of the sign-packed keys |d| << 1 | sign, and each
|d| region's payloads against lax.sort's as sets (the JAX sort packs the
sign into the key, so the order inside a region differs); the order
against numpy's stable argsort exactly. The kernel's design (tiles of
4,096, a warp's 32-element steps ranked by digit peers, the scan over
the tiles, the scatter, the warp-wide fill of the counts) is replayed
step by step in numpy and must give the plain version's bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm.cuzk.pipeline_pallas import _bucket_counts
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.constants import TINY62
from tpu_msm_torch.cuzk import kernels, pipeline_cuda
from tpu_msm_torch.cuzk.pipeline import get_pipeline
from tpu_msm_torch.reference import curve as ref

torch.set_num_threads(1)

I32 = np.int32


def packed(cfg, n):
    """(xs, ys, hw) of n points of the config's curve, as the pipeline
    packs them."""
    pts, scalars = ref.gen_points_scalars(cfg.curve, n, seed=15)
    return get_pipeline(cfg, "cpu").pack(pts, scalars)


def digits_case(name, rng):
    """(digits (Wp, n) int16, B) of one named case."""
    if name == "zeros":
        return np.zeros((3, 700), np.int16), 4096
    if name == "one point":
        return rng.integers(-4096, 4096, (4, 1)).astype(np.int16), 4096
    if name == "+-B":                      # every digit at +-2^(s-1)
        d = np.where(rng.random((2, 333)) < 0.5, -4096, 4095)
        d[:, ::7] = 4096 - 1               # the top positive digit too
        return d.astype(np.int16), 4096
    if name == "n=1000 s=13":              # no multiple of 64
        return rng.integers(-4096, 4096, (3, 1000)).astype(np.int16), 4096
    if name == "s=8":
        return rng.integers(-128, 128, (5, 640)).astype(np.int16), 128
    if name == "s=16":
        d = rng.integers(-32768, 32768, (2, 1280)).astype(np.int16)
        d[0, :9] = -32768                  # |d| = 2^15 = B
        return d, 32768
    if name == "skewed":                   # long runs and empty buckets
        d = rng.integers(-3, 4, (3, 896)) * rng.integers(1, 3, (3, 896))
        return d.astype(np.int16), 512
    raise KeyError(name)


CASES = ["zeros", "one point", "+-B", "n=1000 s=13", "s=8", "s=16",
         "skewed"]


def stable_order(digits):
    return np.argsort(np.abs(digits.astype(I32)), axis=-1, kind="stable")


def jax_sort(digits):
    """`pipeline_pallas.py`'s stage 2 on the same digits: the sorted
    sign-packed keys and payloads of `jax.lax.sort`."""
    d32 = jnp.asarray(digits.astype(I32))
    keys2 = (jnp.abs(d32) << 1) | (d32 < 0).astype(jnp.int32)
    n = digits.shape[1]
    iota2 = (jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32),
                              digits.shape) << 1) | (keys2 & 1)
    sk, sp = jax.lax.sort((keys2, iota2), dimension=-1, num_keys=1,
                          is_stable=False)
    return keys2, np.asarray(sk), np.asarray(sp)


@pytest.mark.parametrize("name", CASES)
def test_plain_against_numpy_and_jax(name):
    rng = np.random.default_rng(CASES.index(name))
    digits, B = digits_case(name, rng)
    Wp, n = digits.shape
    pay, cnt = kernels.bucket_sort(torch.from_numpy(digits), B)
    assert pay.dtype == torch.int32 and pay.shape == (Wp, n)
    assert cnt.dtype == torch.int32 and cnt.shape == (Wp, B + 1)
    pay, cnt = pay.numpy(), cnt.numpy()

    # the order is numpy's stable argsort by |d|, the sign in bit 0
    order = stable_order(digits)
    assert np.array_equal(pay >> 1, order)
    assert np.array_equal(pay & 1, np.take_along_axis(digits < 0, order, 1))

    # the counts are _bucket_counts, on its flat path and (where n is a
    # multiple of its block, with two blocks or more) its block path
    keys2, sk, sp = jax_sort(digits)
    flat = np.asarray(_bucket_counts(keys2, n, B))
    assert np.array_equal(cnt, flat)
    block = np.asarray(_bucket_counts(keys2, n, B, jnp.asarray(sk)))
    assert np.array_equal(cnt, block)

    # lax.sort's key order; each |d| region's payloads the same set
    mag = np.abs(digits.astype(I32))
    assert np.array_equal(np.take_along_axis(mag, pay >> 1, 1), sk >> 1)
    for w in range(Wp):
        lo = 0
        for j in np.unique(mag[w]):
            hi = int(cnt[w, j]) if j <= B else n
            assert sorted(pay[w, lo:hi]) == sorted(sp[w, lo:hi])
            lo = hi


def test_shard_slice_and_pipeline_digits():
    """Wp > 1 windows of real digits (TINY62, decompose_digits), cut to a
    window shard as windows_device cuts them."""
    cfg = MSMConfig(curve=TINY62, window_size=8, columns=32,
                    pbpr_threads=16, subtask_group=2)
    n = 96
    _, _, hw = packed(cfg, n)
    digits = kernels.decompose_digits(torch.from_numpy(hw.astype(I32)),
                                      cfg.window_size, cfg.num_windows)
    Wp = cfg.padded_windows
    digits = torch.cat([digits, digits.new_zeros((Wp - digits.shape[0], n))])
    shard = digits[Wp // 2:].contiguous()
    pay, cnt = kernels.bucket_sort(shard, cfg.half_columns)
    order = stable_order(shard.numpy())
    assert np.array_equal(pay.numpy() >> 1, order)
    # the old stage 2's counts (torch.sort of the packed keys)
    d32 = shard.to(torch.int32)
    keys2 = (d32.abs() << 1) | (d32 < 0).to(torch.int32)
    want = pipeline_cuda.bucket_counts(torch.sort(keys2, dim=-1)[0],
                                       cfg.half_columns)
    assert torch.equal(cnt, want)


def test_wrapper_refusals_and_passes():
    z = torch.zeros((2, 8), dtype=torch.int16)
    with pytest.raises(ValueError):
        kernels.bucket_sort(z.to(torch.int32), 16)
    with pytest.raises(ValueError):
        kernels.bucket_sort(z, 1 << 16)
    with pytest.raises(ValueError):
        kernels.bucket_sort(z[:, :0], 16)
    with pytest.raises(ValueError, match="meta"):
        kernels.bucket_sort(z.to("meta"), 16)
    assert [kernels.sort_passes(B) for B in (1, 128, 255, 256, 4096, 32768)
            ] == [1, 1, 1, 2, 2, 2]


# ---------------------------------------------------------------------------
# csrc/bucket_sort.cu replayed
# ---------------------------------------------------------------------------

TILE, WARPS, ITEMS, RADIX = kernels.SORT_TILE, 8, 16, 256
SPAN = TILE // WARPS


def tile_ranks(keys, n, shift, tile):
    """`radix_tile_kernel`'s ranking of one tile: each element's rank
    among its warp's earlier elements of its digit, and the warps'
    histograms. Warp w takes [w SPAN, (w + 1) SPAN) of the tile, 32
    elements a step; the lowest peer adds the peers' count."""
    rank = np.zeros(TILE, np.int64)
    digit = np.full(TILE, RADIX, np.int64)
    whist = np.zeros((WARPS, RADIX + 1), np.int64)
    for w in range(WARPS):
        for c in range(ITEMS):
            lanes = np.arange(32)
            loc = w * SPAN + c * 32 + lanes
            idx = tile * TILE + loc
            valid = idx < n
            dg = np.where(valid, (keys[np.minimum(idx, n - 1)] >> shift)
                          & (RADIX - 1), RADIX)
            for lane in lanes[valid]:
                peers = dg == dg[lane]
                before = int(np.sum(peers[:lane]))
                rank[loc[lane]] = whist[w, dg[lane]] + before
            for d in np.unique(dg[valid]):
                whist[w, d] += int(np.sum(dg == d))
            digit[loc] = dg
    return rank, digit, whist[:, :RADIX]


def replay(digits, B):
    """The passes of msm_bucket_sort, then radix_bounds_kernel."""
    Wp, n = digits.shape
    passes = kernels.sort_passes(B)
    tiles = -(-n // TILE)
    d32 = digits.astype(np.int64)
    keys = np.abs(d32)
    pays = (np.arange(n)[None] << 1) | (d32 < 0)
    for ps in range(passes):
        shift = 8 * ps
        new_keys, new_pays = np.zeros_like(keys), np.zeros_like(pays)
        for w in range(Wp):
            ranked = [tile_ranks(keys[w], n, shift, t) for t in range(tiles)]
            hist = np.array([r[2].sum(0) for r in ranked])   # (tiles, 256)
            prefix = np.cumsum(hist, 0) - hist                # scan kernel
            totals = hist.sum(0)
            digit_base = np.cumsum(totals) - totals
            for t, (rank, digit, whist) in enumerate(ranked):
                warp_base = np.cumsum(whist, 0) - whist
                for loc in range(TILE):
                    idx = t * TILE + loc
                    if idx >= n:
                        continue
                    d = digit[loc]
                    pos = (digit_base[d] + prefix[t, d]
                           + warp_base[loc // SPAN, d] + rank[loc])
                    new_keys[w, pos] = keys[w, idx]
                    new_pays[w, pos] = pays[w, idx]
        keys, pays = new_keys, new_pays
    # the counts: position p fills [key[p], key[p + 1]) with p + 1 (up to
    # B + 1 after the last), position 0 fills [0, key[0]) with 0
    cnt = np.full((Wp, B + 1), -1, np.int64)
    for w in range(Wp):
        k = np.minimum(keys[w], B + 1)
        nxt = np.append(k[1:], B + 1)
        cnt[w, :k[0]] = 0
        for p in range(n):
            cnt[w, k[p]:nxt[p]] = p + 1
    return pays.astype(I32), cnt.astype(I32)


@pytest.mark.parametrize("shape,B", [((2, 5000), 4096), ((1, 9000), 32768),
                                     ((3, 1), 4096), ((1, 700), 128),
                                     ((2, 4096), 256)])
def test_kernel_replay_matches_plain(shape, B):
    """Two tiles and a partial third, one point, one pass (B = 128), two
    passes at 9 bits (B = 256), a whole tile; long runs of equal digits
    and zeros in the first window."""
    rng = np.random.default_rng(shape[1])
    digits = rng.integers(-B, B, shape)
    digits[0, : shape[1] // 3] = rng.integers(-2, 3, shape[1] // 3)
    digits = digits.astype(np.int16)
    pay, cnt = replay(digits, B)
    want_pay, want_cnt = kernels.bucket_sort(torch.from_numpy(digits), B)
    assert np.array_equal(pay, want_pay.numpy())
    assert np.array_equal(cnt, want_cnt.numpy())


def test_pipeline_stage2_is_bucket_sort(monkeypatch):
    """windows_device hands bucket_sort the shard's digits once a call and
    the scan each group's rows of its payload."""
    calls = []
    real = kernels.bucket_sort
    monkeypatch.setattr(kernels, "bucket_sort",
                        lambda d, B: calls.append((d.shape, B)) or real(d, B))
    cfg = MSMConfig(curve=TINY62, window_size=8, columns=32,
                    pbpr_threads=16, subtask_group=2)
    n = 64
    xs, ys, hw = map(torch.from_numpy, packed(cfg, n))
    pipeline_cuda.windows_device(xs, ys, hw, cfg, w_shards=2, w_index=1)
    assert calls == [((cfg.padded_windows // 2, n), cfg.half_columns)]
