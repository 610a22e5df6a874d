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
against numpy's stable argsort exactly. The kernel's design is replayed
step by step in numpy and must give the plain version's bits: the
upsweep's chunk histograms and digit counts, the counts kernel's
segments (cnt and each pass's digit bases), and each pass's tiles of
4,096 (each warp's early counts published as the tile's aggregate, a
warp's 32-element steps ranked by digit peers straight into slots, the
decoupled look-back over the tiles before, run with the tiles' steps
interleaved in any order, the staged scatter); and
`bucket_sort_geometry`."""

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
AGGREGATE, INCLUSIVE = 1 << 30, 2 << 30


def upsweep(keys, geo, B):
    """`radix_upsweep_kernel`: each (window, chunk)'s histogram of the
    clamped keys, its bins 0 .. B (part) and each pass's digit counts
    (pdig), sums of its bins."""
    Wp, n = keys.shape
    span = -(-n // geo.chunks)
    nbins = ((geo.key_max >> 8) + 1) * RADIX
    part = np.zeros((Wp, geo.chunks, B + 1), np.int64)
    pdig = np.zeros((Wp, geo.chunks, geo.passes, RADIX), np.int64)
    for w in range(Wp):
        for c in range(geo.chunks):
            h = np.bincount(keys[w, c * span:(c + 1) * span],
                            minlength=nbins)
            part[w, c] = h[:B + 1]
            bins = h.reshape(-1, RADIX)            # (segments, 256)
            pdig[w, c, 0] = bins.sum(0)
            if geo.passes > 1:
                pdig[w, c, 1, :bins.shape[0]] = bins.sum(1)
    return part, pdig


def counts(part, pdig, B):
    """`radix_counts_kernel`: a block a segment of 256 bins: the bins
    summed over the chunks and scanned, plus the pass-1 digits below the
    segment; dbase, each pass's digits' exclusive prefix."""
    Wp, _, passes, _ = pdig.shape
    cnt = np.zeros((Wp, B + 1), np.int64)
    for w in range(Wp):
        for s in range((B >> 8) + 1):
            seg = part[w, :, s * RADIX:(s + 1) * RADIX].sum(0)
            below = pdig[w, :, 1, :s].sum() if s else 0
            cnt[w, s * RADIX:s * RADIX + seg.size] = below + np.cumsum(seg)
    tot = pdig.sum(1)                                  # (Wp, passes, 256)
    dbase = (np.cumsum(tot, -1) - tot).transpose(1, 0, 2)
    return cnt, dbase


def early_counts(keys, n, shift, tile):
    """The early counts of one tile: each warp's count of each digit (its
    SPAN elements), before any rank."""
    idx = tile * TILE + np.arange(TILE)
    dg = (keys[np.minimum(idx, n - 1)] >> shift) & (RADIX - 1)
    whist = np.zeros((WARPS, RADIX), np.int64)
    for w in range(WARPS):
        sl = slice(w * SPAN, (w + 1) * SPAN)
        np.add.at(whist[w], dg[sl][idx[sl] < n], 1)
    return whist


def tile_slots(keys, n, shift, tile, warp_base):
    """The rank straight into slots: warp w walks its SPAN elements 32 at
    a time; a lane's slot is its warp's next slot of its digit plus its
    peers of lower lane, and the lowest peer moves the next slot on."""
    slot = np.full(TILE, -1, np.int64)
    nxt = warp_base.copy()
    lower = np.tril(np.ones((32, 32), bool), -1)
    for w in range(WARPS):
        for c in range(ITEMS):
            loc = w * SPAN + c * 32 + np.arange(32)
            idx = tile * TILE + loc
            valid = idx < n
            dg = np.where(valid, (keys[np.minimum(idx, n - 1)] >> shift)
                          & (RADIX - 1), RADIX - 1)
            peers = (dg[:, None] == dg[None, :]) & valid[None, :]
            before = (peers & lower).sum(1)
            slot[loc[valid]] = (nxt[w, dg] + before)[valid]
            np.add.at(nxt[w], dg[valid], 1)
    # every warp ends at the next warp's first slot of each digit
    assert np.array_equal(nxt[:-1], warp_base[1:])
    return slot


def pass_tiles(keys, pays, n, shift, dbase_w, rng, stats):
    """`radix_pass_kernel` on one window: each tile a coroutine that
    counts its warps' digits, publishes its aggregate, ranks its tile
    into slots, looks back (spinning on a tile not ready), publishes its
    inclusive prefix and scatters. Tiles take their ids in order, but
    `rng` interleaves their steps in any order, so tiles finish in any
    order; the output must not depend on it. With rng None the tiles run
    in reverse."""
    tiles = -(-n // TILE)
    status = np.zeros((tiles, RADIX), np.int64)
    out_keys, out_pays = np.zeros_like(keys), np.zeros_like(pays)

    def tile_job(t):
        whist = early_counts(keys, n, shift, t)
        count = whist.sum(0)
        status[t] = (INCLUSIVE if t == 0 else AGGREGATE) | count
        yield
        first = np.cumsum(count) - count
        slots = tile_slots(keys, n, shift, t,
                           first + np.cumsum(whist, 0) - whist)
        excl = np.zeros(RADIX, np.int64)
        if t:
            for d in range(RADIX):
                q = t - 1
                while True:
                    while status[q, d] < AGGREGATE:   # not ready: spin
                        stats["spins"] += 1
                        yield
                    v = status[q, d]
                    excl[d] += v & (AGGREGATE - 1)
                    if v >= INCLUSIVE:
                        break
                    stats["aggregates"] += 1
                    q -= 1
            status[t] = INCLUSIVE | (excl + count)
        yield
        off = dbase_w + excl - first
        for loc in range(TILE):
            idx = t * TILE + loc
            if idx < n:
                d = (keys[idx] >> shift) & (RADIX - 1)
                out_keys[off[d] + slots[loc]] = keys[idx]
                out_pays[off[d] + slots[loc]] = pays[idx]

    if rng is None:
        # every tile's aggregate first, newest first, then each tile to
        # its end, newest first: each walks back over all the aggregates
        jobs = [tile_job(t) for t in range(tiles)]
        for job in reversed(jobs):
            next(job)
        for job in reversed(jobs):
            for _ in job:
                pass
        return out_keys, out_pays
    started, running = 0, []
    while started < tiles or running:
        if started < tiles and (not running or rng.random() < 0.3):
            running.append(tile_job(started))       # the next tile id
            started += 1
        job = running[rng.integers(len(running))]
        try:
            next(job)
        except StopIteration:
            running.remove(job)
    return out_keys, out_pays


def replay(digits, B, sms, rng, stats):
    """msm_bucket_sort: the upsweep, the counts, then the passes."""
    Wp, n = digits.shape
    geo = kernels.bucket_sort_geometry(Wp, n, B, sms)
    d32 = digits.astype(np.int64)
    keys = np.minimum(np.abs(d32), geo.key_max)
    pays = (np.arange(n)[None] << 1) | (d32 < 0)
    part, pdig = upsweep(keys, geo, B)
    cnt, dbase = counts(part, pdig, B)
    for ps in range(geo.passes):
        out = [pass_tiles(keys[w], pays[w], n, 8 * ps, dbase[ps, w], rng,
                          stats) for w in range(Wp)]
        keys = np.stack([k for k, _ in out])
        pays = np.stack([p for _, p in out])
    return pays.astype(I32), cnt.astype(I32), geo


@pytest.mark.parametrize("shape,B,kind", [
    ((2, 5000), 4096, "runs"), ((1, 9000), 32768, "runs"),
    ((3, 1), 4096, "runs"), ((1, 700), 128, "runs"),
    ((2, 4096), 256, "runs"), ((2, 6000), 4096, "equal"),
    ((3, 3000), 255, "runs"), ((2, 9000), 32768, "top")])
def test_kernel_replay_matches_plain(shape, B, kind):
    """Two tiles and a partial third, n = 1, one pass (B = 128 and 255),
    two passes at 9 bits (B = 256), a whole tile, every digit equal, a
    top window (only small |d|, the upper buckets empty); long runs of
    equal digits and zeros in the first window; a card of 3 SMs, so
    that a window takes several upsweep chunks."""
    rng = np.random.default_rng(shape[1] + B)
    digits = rng.integers(-B, B, shape)
    if kind == "runs":
        digits[0, : shape[1] // 3] = rng.integers(-2, 3, shape[1] // 3)
    elif kind == "equal":
        digits[:] = -777
    else:
        digits = rng.integers(-300, 300, shape)
    digits = digits.astype(np.int16)
    stats = {"spins": 0, "aggregates": 0}
    pay, cnt, geo = replay(digits, B, 3, rng, stats)
    assert geo.launches == 2 + geo.passes <= 4
    assert geo.passes == (1 if B < 256 else 2)
    want_pay, want_cnt = kernels.bucket_sort(torch.from_numpy(digits), B)
    assert np.array_equal(pay, want_pay.numpy())
    assert np.array_equal(cnt, want_cnt.numpy())


@pytest.mark.parametrize("order", ["reversed", "random"])
def test_lookback_any_finish_order(order):
    """The look-back of 9 tiles of one window, whose steps run in reverse
    (each tile's aggregate before any look-back: every tile walks back to
    tile 0) or in a random order, gives the stable order."""
    n, B = 9 * TILE - 5, 4096
    rng = np.random.default_rng(9)
    digits = rng.integers(-B, B, (1, n)).astype(np.int16)
    stats = {"spins": 0, "aggregates": 0}
    sched = None if order == "reversed" else rng
    pay, cnt, _ = replay(digits, B, 1, sched, stats)
    want_pay, want_cnt = kernels.bucket_sort_plain(torch.from_numpy(digits),
                                                   B)
    assert np.array_equal(pay, want_pay.numpy())
    assert np.array_equal(cnt, want_cnt.numpy())
    # reversed: in each of the two passes tile t reads the aggregates of
    # tiles t - 1 .. 1 of every digit; random: tiles waited on tiles not
    # ready and read aggregates
    if order == "reversed":
        assert stats["aggregates"] == 2 * RADIX * sum(range(8))
    else:
        assert stats["spins"] and stats["aggregates"]


@pytest.mark.parametrize("Wp,n,B,sms", [(16, 1 << 20, 1 << 15, 132),
                                        (9, 1 << 21, 1 << 15, 132),
                                        (20, 1 << 16, 1 << 12, 132),
                                        (3, 1, 128, 132), (65535, 7, 255, 4),
                                        (1, 5000, 256, 1)])
def test_geometry(Wp, n, B, sms):
    geo = kernels.bucket_sort_geometry(Wp, n, B, sms)
    assert geo.passes == kernels.sort_passes(B)
    assert geo.launches == 2 + geo.passes <= 4
    assert geo.tiles == -(-n // kernels.SORT_TILE)
    assert geo.key_max == min(B + 1, (1 << (8 * geo.passes)) - 1) >= B
    # the histogram fits a block, and the chunks of the upsweep are the
    # resident blocks (at least one a window, at most one a tile)
    assert geo.upsweep_shared_bytes <= kernels.BLOCK_SHARED_BYTES
    assert geo.upsweep_shared_bytes >= 4 * (geo.key_max + 1)
    assert 1 <= geo.chunks <= geo.tiles
    assert geo.upsweep_blocks == Wp * geo.chunks
    if Wp <= sms * geo.upsweep_blocks_per_sm and geo.chunks < geo.tiles:
        assert (geo.upsweep_blocks
                > sms * geo.upsweep_blocks_per_sm - Wp)
    assert geo.upsweep_blocks <= max(sms * geo.upsweep_blocks_per_sm, Wp)
    assert geo.count_blocks == Wp * ((B >> 8) + 1)
    assert geo.work_words == (Wp * geo.chunks * (B + 1)
                              + Wp * geo.chunks * geo.passes * 256
                              + geo.passes * Wp * 256
                              + geo.passes * Wp * (geo.tiles * 256 + 1))
    with pytest.raises(ValueError):
        kernels.bucket_sort_geometry(0, n, B, sms)


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
