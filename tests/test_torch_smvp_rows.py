"""The row walk of the port's XLA path, `kernels.smvp_rows`, on CPU
tensors (its plain version), against the loop of torch ops that
`cuzk/smvp.bucket_accumulate` ran before the kernel, copied here as it
was (`old_row_walk`, on `sort.sort_by_bucket`'s permutation): the
buckets (slots 0 .. B, digit 0's included; the spare slot B + 1 is
infinity) and the lanes' trailing sums, bit for bit.

Cases at TINY62 and BN254_S12: random digits; every digit equal (one run
across every column of a window); every digit 0; every position its own
run; R = 1; C = 1; Wg > 1 with different keys in each window; digits at
+-2^(s-1), the top slot; runs of chosen lengths (`RUNS`: over several
columns, a column's last run going on into the next); the GLV digits of
`cuzk/glv.apply_glv`. On the same cases the lanes of csrc/smvp_rows.cu
replayed (`kernel_replay`: a lane a column, the point itself at a run
start and the mixed add elsewhere, a sum written where the next key in
global order differs, the trailing sum after a column's last row, every
row walked once and every slot written once), so the kernel's writes are
checked before the card checks its bits. Then `bucket_accumulate` whole
on those cases against the function it was (`old_bucket_accumulate`),
`bucket_sort`'s payload against the stable sort it replaced,
`smvp_rows_geometry`, `smvp_rows_smem` and `chip_smoke.longest_run`,
the wrapper's launch against a fake library and its refusals, and the
launch counts of `_windows_device` by group.
No JAX: tests/test_torch_twin*.py hold `bucket_accumulate` and
`_windows_device` against the JAX functions."""

import numpy as np
import pytest
import torch

import chip_smoke

from tpu_msm_torch import _build
from tpu_msm_torch import constants as tc
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.cuzk import decompose, kernels, pipeline, smvp, sort
from tpu_msm_torch.cuzk import glv as glv_dev
from tpu_msm_torch.cuzk.pipeline import get_pipeline
from tpu_msm_torch.ops import complete, lazy, rows
from tpu_msm_torch.reference import curve as ref

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

I16, I32 = torch.int16, torch.int32


def old_row_walk(xs_m, ys_m, digits, cfg):
    """The row walk of `bucket_accumulate` before `kernels.smvp_rows`
    (its sort, gathers and loop, as they were): (bucket with its spare
    slot, the carry)."""
    curve = cfg.curve
    dev = xs_m.device
    Wg, n = digits.shape
    C = min(cfg.columns, n)
    R = n // C
    B = cfg.half_columns

    keys, neg_mask = sort.bucket_keys(digits)
    skeys, perm = sort.sort_by_bucket(keys)
    ssign = torch.gather(neg_mask, -1, perm)

    sy_all = ys_m[:, perm]                                       # (L,Wg,n)
    sy_all = torch.where(ssign, lazy.neg(sy_all, curve, 2), sy_all)

    def rows_first(a):                          # (..., Wg, n) -> (R, ...)
        return a.reshape(a.shape[:-1] + (C, R)).movedim(-1, 0).contiguous()

    sx = rows_first(xs_m[:, perm])                               # (R,L,Wg,C)
    sy = rows_first(sy_all)
    kt = rows_first(skeys.long())                                # (R,Wg,C)

    first_next = torch.cat([kt[0, :, 1:], kt.new_full((Wg, 1), -1)], dim=-1)
    next_keys = torch.cat([kt[1:], first_next[None]])
    ends = kt != next_keys
    brk = torch.cat([torch.ones((1, Wg, C), dtype=torch.bool, device=dev),
                     kt[1:] != kt[:-1]])                         # run starts

    one_m = lazy.mont_one(curve, 2, dev)
    w_idx = torch.arange(Wg, device=dev)[:, None]
    spare = B + 1

    carry = complete.proj_infinity(curve, (Wg, C), dev)
    bucket = kernels.inf_stacked(curve, (Wg, B + 2), dev)    # + spare slot
    for r in range(R):
        summed = complete.pmadd(carry, sx[r], sy[r], curve)
        carry = complete.select(
            brk[r], complete.ProjPoint(sx[r], sy[r], one_m), summed)
        idx = torch.where(ends[r], kt[r], spare)
        bucket[:, :, w_idx, idx] = torch.stack(
            torch.broadcast_tensors(*carry))
    return bucket, carry, kt


def old_bucket_accumulate(xs_m, ys_m, digits, cfg):
    """`bucket_accumulate` as it was before `kernels.smvp_rows`."""
    curve = cfg.curve
    dev = xs_m.device
    Wg, _ = digits.shape
    B = cfg.half_columns
    bucket, carry, kt = old_row_walk(xs_m, ys_m, digits, cfg)
    brk = torch.cat([torch.ones((1,) + kt.shape[1:], dtype=torch.bool),
                     kt[1:] != kt[:-1]])
    allsame = ~torch.any(brk[1:], dim=0)
    w_idx = torch.arange(Wg, device=dev)[:, None]
    spare = B + 1

    key_first, key_last = kt[0], kt[-1]
    no = torch.zeros((Wg, 1), dtype=torch.bool, device=dev)
    cont = torch.cat([no, key_last[:, :-1] == key_first[:, 1:]], dim=-1)

    def comb(a, b):
        s = kernels.padd_batch(a[0], b[0], curve)
        return torch.where(b[1], b[0], s), a[1] | b[1]

    trailing = torch.stack(carry)
    scanned, _ = kernels.associative_scan(
        comb, (trailing, (~allsame) | (~cont)))
    P = torch.cat([kernels.inf_stacked(curve, (Wg, 1), dev),
                   scanned[..., :-1]], dim=-1)
    cont_next = torch.cat([cont[:, 1:], no], dim=-1)
    inject = cont & ((~allsame) | (~cont_next))
    cur = bucket[:, :, w_idx, key_first]
    fixed = kernels.padd_batch(cur, P, curve)
    bucket[:, :, w_idx, torch.where(inject, key_first, spare)] = \
        torch.where(inject, fixed, cur)
    return bucket[..., 1:B + 1]


def kernel_replay(pts_rows, pay, skeys, curve, C, B):
    """csrc/smvp_rows.cu's lanes, every lane at once: lane f = wl C + c
    walks rows 0 .. R - 1 of column c of window wl, the point itself at a
    run start (row 0, or a key other than the row above's), a mixed add
    at every other row. Where the next key in global order (row r + 1's;
    after the last row the next column's first key, -1 after the last
    column) differs, the sum goes into bucket[key] if the key is in
    [0, B + 1); after the column's last row, into trailing. Checks that
    every slot is written at most once. Returns (bucket, trailing)."""
    L = curve.num_limbs
    Wg, n = pay.shape
    R = n // C
    B2 = B + 2
    keys = skeys.long()
    F = Wg * C
    wl, c = torch.arange(F) // C, torch.arange(F) % C
    bucket = kernels.inf_stacked(curve, (Wg, B2))
    written = torch.zeros((Wg, B2), dtype=torch.int64)
    one = rows.mont_one_rows(curve, torch.zeros((L, F), dtype=I32))
    state = rows.ProjRows(one, one, one)
    prev = None
    for r in range(R):
        pos = c * R + r
        v = pay[wl, pos]
        row = pts_rows[(v >> 1).long()].to(I32).T                # (2L, F)
        x, y = row[:L], row[L:]
        y = torch.where((v & 1) != 0, rows.neg_rows(y, curve, 2), y)
        k = keys[wl, pos]
        start = (torch.ones(F, dtype=torch.bool) if prev is None
                 else k != prev)
        summed = rows.pmadd_rows(state, x, y, curve)
        state = rows.ProjRows(*(torch.where(start, a, b) for a, b in
                                zip(rows.ProjRows(x, y, one), summed)))
        if r + 1 < R:
            nxt = keys[wl, pos + 1]
        else:
            nxt = torch.where(c + 1 < C, keys[wl, torch.clamp(pos + 1,
                                                            max=n - 1)], -1)
        out = (nxt != k) & (k >= 0) & (k < B2 - 1)
        for f in out.nonzero().flatten().tolist():
            written[wl[f], k[f]] += 1
            bucket[:, :, wl[f], k[f]] = torch.stack(list(state))[:, :, f]
        prev = k
    assert int(written.max()) <= 1
    trailing = torch.stack(list(state)).reshape(3, L, Wg, C)
    return bucket, trailing


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def points(curve, n, seed):
    """(xm, ym) (L, n) int32 Montgomery limbs of n curve points."""
    pts, _ = ref.gen_points_scalars(curve, n, seed=seed)
    cfg = MSMConfig(curve=curve, window_size=4, columns=1, pbpr_threads=1,
                    subtask_group=1)
    xs, ys, _ = get_pipeline(cfg, "cpu").pack(pts, [0] * n)
    return decompose.points_to_mont(torch.from_numpy(xs),
                                    torch.from_numpy(ys), curve)


def case_digits(kind, Wg, n, B, rng):
    """(Wg, n) int32 digits of one case, |d| <= B."""
    if kind == "random":
        return rng.integers(-B, B, (Wg, n))
    if kind == "all_equal":                 # one run across every column
        d = np.full((Wg, n), B // 2 + 1)
        d[1::2] *= -1
        return d
    if kind == "all_zero":
        return np.zeros((Wg, n), np.int64)
    if kind == "own_runs":                  # n distinct keys a window
        d = np.stack([rng.permutation(np.arange(1, n + 1))
                      for _ in range(Wg)])
        return d * rng.choice([-1, 1], (Wg, n))
    if kind == "per_window":                # each window its own key range
        lo = np.arange(Wg)[:, None] * (B // Wg)
        return (lo + rng.integers(0, B // Wg + 1, (Wg, n))) * rng.choice(
            [-1, 1], (Wg, n))
    if kind == "top":                       # +-2^(s-1) and a few others
        d = rng.choice([-B, B, 0, 1, B - 1], (Wg, n))
        d[:, : n // 2] = -B
        return d
    if kind == "runs":                      # runs of chosen lengths
        # sorted, each key k + 1 repeated RUNS[k] times: runs that cross
        # several columns, runs of one row between them
        d = np.repeat(np.arange(1, len(RUNS) + 1), RUNS)[:n]
        d = np.concatenate([d, np.full(n - len(d), len(RUNS) + 1)])
        d = np.stack([rng.permutation(d) for _ in range(Wg)])
        return np.minimum(d, B) * rng.choice([-1, 1], (Wg, n))
    raise KeyError(kind)


# The run lengths of the "runs" keys, in sorted order.
RUNS = [1, 13, 2, 1, 9, 1, 1, 21, 3, 5, 1, 17, 4, 1, 1, 7]


# (name, kind, Wg, n, C, window size)
CASES = [
    ("tiny62", "random", 4, 64, 8, 4),
    ("tiny62", "all_equal", 3, 64, 8, 4),
    ("tiny62", "all_zero", 2, 32, 4, 4),
    ("tiny62", "own_runs", 2, 64, 8, 8),
    ("tiny62", "random", 3, 16, 16, 4),          # R = 1
    ("tiny62", "random", 2, 24, 1, 4),           # C = 1
    ("tiny62", "per_window", 4, 48, 16, 5),
    ("tiny62", "top", 2, 40, 8, 4),
    ("bn254_s12", "random", 2, 48, 4, 3),
    ("bn254_s12", "all_equal", 2, 32, 4, 3),
    ("bn254_s12", "own_runs", 1, 24, 8, 6),
    ("bn254_s12", "random", 2, 8, 8, 4),         # R = 1
    ("bn254_s12", "top", 2, 12, 1, 4),           # C = 1
    ("tiny62", "runs", 2, 96, 8, 6),             # R = 12: runs over columns
    ("tiny62", "runs", 1, 96, 4, 6),             # R = 24
    ("bn254_s12", "runs", 1, 48, 4, 6),          # R = 12
]
IDS = [f"{c[0]}-{c[1]}-R{c[3] // c[4]}-C{c[4]}" for c in CASES]


def make_case(name, kind, Wg, n, C, s):
    curve = tc.CURVES[name]
    cfg = MSMConfig(curve=curve, window_size=s, columns=C, pbpr_threads=1,
                    subtask_group=Wg)
    B = cfg.half_columns
    rng = np.random.default_rng([Wg, n, C, s, len(name), len(kind)])
    xm, ym = points(curve, n, seed=n + Wg + C)
    digits = torch.from_numpy(case_digits(kind, Wg, n, B, rng).astype(
        np.int32))
    assert int(digits.abs().max()) <= B
    return cfg, xm, ym, digits


def walk_inputs(xm, ym, digits, B):
    """The kernel's inputs as bucket_accumulate makes them."""
    pts_rows = torch.cat([xm, ym]).to(I16).T.contiguous()
    pay, _ = kernels.bucket_sort(digits.to(I16), B)
    skeys = torch.gather(digits.abs(), 1, (pay >> 1).long())
    return pts_rows, pay, skeys


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rows_match_the_old_loop_and_replay(case):
    cfg, xm, ym, digits = make_case(*case)
    curve, B = cfg.curve, cfg.half_columns
    C = min(cfg.columns, digits.shape[1])
    pts_rows, pay, skeys = walk_inputs(xm, ym, digits, B)
    kernels.reset_launches()
    bucket, trailing = kernels.smvp_rows(pts_rows, pay, skeys, curve, C, B)
    assert set(kernels.LAUNCHES.values()) == {0}      # plain on the CPU
    Wg, L = digits.shape[0], curve.num_limbs
    assert bucket.shape == (3, L, Wg, B + 2) and bucket.dtype == I32
    assert trailing.shape == (3, L, Wg, C) and trailing.dtype == I32

    want, carry, _ = old_row_walk(xm, ym, digits, cfg)
    assert torch.equal(bucket[..., :B + 1], want[..., :B + 1])
    assert torch.equal(trailing, torch.stack(torch.broadcast_tensors(*carry)))
    assert torch.equal(bucket[..., B + 1],
                       kernels.inf_stacked(curve, (Wg,)))

    rb, rt = kernel_replay(pts_rows, pay, skeys, curve, C, B)
    assert torch.equal(rb, bucket) and torch.equal(rt, trailing)


@pytest.mark.parametrize("case", CASES[:8] + CASES[9:10], ids=IDS[:8]
                         + IDS[9:10])
def test_bucket_accumulate_matches_the_old_function(case):
    cfg, xm, ym, digits = make_case(*case)
    got = smvp.bucket_accumulate(xm, ym, digits, cfg)
    assert torch.equal(got, old_bucket_accumulate(xm, ym, digits, cfg))
    pts_rows = torch.cat([xm, ym]).to(I16).T.contiguous()
    assert torch.equal(
        smvp.bucket_accumulate(xm, ym, digits, cfg, pts_rows), got)


def test_glv_digits():
    """The first group of the GLV stream of `apply_glv` at BN254_S12 (the
    doubled stream P ++ phi(P), digits of |k1| ++ |k2|)."""
    c = tc.BN254_S12
    cfg = MSMConfig(curve=c, window_size=4, columns=8, pbpr_threads=2,
                    subtask_group=4, glv=True)
    pts, scalars = ref.gen_points_scalars(c, 16, seed=41)
    scalars[:3] = [0, 1, c.scalar_modulus - 1]
    xs, ys, hw = get_pipeline(cfg, "cpu").pack(pts, scalars)
    xm, ym = decompose.points_to_mont(torch.from_numpy(xs),
                                      torch.from_numpy(ys), c)
    xm, ym, digits = glv_dev.apply_glv(xm, ym, torch.from_numpy(hw).to(I32),
                                       cfg)
    digits = digits[:cfg.subtask_group].to(I32)
    B, C = cfg.half_columns, cfg.columns
    pts_rows, pay, skeys = walk_inputs(xm, ym, digits, B)
    bucket, trailing = kernels.smvp_rows(pts_rows, pay, skeys, c, C, B)
    want, carry, _ = old_row_walk(xm, ym, digits, cfg)
    assert torch.equal(bucket[..., :B + 1], want[..., :B + 1])
    assert torch.equal(trailing, torch.stack(torch.broadcast_tensors(*carry)))
    rb, rt = kernel_replay(pts_rows, pay, skeys, c, C, B)
    assert torch.equal(rb, bucket) and torch.equal(rt, trailing)
    assert torch.equal(smvp.bucket_accumulate(xm, ym, digits, cfg),
                       old_bucket_accumulate(xm, ym, digits, cfg))


# ---------------------------------------------------------------------------
# the sort, the geometry, the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
def test_bucket_sort_payload_is_the_stable_sort(seed):
    """`bucket_sort`'s payload is `sort.sort_by_bucket`'s permutation with
    the sign of its digit: perm << 1 | neg_mask[perm], ties in index
    order."""
    rng = np.random.default_rng(seed)
    B = 8
    d = rng.integers(-B, B + 1, (5, 300)).astype(np.int16)
    d[1] = -3                                  # one run the whole window
    d[2, ::3] = 0
    digits = torch.from_numpy(d)
    pay, _ = kernels.bucket_sort(digits, B)
    keys, neg = sort.bucket_keys(digits)
    _, perm = sort.sort_by_bucket(keys)
    want = (perm.to(I32) << 1) | torch.gather(neg, 1, perm).to(I32)
    assert pay.dtype == I32 and torch.equal(pay, want)


@pytest.mark.parametrize("lanes,L,blocks", [
    (8192, 22, 1639), (16384, 22, 3277), (512, 22, 103), (8192, 32, 1639),
    (1, 6, 1), (5, 6, 1), (6, 30, 2), (2048, 21, 410)])
def test_geometry(lanes, L, blocks):
    """A lane a column, one warp of 5 lanes a block, as many blocks as
    the columns fill; the shared bytes of `smvp_rows_smem`."""
    geo = kernels.smvp_rows_geometry(lanes, L)
    assert geo == (blocks, 5, kernels.smvp_rows_smem(L))
    assert (blocks - 1) * 5 < lanes <= blocks * 5
    for bad in ((0, L), (lanes, 0)):
        with pytest.raises(ValueError):
            kernels.smvp_rows_geometry(*bad)


@pytest.mark.parametrize("L,shared", [(22, 7340), (21, 6740), (32, 10540),
                                      (30, 9900), (6, 2220)])
def test_smem(L, shared):
    """Each lane: a double buffer of its 4 L-byte row and 14 segments of
    L | 1 words padded to an odd count (RunMem), a block one warp of 5
    lanes: 1,468 bytes a lane at L = 22, against prefix_scan's 1,932 (19
    segments and a payload buffer)."""
    assert kernels.smvp_rows_smem(L) == shared
    assert shared == 5 * (8 * L + 4 * (14 * (L | 1) | 1))
    if L == 22:
        assert shared // 5 == 1468
        assert kernels.prefix_scan_smem(L, 6).shared_bytes // 20 == 1932
    with pytest.raises(ValueError):
        kernels.smvp_rows_smem(0)


def test_longest_run():
    """chip_smoke.longest_run: the longest run inside one column, a run
    that goes on into the next column counted in each apart."""
    k = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3]], dtype=I32)
    assert chip_smoke.longest_run(k, 1) == 5
    assert chip_smoke.longest_run(k, 2) == 4         # 2 2 2 | 2 2 3 3 3 3
    assert chip_smoke.longest_run(k, 4) == 3
    assert chip_smoke.longest_run(torch.zeros((3, 8), dtype=I32), 2) == 4
    assert chip_smoke.longest_run(torch.arange(8, dtype=I32)[None], 1) == 1


class FakeLib:
    """Records each launch of the row walk; returns `rc`."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def msm_smvp_rows(self, L, w, rows_, pay, keys, bucket, trailing, Wg, C,
                      R, n, B2, blocks, shared, consts, wide, stream):
        self.calls.append((L, w, Wg, C, R, n, B2, blocks, shared))
        return self.rc


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's kernel path on CPU tensors, against a fake library."""
    lib = FakeLib()
    monkeypatch.setattr(kernels, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(kernels, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(_build, "library", lambda: lib)
    kernels.reset_launches()
    return lib


def test_wrapper_launches_once(fake_card):
    c = tc.BN254_S12
    L = c.num_limbs
    Wg, C, R, B = 2, 4096, 2, 4096
    n = C * R
    pts_rows = torch.zeros((n, 2 * L), dtype=I16)
    pay = torch.zeros((Wg, n), dtype=I32)
    bucket, trailing = kernels.smvp_rows(pts_rows, pay, pay.clone(), c, C, B)
    geo = kernels.smvp_rows_geometry(Wg * C, L)
    assert fake_card.calls == [(L, c.log_limb_size, Wg, C, R, n, B + 2,
                                geo.blocks, geo.shared_bytes)]
    assert kernels.LAUNCHES["smvp_rows"] == 1
    assert kernels.LAUNCHED["smvp_rows"] == geo._asdict()
    assert len(_build.SIGNATURES["msm_smvp_rows"]) == 17
    # the wrapper fills the buckets with infinity; the kernel writes them
    assert torch.equal(bucket, kernels.inf_stacked(c, (Wg, B + 2)))
    assert trailing.shape == (3, L, Wg, C)
    fake_card.rc = 1
    with pytest.raises(RuntimeError, match="smvp_rows"):
        kernels.smvp_rows(pts_rows, pay, pay.clone(), c, C, B)


def test_wrapper_refusals(fake_card):
    c = tc.TINY62
    pts_rows = torch.zeros((16, 12), dtype=I16)
    pay = torch.zeros((2, 16), dtype=I32)
    for args in ((pts_rows, pay, pay[:1], c, 4, 8),       # keys' shape
                 (pts_rows, pay, pay, c, 5, 8),            # C does not divide
                 (pts_rows, pay, pay, c, 4, 0),            # no bucket
                 (pts_rows, pay.long(), pay, c, 4, 8),     # dtype
                 (pts_rows.to(I32), pay, pay, c, 4, 8),
                 (pts_rows, pay, pay, tc.BN254, 4, 8)):    # 16-bit limbs
        with pytest.raises(ValueError):
            kernels.smvp_rows(*args)
    assert fake_card.calls == [] and set(kernels.LAUNCHES.values()) == {0}


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "smvp_rows_plain",
                        lambda *a: calls.append(a) or "plain")
    pay = torch.zeros((1, 4), dtype=I32)
    assert kernels.smvp_rows(torch.zeros((4, 12), dtype=I16), pay, pay,
                             tc.TINY62, 2, 4) == "plain"
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# the launches of the XLA path's device program
# ---------------------------------------------------------------------------


def stitch_combines(C: int) -> int:
    """Combines of `kernels.associative_scan` over C columns (the
    padd_batch launches of the stitch before `kernels.smvp_stitch`)."""
    count = [0]

    def comb(a, b):
        count[0] += 1
        return a[0] + b[0], a[1] | b[1]

    kernels.associative_scan(comb, (torch.zeros(C, dtype=torch.int64),
                                    torch.zeros(C, dtype=torch.bool)))
    return count[0]


def test_stitch_combines():
    """21 combines at C = 2048 and 25 at 8192: with the inject, the 22
    and 26 padd_batch launches a group (BN254_S12 at 2^16 and 2^20) that
    one smvp_stitch launch took over; the scan's levels of
    `kernels.smvp_stitch_levels`, as many."""
    assert stitch_combines(2048) == 21 and stitch_combines(8192) == 25
    assert [stitch_combines(m) for m in (1, 2, 3, 4, 8)] == [0, 1, 2, 3, 5]
    for C in (1, 2, 3, 4, 8, 2048, 8192):
        assert len(kernels.smvp_stitch_levels(C)) == stitch_combines(C)


def test_windows_device_launches(monkeypatch):
    """The wrappers `_windows_device` calls, counted on CPU tensors: stage
    1's encode_rows and decompose_digits (the encode_mont of each
    coordinate until the row table was a kernel's); per group one
    bucket_sort, one smvp_rows and one smvp_stitch; then two
    pbpr_stage1 (stage 1, stage 2), the halving tree and the last add on
    padd_batch, log2 Bt doublings. At BN254_S12 2^16 (5 groups, T = 256,
    Bt = 16) that is 9 padd_batch calls, and at 2^20 (16 groups, T = 512,
    Bt = 64) 10."""
    counts = {}
    for name in ("padd_batch", "bucket_sort", "smvp_rows", "smvp_stitch",
                 "pbpr_stage1", "pdbl_batch", "encode_mont", "encode_rows",
                 "decompose_digits"):
        fn = getattr(kernels, name)

        def wrap(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernels, name, wrap)
    c = tc.TINY62
    cfg = MSMConfig(curve=c, window_size=4, columns=8, pbpr_threads=2,
                    subtask_group=4, backend="xla")
    pts, scalars = ref.gen_points_scalars(c, 64, seed=5)
    xs, ys, hw = get_pipeline(cfg, "cpu").pack(pts, scalars)
    pipeline._windows_device(*(torch.from_numpy(a) for a in (xs, ys, hw)),
                             cfg=cfg)
    G, T = cfg.num_groups, cfg.pbpr_threads
    Bt = cfg.half_columns // T
    tree = T.bit_length() - 1
    assert counts == {
        "encode_rows": 1, "decompose_digits": 1, "bucket_sort": G,
        "smvp_rows": G, "smvp_stitch": G, "pbpr_stage1": 2,
        "pdbl_batch": Bt.bit_length() - 1, "padd_batch": tree + 1}
    for T, want in ((256, 9), (512, 10)):
        assert (T.bit_length() - 1) + 1 == want
