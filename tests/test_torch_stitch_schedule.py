"""The closed form by which csrc/smvp_stitch.cu decides its adds, on CPU
tensors, no JAX: each pair of `kernels.smvp_stitch_pairs(C)` adds where
the sorted keys k[lo R - 1] == k[(b + 1) R - 1]
(`kernels.stitch_pairs_add`), held against the flags carried level by
level as the recursion carries them, at C = 1 to 300, 2,048 and 8,192
on random sorted keys, every key equal, every column its own run and
every digit 0; each pair's interval [lo, b] against the columns the
recursion's element covers, and a's interval ending where b's begins;
the levels with an add (`stitch_levels_that_add`), and
`chip_smoke.py`'s count of the grid barriers (`stitch_barriers`) and
its reading of the levels a launch ran (`stitch_levels_ran`). The replay of the kernel's phases on real points
is `tests/_torch_stitch.kernel_replay`, held against the plain version
and the JAX function in tests/test_torch_smvp_stitch*.py."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_msm_torch.cuzk import kernels

torch.set_num_threads(1)

KINDS = ("sorted", "equal", "own", "zero")


def keys_of(kind: str, Wg: int, C: int, R: int, seed: int) -> torch.Tensor:
    """(Wg, C R) int32 keys sorted in each window: random with runs
    across columns (few distinct keys, so runs span columns), every key
    equal, column c all key c + 1, every key 0."""
    rng = np.random.default_rng(seed)
    n = C * R
    if kind == "sorted":
        k = np.sort(rng.integers(0, max(2, n // rng.integers(1, 8)),
                                 (Wg, n)), axis=1)
    elif kind == "equal":
        k = np.full((Wg, n), 5)
    elif kind == "own":
        k = np.repeat(np.arange(1, C + 1), R)[None].repeat(Wg, 0)
    else:
        k = np.zeros((Wg, n))
    return torch.from_numpy(k.astype(np.int32))


def carried(skeys: torch.Tensor, C: int) -> list:
    """Which pairs of each level add with the flags carried level by
    level: a column flagged where it holds more than one run or does not
    go on with the run before it; a pair adds where b is not flagged,
    and then b takes a's flag."""
    Wg, n = skeys.shape
    k = skeys.long().reshape(Wg, C, n // C)
    first, last = k[..., 0], k[..., -1]
    cont = torch.cat([torch.full((Wg, 1), -1), last[:, :-1]], 1) == first
    flags = (first != last) | ~cont
    out = []
    for level in kernels.smvp_stitch_levels(C):
        a, b = torch.tensor(level).T
        go = ~flags[:, b]
        out.append(go)
        flags[:, b] = torch.where(go, flags[:, a], flags[:, b])
    return out


@pytest.mark.parametrize("Cs", [range(1, 101), range(101, 301), (2048, 8192)],
                         ids=["1-100", "101-300", "2048-8192"])
@pytest.mark.parametrize("kind", KINDS)
def test_closed_form_matches_the_carried_flags(Cs, kind):
    for C in Cs:
        for R in ((1, 3) if C > 300 else (1, 2, 3)):
            skeys = keys_of(kind, 2, C, R, seed=C * 7 + R)
            want = carried(skeys, C)
            got = kernels.stitch_pairs_add(skeys, C)
            assert len(got) == len(want)
            for lv, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w), (C, R, kind, lv)
            levels = tuple(lv for lv, w in enumerate(want) if bool(w.any()))
            assert kernels.stitch_levels_that_add(skeys, C) == levels


@pytest.mark.parametrize("Cs", [range(1, 301), (511, 2048, 2049, 8192)],
                         ids=["1-300", "wide"])
def test_pair_intervals_are_the_recursions(Cs):
    """Each pair's (a, b, lo, level): [lo, b] are the columns b's value
    covers when its level runs, [x, a] a's, and x <= a < lo = a + 1, so
    the two join into one interval and lo >= 1 (column 0 is always
    flagged, and never b's); the table holds the levels in order and
    `_stitch_schedule` holds it as the kernel reads it."""
    for C in Cs:
        cover = [(c, c) for c in range(C)]
        pairs = kernels.smvp_stitch_pairs(C)
        p = 0
        for lv, level in enumerate(kernels.smvp_stitch_levels(C)):
            for a, b in level:
                assert pairs[p] == (a, b, a + 1, lv)
                assert cover[b] == (a + 1, b) and cover[a][1] == a >= 0
                p += 1
            for a, b in level:
                cover[b] = (cover[a][0], b)
        assert p == len(pairs)
        table, starts = kernels._stitch_schedule(C, torch.device("cpu"))
        assert table.tolist() == [list(q) for q in pairs]
        assert starts.tolist()[-1] == len(pairs)


def test_barriers():
    """One after the pass that finds the levels; where any adds, one after
    the copy into the scan and one after each level run."""
    assert chip_smoke.stitch_barriers(()) == 1
    assert chip_smoke.stitch_barriers((0,)) == 3
    assert chip_smoke.stitch_barriers(tuple(range(25))) == 27


def test_levels_ran_reads_the_kernels_mask(monkeypatch):
    mask = torch.tensor([0, 0b1000000000000000000000101], dtype=torch.int64)
    monkeypatch.setitem(kernels.LAUNCHED, "smvp_stitch",
                        {"levels": 25, "ran_mask": mask[-1:]})
    assert chip_smoke.stitch_levels_ran() == (0, 2, 24)
    monkeypatch.setitem(kernels.LAUNCHED, "smvp_stitch", {
        "levels": 21, "ran_mask": torch.tensor([0], dtype=torch.int64)})
    assert chip_smoke.stitch_levels_ran() == ()


def test_default_shapes_need_no_scan_level():
    """At the XLA path's shapes (C = 8192 of 128 rows, C = 2048 of 32)
    random digits leave every column flagged: no level adds, one grid
    barrier; every key equal makes every level add."""
    for C, R, B in ((8192, 128, 1 << 15), (2048, 32, 1 << 12)):
        rng = np.random.default_rng(C)
        d = np.sort(np.abs(rng.integers(-B, B + 1, (1, C * R))), axis=1)
        skeys = torch.from_numpy(d.astype(np.int32))
        assert kernels.stitch_levels_that_add(skeys, C) == ()
        equal = torch.full((1, C * R), 9, dtype=torch.int32)
        levels = len(kernels.smvp_stitch_levels(C))
        assert kernels.stitch_levels_that_add(equal, C) == tuple(
            range(levels))
