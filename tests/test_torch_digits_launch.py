"""The launch of csrc/decompose_digits.cu on CPU tensors, no JAX:
`kernels.decompose_digits_geometry` (scalars a thread, the word of 4 or
8 bytes it reads of each row, the head before the first word boundary,
the vector flags) held to cover every scalar exactly once, for n in
{1, 7, 127, 129, 1000, 2^16}, row strides ld != n and odd column
offsets, every word, and to claim a vector load or store only where the
kernel's own checks (msm_decompose_digits) let it; the rule that picks
the word; the kernel's order of work replayed in numpy (the rows its
windows read held in chunks of kRows + 1, read from the source, each
window from its chunk's rows, int32 arithmetic as the kernel does it)
against `decompose_digits_plain` on uint16 and on int32 halfwords of
any value; the wrapper's arguments against a fake library."""

import re

import numpy as np
import pytest
import torch

from tpu_msm_torch import _build
from tpu_msm_torch.cuzk import kernels

torch.set_num_threads(1)

I16 = torch.int16
SOURCE = (_build.CSRC / "decompose_digits.cu").read_text()
K_ROWS = int(re.search(r"constexpr int kRows = (\d+);", SOURCE)[1])
K_THREADS = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE)[1])


def kernel_checks(geo, n: int, ld: int, eb: int, misalign: int) -> None:
    """What msm_decompose_digits refuses, on the geometry's flags."""
    P, word = geo.points_per_thread, geo.points_per_thread * eb
    assert word in (4, 8) and 0 <= geo.head <= n
    if geo.vector_loads:
        assert (ld * eb) % word == 0 and (misalign + geo.head * eb) % word == 0
    if geo.vector_stores:
        assert geo.head == 0 and n % P == 0
    assert (geo.head > 0) + -(-(n - geo.head) // P) == geo.threads
    assert geo.blocks == -(-geo.threads // K_THREADS)


@pytest.mark.parametrize("n", [1, 7, 127, 129, 1000, 1 << 16])
def test_geometry_covers_every_point_once(n):
    for eb in (2, 4):
        for P in [None] + [b // eb for b in kernels.DIGITS_WORD_BYTES]:
            for misalign in range(0, 16, eb):
                for ld in (n, n + 1, n + 8, 3 * n + 5):
                    geo = kernels.decompose_digits_geometry(
                        n, ld, eb, misalign, 18, 16, 16, P)
                    kernel_checks(geo, n, ld, eb, misalign)
                    seen = np.zeros(n, np.int64)
                    word = geo.points_per_thread * eb
                    for t in range(geo.threads):
                        f0, f1 = kernels.digits_points(geo, n, t)
                        assert 0 <= f0 < f1 <= n
                        seen[f0:f1] += 1
                        if geo.vector_loads and f1 - f0 == \
                                geo.points_per_thread:
                            assert (misalign + f0 * eb) % word == 0
                    assert (seen == 1).all(), (n, eb, P, misalign, ld)
                    assert kernels.digits_points(geo, n, geo.threads)[0] == n


def test_geometry_picks_the_word():
    """8-byte words where they leave 2^17 threads, else 4-byte ones;
    16-byte words are refused."""
    pick = lambda n, eb: kernels.decompose_digits_geometry(
        n, n, eb, 0, 18, 16, 16).points_per_thread
    assert pick(1 << 20, 2) == 4 and pick(1 << 22, 2) == 4
    assert pick(1 << 16, 2) == 2
    assert pick(1 << 20, 4) == 2 and pick(1 << 21, 4) == 2
    assert pick(1 << 16, 4) == 1
    geo = kernels.decompose_digits_geometry(1 << 20, 1 << 20, 2, 0, 18, 16,
                                            16)
    assert geo == kernels.DigitsGeometry(4, 0, 1 << 18, 2048, 16, True, True)
    # a slice 6 bytes past a word boundary, a stride of whole words
    geo = kernels.decompose_digits_geometry(3333, 1 << 20, 2, 6, 18, 16, 16)
    assert (geo.head, geo.vector_loads, geo.vector_stores) == (1, True, False)
    # a stride off the words: no head, no vector load
    geo = kernels.decompose_digits_geometry(1000, 1001, 2, 0, 18, 16, 16)
    assert (geo.head, geo.vector_loads, geo.vector_stores) == (0, False, True)
    for bad in ((8, 2, 1), (8, 2, 8), (8, 4, 3), (8, 4, 4), (0, 2, 0)):
        n, eb, P = bad
        with pytest.raises(ValueError):
            kernels.decompose_digits_geometry(n, n, eb, 0, 18, 16, 16,
                                              P or None)
    with pytest.raises(ValueError):
        kernels.decompose_digits_geometry(8, 8, 4, 2, 18, 16, 16)


def kernel_replay(hw: np.ndarray, s: int, W: int, Wp: int) -> np.ndarray:
    """The kernel's work on every scalar at once: the rows its windows
    read (`digits_rows`) held K_ROWS + 1 at a time, rows past them zero,
    each window from its chunk's rows, on int32 as the kernel computes."""
    H, n = hw.shape
    hw = hw.astype(np.int32)
    rows = kernels.digits_rows(H, s, W)
    mask, full, half = (1 << s) - 1, 1 << s, 1 << (s - 1)
    carry = np.zeros(n, np.int32)
    out = np.zeros((Wp, n), np.int16)
    w, c0 = 0, 0
    while w < W:
        r = [hw[c0 + k] if c0 + k < rows else np.zeros(n, np.int32)
             for k in range(K_ROWS + 1)]
        for k in range(K_ROWS):
            while w < W and (w * s) >> 4 == c0 + k:
                off = (w * s) & 15
                val = r[k]
                if off:
                    val = val >> off
                    if c0 + k + 1 < H:
                        hi = (r[k + 1].astype(np.int64) << (16 - off)) \
                            & 0xFFFFFFFF
                        val = val | hi.astype(np.uint32).view(np.int32)
                val = (val & mask) + carry
                ge = val >= half
                out[w] = (val - ge * full).astype(np.int16)
                carry = ge.astype(np.int32)
                w += 1
        c0 += K_ROWS
    return out


WINDOWS = [(16, 16), (13, 20), (16, 9), (12, 22), (8, 32), (5, 51),
           (4, 64), (1, 270), (1, 288), (3, 90)]


@pytest.mark.parametrize("s,W", WINDOWS, ids=[f"s{s}-W{W}" for s, W in
                                              WINDOWS])
def test_kernel_replay_matches_the_plain_version(s, W):
    """uint16 halfwords, and int32 halfwords of any value (the top
    window's signed shifts included), 18 rows, Wp > W; windows past one
    chunk of rows at s = 1 and 3."""
    rng = np.random.default_rng(s * 1000 + W)
    n = 37
    u16 = rng.integers(0, 1 << 16, (18, n))
    i32 = rng.integers(-2 ** 31, 2 ** 31, (18, n), dtype=np.int64)
    for hw, dt in ((u16, torch.uint16), (i32, torch.int32)):
        t = torch.from_numpy(hw.astype(np.int64)).to(dt)
        want = kernels.decompose_digits_plain(t, s, W, W + 3).numpy()
        assert np.array_equal(kernel_replay(hw, s, W, W + 3), want), dt


def test_rows_read():
    assert kernels.digits_rows(18, 16, 16) == 16
    assert kernels.digits_rows(18, 13, 20) == 17
    assert kernels.digits_rows(12, 16, 9) == 9
    assert kernels.digits_rows(16, 13, 20) == 16      # no row past H
    assert kernels.digits_rows(18, 16, 0) == 0


class FakeLib:
    def __init__(self):
        self.calls = []

    def msm_decompose_digits(self, hw, nb, ld, out, H, n, s, W, Wp, rows,
                             P, head, threads, vl, vs, st):
        self.calls.append((hw % 16, nb, ld, H, n, s, W, Wp, rows, P, head,
                           threads, vl, vs))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(kernels, "_on_cuda", lambda name, *a: True)
    monkeypatch.setattr(kernels, "_stream", lambda a: 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    kernels.reset_launches()
    return lib


def test_wrapper_hands_the_kernel_its_geometry(fake_card):
    """A slice at an odd column of a wider array, uint16 and int32; the
    full width; a width that takes the wider word."""
    for dt, eb in ((torch.uint16, 2), (torch.int32, 4)):
        wide = (1 << 17) * 8 // eb
        for N, lo, n in ((4096, 3, 129), (4096, 0, 4096), (4096, 3, 127),
                         (wide, 0, wide)):
            hw = torch.zeros((18, N), dtype=dt)
            fake_card.calls.clear()
            d = kernels.decompose_digits(hw[:, lo:lo + n], 13, 20, 22)
            assert d.shape == (22, n) and d.dtype == I16
            mis = hw[:, lo:].data_ptr() % 16
            geo = kernels.decompose_digits_geometry(n, N, eb, mis, 18, 13,
                                                    20)
            assert geo.points_per_thread == (8 if n == wide else 4) // eb
            assert fake_card.calls == [(mis, eb, N, 18, n, 13, 20, 22, 17,
                                        geo.points_per_thread, geo.head,
                                        geo.threads, int(geo.vector_loads),
                                        int(geo.vector_stores))]
            assert kernels.LAUNCHED["decompose_digits"] == geo._asdict()
            kernel_checks(geo, n, N, eb, mis)
