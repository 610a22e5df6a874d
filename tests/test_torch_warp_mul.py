"""The warp multiply of csrc/batch_inv.cuh (`WarpMul`, the root's Fermat
chain of `batch_inverse` and `to_affine`), replayed lane by lane.

`warp_mul` below runs the kernel's code on 32 lanes of numpy words, as
the threads compute them: each lane's column of t = a b, the low and
the high words of its products summed apart in 64 bits, three sums at
once; t folded to words and small carries (`fold`: the high sums moved
up a lane and added);
the columns of M = t p' mod R from those, made words by `resolve` (the
fold, the small carry moved up a lane, the ripple through words of all
ones from two ballots); u = t + M p on t's columns, resolved; the
quotient's words from lanes NF + k and NF + k + 1. It must give
`Tree::mul`'s words (mul_wide.cuh's CIOS, replayed as `mont` in
tests/test_torch_mul_wide.py, its top word cut to R = 2^(L w)) and
`rows.mont_mul_rows` bit for bit on TINY62, BN254_S12, BN254_S13,
BLS12_377_S12 and BLS12_377_S13, for operands below R: over
the whole range, at the edge values, on the packed words of lazy
`padd_rows` outputs; its 64-bit sums stay far from wrapping, the
resolve's carries take the cases its comment allows, and u's low L w
bits are zero. Then `fermat`, the chain of warp multiplies, against the
one-thread chain of `mont` on the same roots, and the constants' words
(p' = -p^-1 mod 2^(32 N)) in `kernels._affine_consts_host`."""

import numpy as np
import pytest
import torch

from test_torch_mul_wide import (CURVES, NAMES, Words, edge_values,
                                 lazy_from_padd, limbs, mont, pack,
                                 random_canonical, unpack)
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.ops import rows

torch.set_num_threads(1)

M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
LANES = 32


class Warp:
    """Sizes and the per-lane constants of `WarpMul<L, W>`."""

    def __init__(self, curve):
        self.K = K = Words(curve)
        self.N, self.NF, self.NP, self.RB = K.N, K.NF, K.NP, K.RB
        words = tk._affine_consts_host(curve)
        N = self.N
        base = K.NP + 1 + N                    # after WideConsts, one
        self.one = [int(v) for v in words[base:base + N]]
        self.e = [int(v) for v in words[base + N:base + 2 * N]]
        self.pinv = [int(v) for v in words[base + 2 * N:base + 3 * N]]
        self.nbits = int(words[base + 3 * N])
        p = [int(v) for v in K.p]
        # lane k, product i: p_(k - i) and p'_(k - i), zero off the words
        self.cp = np.zeros((LANES, N), np.uint64)
        self.cq = np.zeros((LANES, N), np.uint64)
        self.cq1 = np.zeros((LANES, N), np.uint64)
        for k in range(LANES):
            for i in range(N):
                j = k - i
                if 0 <= j < self.NP:
                    self.cp[k, i] = p[j]
                if 0 <= j < N:
                    self.cq[k, i] = self.pinv[j]
                if 0 <= j - 1 < N:
                    self.cq1[k, i] = self.pinv[j - 1]


def up(v: np.ndarray, d: int) -> np.ndarray:
    """__shfl_up_sync by d with the kernel's zero below lane d."""
    out = np.zeros_like(v)
    out[d:] = v[:LANES - d]
    return out


def down(v: np.ndarray, d: int) -> np.ndarray:
    """__shfl_down_sync by d: a lane past 31 keeps its own value."""
    out = v.copy()
    out[:LANES - d] = v[d:]
    return out


def mad(s, x, y):
    """s += x y on (a, b): the product's low word into a, its high word
    into b, each a 64-bit sum."""
    a, b = s
    p = x * y
    a, b = a + (p & M32), b + (p >> S32)
    assert (a < np.uint64(1 << 40)).all() and (b < np.uint64(1 << 40)).all()
    return a, b


def add(s, o):
    return s[0] + o[0], s[1] + o[1]


def fold(s):
    """`WarpMul::fold`: lane k's (w, g), w + 2^32 g = a_k + b_(k-1)."""
    a, b = s
    s1 = a + up(b, 1)
    w, g = s1 & M32, s1 >> S32
    assert (g < np.uint64(1 << 32)).all()
    return w, g


def resolve(s) -> np.ndarray:
    """`WarpMul::resolve` on (32, n) columns: word k of sum_j col_j
    2^(32 j)."""
    w, g = fold(s)
    s3 = w + up(g, 1)
    w, c = s3 & M32, s3 >> S32
    assert (c <= 1).all()
    assert not ((c != 0) & (w == M32)).any()   # carry out or pass, not both
    bit = (np.uint64(1) << np.arange(LANES, dtype=np.uint64))[:, None]
    gen = ((c != 0) * bit).sum(axis=0).astype(np.uint64)
    pas = ((w == M32) * bit).sum(axis=0).astype(np.uint64)
    x = gen | pas
    cin = ((x + gen) & M32) ^ x ^ gen
    return (w + ((cin[None] >> np.arange(LANES, dtype=np.uint64)[:, None])
                 & np.uint64(1))) & M32


def mul_u(a: list, bs: np.ndarray, W: Warp) -> np.ndarray:
    """`WarpMul::mul`: a's N words in every lane (a list of (n,) arrays),
    bs (32, N, n) with bs[k, i] = b_(k - i); returns u = a b + M p, word
    k in lane k."""
    N, NF, RB = W.N, W.NF, W.RB
    n = bs.shape[2]
    lane = np.arange(LANES)[:, None]
    z = np.zeros((LANES, n), np.uint64)
    sum3 = lambda c: add(add(c[0], c[1]), c[2])
    t3 = [(z, z)] * 3
    for i in range(N):
        t3[i % 3] = mad(t3[i % 3], a[i][None], bs[:, i])
    t = sum3(t3)
    # M = t p' mod R from t's fold; every lane reads the words published
    w, g = fold(t)
    m3 = [(z, z)] * 3
    for i in range(N):
        m3[i % 3] = mad(m3[i % 3], w[i][None], W.cq[:, i][:, None])
        m3[(i + 1) % 3] = mad(m3[(i + 1) % 3], g[i][None],
                              W.cq1[:, i][:, None])
    mk = np.where(lane >= N, np.uint64(0), resolve(sum3(m3)))
    if RB:
        mk[N - 1] &= np.uint64((1 << RB) - 1)
    # u = t + M p on t's columns
    u3 = [t, (z, z), (z, z)]
    for i in range(N):
        u3[(i + 1) % 3] = mad(u3[(i + 1) % 3], mk[i][None],
                              W.cp[:, i][:, None])
    uk = resolve(sum3(u3))
    # u = a b + M p is a multiple of R, and below 2^(64 N + 2)
    assert not uk[:NF].any() and not uk[2 * N + 2:].any()
    if RB:
        assert not (uk[NF] & np.uint64((1 << RB) - 1)).any()
    return uk


def word_at(uk: np.ndarray, j: np.ndarray, W: Warp) -> np.ndarray:
    """`WarpMul::word_at`: in lane l, word j[l] of u / R mod R (zero for
    j outside 0 .. N - 1), from lanes NF + j and NF + j + 1."""
    N, NF, RB = W.N, W.NF, W.RB
    src = np.maximum(j, 0)[:, None] + np.zeros((1, uk.shape[1]), int)
    if RB:
        lo = np.take_along_axis(uk, np.clip(NF + src, 0, 31), 0)
        hi = np.take_along_axis(uk, np.clip(NF + src + 1, 0, 31), 0)
        r = ((hi << np.uint64(32 - RB)) | (lo >> np.uint64(RB))) & M32
        r = np.where((j == N - 1)[:, None], r & np.uint64((1 << RB) - 1), r)
    else:
        r = np.take_along_axis(uk, np.clip(N + src, 0, 31), 0)
    return np.where(((j >= 0) & (j < N))[:, None], r, np.uint64(0))


def shifted(bk: np.ndarray, W: Warp) -> np.ndarray:
    """bs[k, i] = b_(k - i) from lanes of b's words (zero from N up)."""
    return np.stack([up(bk, i) for i in range(W.N)], axis=1)


def words(uk: np.ndarray, W: Warp) -> list:
    """`WarpMul::words`: the N words of u / R mod R in every lane."""
    return [word_at(uk, np.full(LANES, i), W)[0] for i in range(W.N)]


def warp_mul(a: list, bk: np.ndarray, W: Warp) -> np.ndarray:
    """Tree::mul(a, b) on the warp: word k in lane k, zero from N up."""
    uk = mul_u(a, shifted(bk, W), W)
    got = word_at(uk, np.arange(LANES), W)
    # every lane's copy agrees with the lanes' own words
    assert np.array_equal(np.stack(words(uk, W)), got[:W.N])
    return got


def lanes_of(words: list) -> np.ndarray:
    """N words of n values as the warp holds them: (32, n), zero from N
    up."""
    out = np.zeros((LANES, words[0].shape[0]), np.uint64)
    out[:len(words)] = np.stack(words)
    return out


def tree_mul(a: list, b: list, W: Warp) -> list:
    """Tree::mul: mont's words, the top word cut to R."""
    r = mont(a, b, W.K)
    if W.RB:
        r = r[:-1] + [r[-1] & np.uint64((1 << W.RB) - 1)]
    return r


def check(a_limbs: np.ndarray, b_limbs: np.ndarray, curve) -> None:
    W = Warp(curve)
    a, b = pack(a_limbs, W.K), pack(b_limbs, W.K)
    got = warp_mul(a, lanes_of(b), W)
    want = tree_mul(a, b, W)
    assert np.array_equal(got[:W.N], np.stack(want))
    # the same words with a and b swapped (the chain multiplies a by a
    # and a by x)
    assert np.array_equal(warp_mul(b, lanes_of(a), W), got)
    limbs_out = unpack(list(got[:W.N]), W.K)
    ref = rows.mont_mul_rows(torch.from_numpy(a_limbs),
                             torch.from_numpy(b_limbs), curve).numpy()
    assert np.array_equal(limbs_out, ref)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_warp_mul_random(name, seed):
    """Operands over the whole range below R."""
    curve = CURVES[name]
    rng = np.random.default_rng(300 + seed)
    check(random_canonical(curve, rng, 256), random_canonical(curve, rng, 256),
          curve)


@pytest.mark.parametrize("name", NAMES)
def test_warp_mul_edges(name):
    """Every pair of 0, 1, p - 1, p, 2p - 1, 32p, 54p and R - 1, and words
    of all ones where R allows them."""
    curve = CURVES[name]
    e = edge_values(curve)
    check(limbs([x for x in e for _ in e], curve),
          limbs([y for _ in e for y in e], curve), curve)


@pytest.mark.parametrize("name", NAMES)
def test_warp_mul_lazy_padd_outputs(name):
    """The packed words of signed-lazy limbs (the tree's leaves are
    packed so)."""
    curve = CURVES[name]
    a = lazy_from_padd(curve, np.random.default_rng(8), 64)
    check(a, np.roll(a, 3, axis=1), curve)
    check(a, a, curve)


@pytest.mark.parametrize("name", NAMES)
def test_fermat_chain(name):
    """`WarpMul::fermat`: from the Montgomery one, a squaring a bit of
    p - 2 from the top, a product with x where it is set; the words of
    the one-thread chain (Tree::mul on the same operands) on 3 roots,
    and x times its inverse is one."""
    curve = CURVES[name]
    W = Warp(curve)
    rng = np.random.default_rng(9)
    x_limbs = random_canonical(curve, rng, 3)
    x_limbs[:, 0] = limbs([curve.r_mod_p], curve)[:, 0]   # the one itself
    x = pack(x_limbs, W.K)
    one = [np.full(3, v, np.uint64) for v in W.one]
    ak, a = lanes_of(one), one
    ref = one
    e = curve.p - 2
    assert W.nbits == e.bit_length()
    assert sum(v << (32 * k) for k, v in enumerate(W.e)) == e
    k = np.arange(LANES)
    bs, xs = shifted(ak, W), shifted(lanes_of(x), W)
    for i in range(W.nbits - 1, -1, -1):
        uk = mul_u(a, bs, W)                          # a a
        a = words(uk, W)
        ref = tree_mul(ref, ref, W)
        if (W.e[i >> 5] >> (i & 31)) & 1:
            uk = mul_u(a, xs, W)                      # (a a) x
            a = words(uk, W)
            ref = tree_mul(ref, x, W)
        bs = np.stack([word_at(uk, k - j, W) for j in range(W.N)], axis=1)
    got = word_at(uk, k, W)
    assert not got[W.N:].any()
    assert np.array_equal(got[:W.N], np.stack(ref))
    val = lambda ws, j: sum(int(w[j]) << (32 * k) for k, w in enumerate(ws))
    R = curve.mont_radix
    for j in range(3):
        xv, iv = val(x, j), val(a, j)
        # Montgomery: x R^-1 times iv R^-1 is one, in R's units
        assert (xv * iv) % curve.p == (R * R) % curve.p


@pytest.mark.parametrize("name", NAMES)
def test_tree_consts(name):
    """TreeConsts<L, W>: WideConsts, R mod p, p - 2, p' = -p^-1 mod
    2^(32 N) in N words each, the bit length last; p p' = -1 mod
    2^(32 N), and the warp's 2 N + 2 lanes fit in 32."""
    curve = CURVES[name]
    W = Warp(curve)
    N = W.N
    assert len(tk._affine_consts_host(curve)) == W.NP + 1 + 4 * N + 1
    val = lambda ws: sum(v << (32 * k) for k, v in enumerate(ws))
    assert val(W.one) == curve.r_mod_p
    assert (curve.p * val(W.pinv) + 1) % (1 << (32 * N)) == 0
    assert 2 * N + 2 <= LANES
