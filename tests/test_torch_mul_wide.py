"""The word-wide Montgomery multiply of csrc/mul_wide.cuh, replayed in
Python, and the launch geometry of csrc/padd_batch.cu.

`mul_words` below does the multiply's word arithmetic as the CUDA code
does it: Field::canon's int32 ripple, the canonical limbs packed into
32-bit words, CIOS rows of 64-bit multiply-adds split into a low and a
high word, one whole-word reduction per row for floor(L w / 32) rows,
then one reduction of the last L w mod 32 bits (none where L w is a
multiple of 32, BLS12_377_S12's 384: there t keeps a word more), and the
result unpacked to w-bit limbs. It must give `rows.mont_mul_rows` (the
twin of Field::mul, itself held against the JAX package) bit for bit on
TINY62, BN254_S12, BN254_S13, BLS12_377_S12 and BLS12_377_S13: over the
whole canonical range [0, 2^(L w)), at the edge values (up to 54p and
2^(L w) - 1), and on signed-lazy limbs from real `padd_rows` outputs. It also
counts its multiply halves, which `chip_smoke.py` takes for the kernels'
operations bound. `padd_lane` replays the padd kernel's phases on one
lane's shared words (p2 in T, the sum in p1's words, q.y negated on load
in q's dtype) against `padd_batch_plain` and `psub_batch_plain`."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from tpu_msm import constants as jc
from tpu_msm.ops import rows as jrows
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.ops import rows

torch.set_num_threads(1)

NAMES = ["tiny62", "bn254_s12", "bn254_s13", "bls12_377_s12",
         "bls12_377_s13"]
CURVES = {name: tc.CURVES[name] for name in NAMES}
JAX_CURVES = {name: jc.CURVES[name] for name in NAMES}
M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)


class Words:
    """Sizes of the multiply (mul_wide.cuh `Wide<L, W>`) and its
    constants, read from `kernels._wide_consts_host` in its layout."""

    def __init__(self, curve):
        L, w = curve.num_limbs, curve.log_limb_size
        self.L, self.w, self.bits = L, w, L * w
        self.N = -(-self.bits // 32)
        self.NF = self.NP = self.bits // 32
        self.RB = self.bits - 32 * self.NF
        self.TOP = self.N if self.RB else self.N + 1   # top word of t
        k = tk._wide_consts_host(curve)
        self.p = [np.uint64(v) for v in k[:self.NP]]
        self.n0 = np.uint64(k[self.NP])
        self.r2 = [np.uint64(v) for v in k[self.NP + 1:]]
        self.halves = 0      # 32-bit multiply halves of the last call


def canon(a: np.ndarray, w: int) -> np.ndarray:
    """Field::canon on (L, n) int32 limbs: int32 adds, arithmetic shift."""
    out = np.empty_like(a)
    c = np.zeros(a.shape[1:], np.int32)
    for i in range(a.shape[0]):
        s = a[i] + c
        out[i] = s & ((1 << w) - 1)
        c = s >> w
    return out


def pack(a: np.ndarray, K: Words) -> list:
    c = canon(a, K.w).astype(np.uint64)
    words = [np.zeros(a.shape[1:], np.uint64) for _ in range(K.N)]
    for i in range(K.L):
        bit = K.w * i
        k, off = bit >> 5, bit & 31
        words[k] = (words[k] | (c[i] << np.uint64(off))) & M32
        if off + K.w > 32:
            words[k + 1] |= c[i] >> np.uint64(32 - off)
    return words


def unpack(r: list, K: Words) -> np.ndarray:
    out = []
    for i in range(K.L):
        bit = K.w * i
        k, off = bit >> 5, bit & 31
        v = r[k] >> np.uint64(off)
        if off + K.w > 32:
            v = v | ((r[k + 1] << np.uint64(32 - off)) & M32)
        out.append(v & np.uint64((1 << K.w) - 1))
    return np.stack(out).astype(np.int32)


def mac(K: Words, x, y, t, c):
    """s = x y + t + c on 32-bit words, as one 64-bit multiply-add: (low
    word, high word). Never exceeds 2^64 - 1."""
    K.halves += 2
    s = x * y + t + c
    assert (s >= x * y).all()                 # no uint64 wrap
    return s & M32, s >> S32


def add(t, c):
    s = t + c
    return s & M32, s >> S32


def mont(a: list, b: list, K: Words) -> list:
    N, NF, NP, RB, TOP = K.N, K.NF, K.NP, K.RB, K.TOP
    zero = np.zeros_like(a[0])
    t = [zero] * (TOP + 1)
    for i in range(N):
        if RB:
            assert not t[N].any()             # t < 2^(32 N) before a row
        else:
            assert (t[N] <= 1).all() and not t[N + 1].any()  # < 2^(32N+1)
        c = zero
        for j in range(N):
            t[j], c = mac(K, a[j], b[i], t[j], c)
        if RB:
            t[N] = c
        else:
            t[N], t[N + 1] = add(t[N], c)
        if i < NF:
            K.halves += 1
            m = (t[0] * K.n0) & M32
            _, c = mac(K, m, K.p[0], t[0], zero)
            for j in range(1, NP):
                t[j - 1], c = mac(K, m, K.p[j], t[j], c)
            for j in range(NP, TOP + 1):
                t[j - 1], c = add(t[j], c)
            t[TOP] = c
    if not RB:                                # every word reduced
        assert not t[N + 1].any()
        return t[:N]
    K.halves += 1
    m = (t[0] * K.n0) & np.uint64((1 << RB) - 1)
    c = zero
    for j in range(NP):
        t[j], c = mac(K, m, K.p[j], t[j], c)
    for j in range(NP, N + 1):
        t[j], c = add(t[j], c)
    assert not c.any()                        # t fits N + 1 words
    return [(t[k] >> np.uint64(RB)) | ((t[k + 1] << np.uint64(32 - RB)) & M32)
            for k in range(N)]


def mul_words(a: np.ndarray, b: np.ndarray, K: Words) -> np.ndarray:
    """mul_wide.cuh `mul_wide` on (L, n) int32 limbs."""
    K.halves = 0
    return unpack(mont(pack(a, K), pack(b, K), K), K)


def limbs(values, curve) -> np.ndarray:
    L, w = curve.num_limbs, curve.log_limb_size
    return np.array([tc.int_to_limbs(v, L, w) for v in values],
                    np.int32).T.copy()


def random_canonical(curve, rng, n) -> np.ndarray:
    """Canonical limbs of values drawn over the whole [0, 2^(L w))."""
    return rng.integers(0, 1 << curve.log_limb_size,
                        (curve.num_limbs, n)).astype(np.int32)


def edge_values(curve) -> list:
    p = curve.p
    return [0, 1, p - 1, p, 2 * p - 1, 32 * p, 54 * p, curve.mont_radix - 1]


def lazy_from_padd(curve, rng, n) -> np.ndarray:
    """Signed-lazy limbs of real padd_rows outputs: x, y and z of n sums of
    random lazy points, (L, 3 n)."""
    L, w = curve.num_limbs, curve.log_limb_size

    def lazy():
        a = rng.integers(-(1 << w) + 1, 1 << (w + 1), (3, L, n))
        a[:, L - 1] = np.abs(a[:, L - 1]) % 8 + 1
        return torch.from_numpy(a.astype(np.int32))

    p, q = lazy(), lazy()
    s = rows.padd_rows(rows.ProjRows(*p), rows.ProjRows(*q), curve)
    out = torch.cat([s.x, s.y, s.z], dim=1).numpy()
    assert ((out < 0) | (out >> w > 0)).any()  # not canonical limbs
    return out


def check(a: np.ndarray, b: np.ndarray, curve) -> None:
    got = mul_words(a, b, Words(curve))
    want = rows.mont_mul_rows(torch.from_numpy(a), torch.from_numpy(b),
                              curve).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_mul_words_random_canonical(name, seed):
    curve = CURVES[name]
    rng = np.random.default_rng(100 + seed)
    check(random_canonical(curve, rng, 512), random_canonical(curve, rng, 512),
          curve)


@pytest.mark.parametrize("name", NAMES)
def test_mul_words_edges(name):
    """Every pair of 0, 1, p - 1, p, 2p - 1, 32p and 2^(L w) - 1, also
    against the JAX package's mont_mul_rows."""
    curve = CURVES[name]
    e = edge_values(curve)
    a = limbs([x for x in e for _ in e], curve)
    b = limbs([y for _ in e for y in e], curve)
    check(a, b, curve)
    want = np.asarray(jnp.stack(jrows.mont_mul_rows(
        list(jnp.asarray(a)), list(jnp.asarray(b)), JAX_CURVES[name])))
    assert np.array_equal(mul_words(a, b, Words(curve)), want)


@pytest.mark.parametrize("name", NAMES)
def test_mul_words_lazy_padd_outputs(name):
    curve = CURVES[name]
    rng = np.random.default_rng(7)
    a = lazy_from_padd(curve, rng, 96)
    b = np.roll(a, 5, axis=1)
    check(a, b, curve)
    check(a, a, curve)


@pytest.mark.parametrize("name", NAMES)
def test_encode_by_r2_words(name):
    """encode_mont multiplies by the pre-packed words of R^2: the same as
    packing R^2's limbs, and as to_mont_rows."""
    curve = CURVES[name]
    K = Words(curve)
    x = random_canonical(curve, np.random.default_rng(3), 64)
    x[:, :3] = limbs([0, 1, curve.p - 1], curve)
    r2 = limbs([curve.r2_mod_p], curve)
    assert [int(v[0]) for v in pack(r2, K)] == [int(v) for v in K.r2]
    got = unpack(mont(pack(x, K), [np.full(64, v) for v in K.r2], K), K)
    want = rows.to_mont_rows(torch.from_numpy(x), curve).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,L,w,halves", [
    ("tiny62", 6, 12, 33), ("bn254_s12", 22, 12, 315),
    ("bn254_s13", 21, 13, 315), ("bls12_377_s12", 32, 12, 588),
    ("bls12_377_s13", 30, 13, 663)])
def test_wide_constants_and_operation_count(name, L, w, halves):
    curve = CURVES[name]
    K = Words(curve)
    p = sum(int(v) << (32 * k) for k, v in enumerate(K.p))
    assert p == curve.p and (int(K.n0) * curve.p + 1) % (1 << 32) == 0
    r2 = sum(int(v) << (32 * k) for k, v in enumerate(K.r2))
    assert r2 == pow(2, 2 * L * w, curve.p)
    mul_words(limbs([1], curve), limbs([2], curve), K)
    assert K.halves == halves == chip_smoke.mul_wide_mads(L, w)
    assert chip_smoke.mont_mul_ops(L) == 2 * L * (2 * L + 2)
    assert len(tk._wide_consts_host(curve)) == K.NP + 1 + K.N
    assert (K.N, K.NF, K.RB) == {
        "tiny62": (3, 2, 8), "bn254_s12": (9, 8, 8), "bn254_s13": (9, 8, 17),
        "bls12_377_s12": (12, 12, 0), "bls12_377_s13": (13, 12, 6)}[name]


def test_wide_constants_refuse_other_layouts():
    """p must fit the whole words: BN254 on 21 limbs of 12 bits (252
    bits, 7 whole words) is refused; L w a multiple of 32 is not (BN254's
    16 limbs of 16 bits: 8 words, p < 2^256)."""
    with pytest.raises(ValueError):
        tk._wide_consts_host(dataclasses.replace(tc.BN254, num_limbs=21,
                                                 log_limb_size=12))
    assert tk._wide_consts_host(tc.BN254)[:8] == [
        (tc.BN254.p >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


# ---------------------------------------------------------------------------
# the padd kernel's phases on one lane's shared words
# ---------------------------------------------------------------------------


def padd_lane(p: np.ndarray, q: np.ndarray, curve, negate: bool,
              dtype) -> np.ndarray:
    """csrc/padd_batch.cu on (3, L, n) points: the lane's words m (p1,
    P, T), the load (q.y -> 4p - y in q's dtype), the four phases with
    every product and limb that the G threads share out, the sum from
    p1's words."""
    L = curve.num_limbs
    K = Words(curve)
    kp = lambda k: limbs([k * curve.p], curve)[:, 0]
    kp2, kp4, kp6b = kp(2), kp(4), kp(2 * 3 * curve.b_coeff)
    b3 = 3 * curve.b_coeff
    n = p.shape[-1]
    P1, P, T = 0, 3 * L, 9 * L
    m = np.zeros((15 * L, n), np.int32)
    m[P1:P1 + 3 * L] = p.reshape(3 * L, n)
    qq = q.reshape(3 * L, n).copy()
    if negate:
        y = (kp4[:, None].astype(np.uint32)
             - qq[L:2 * L].astype(np.int32).astype(np.uint32))
        qq[L:2 * L] = y.astype(dtype)
    m[T:T + 3 * L] = qq
    seg = lambda off, j: slice(off + j * L, off + (j + 1) * L)
    for j in range(6):                                   # level 1
        a, b = m[seg(P1, j % 3)], m[seg(T, j % 3)]
        if j >= 3:
            u, v = (L if j == 4 else 0), (L if j == 3 else 2 * L)
            m[seg(P, j)] = m[P1 + u:P1 + u + L] + m[P1 + v:P1 + v + L]
            m[seg(T, j)] = m[T + u:T + u + L] + m[T + v:T + v + L]
            a, b = m[seg(P, j)], m[seg(T, j)]
        m[seg(P, j)] = mul_words(a, b, K)
    pr = [m[seg(P, j)].copy() for j in range(6)]         # mid
    t2 = pr[2] * np.int32(b3)
    m[seg(T, 0)] = pr[3] - (pr[0] + pr[1]) + kp4[:, None]
    m[seg(T, 1)] = pr[4] - (pr[1] + pr[2]) + kp4[:, None]
    m[seg(T, 2)] = pr[1] - t2 + kp6b[:, None]
    m[seg(T, 3)] = (pr[5] - (pr[0] + pr[2]) + kp4[:, None]) * np.int32(b3)
    m[seg(T, 4)] = pr[1] + t2
    m[seg(T, 5)] = pr[0] * np.int32(3)
    for j in range(6):                                   # level 2
        b = j + 2 if j < 4 else 5 - j
        m[seg(P, j)] = mul_words(m[seg(T, j)], m[seg(T, b)], K)
    m[seg(P1, 0)] = m[seg(P, 0)] - m[seg(P, 1)] + kp2[:, None]   # finish
    m[seg(P1, 1)] = m[seg(P, 2)] + m[seg(P, 3)]
    m[seg(P1, 2)] = m[seg(P, 4)] + m[seg(P, 5)]
    return m[P1:P1 + 3 * L].reshape(3, L, n)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_padd_lane_phases(name, negate, dtype):
    """The kernel's phases give padd_batch_plain / psub_batch_plain bit for
    bit, on lazy points with limbs at both ends of the (-2^w, 2^(w+1))
    ledger, a point at infinity on either side, P + P and P + (-P)."""
    curve = CURVES[name]
    L, w = curve.num_limbs, curve.log_limb_size
    rng = np.random.default_rng(11)
    n = 24
    pts = rng.integers(-(1 << w) + 1, 1 << (w + 1), (2, 3, L, n))
    ends = rng.random((2, 3, L, n)) < 0.3
    pts = np.where(ends, np.where(rng.random(ends.shape) < 0.5,
                                  -(1 << w) + 1, (1 << (w + 1)) - 1), pts)
    pts[:, :, L - 1] = np.abs(pts[:, :, L - 1]) % 8 + 1
    p, q = pts.astype(dtype)
    inf = tk.inf_stacked(curve, ()).numpy().astype(dtype)
    p[..., 0], q[..., 1] = inf, inf                      # infinity each side
    q[..., 2] = p[..., 2]                                # P + P
    q[..., 3] = tk.pneg_stacked(torch.from_numpy(p[..., 3]), curve).numpy()
    got = padd_lane(p, q, curve, negate, dtype)
    plain = tk.psub_batch_plain if negate else tk.padd_batch_plain
    want = plain(torch.from_numpy(p), torch.from_numpy(q), curve).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got.astype(np.int16), plain(
        torch.from_numpy(p), torch.from_numpy(q), curve,
        torch.int16).numpy())


# ---------------------------------------------------------------------------
# padd_batch_geometry
# ---------------------------------------------------------------------------

SHARED_MAX = 232_448          # 227 KB a block on the H100


@pytest.mark.parametrize("F", [1, 2, 5, 16, 17, 37, 333, 660, 661, 2_640,
                               16_388, 32_769, 1 << 20])
@pytest.mark.parametrize("sms", [132, 4])
def test_padd_geometry_fits_and_covers(F, sms):
    for name in CURVES:
        c = CURVES[name]
        geo = tk.padd_batch_geometry(F, sms, c.num_limbs, c.log_limb_size)
        per_warp = 32 // tk.PADD_THREADS_PER_LANE
        assert geo.threads_per_lane == tk.PADD_THREADS_PER_LANE == 6
        assert 1 <= geo.warps <= tk.PADD_MAX_WARPS
        assert geo.threads == 32 * geo.warps <= 1024
        assert geo.lanes_per_block == geo.warps * per_warp
        assert geo.shared_bytes <= SHARED_MAX
        # every lane in exactly one block, no empty block
        assert (geo.blocks - 1) * geo.lanes_per_block < F
        assert geo.blocks * geo.lanes_per_block >= F
        # the fewest warps a block that keep to one block an SM
        if geo.warps < tk.PADD_MAX_WARPS:
            assert geo.blocks <= sms
        if geo.warps > 1:
            assert -(-F // ((geo.warps - 1) * per_warp)) > sms


def test_padd_geometry_refuses_bad_launches():
    with pytest.raises(ValueError):
        tk.padd_batch_geometry(0, 132)
    with pytest.raises(ValueError):
        tk.padd_batch_geometry(8, 0)
