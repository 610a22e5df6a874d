"""Edges of `col_prefix` and `prefix_scan` that the launch geometries of
their CUDA kernels add, on CPU tensors.

The plain versions against the JAX package, bit for bit, as in
test_torch_kernels.py (TINY62: the Pallas kernels in interpret mode;
BN254_S12 and, for the scan, BN254_S13's odd L: tpu_msm/ops/rows.py run
eagerly), on real curve points:
`col_prefix` at C = 1, C = 2 and Wg = 3, with columns at infinity, two
equal neighbouring columns (the add is a doubling) and a column followed
by its negative (the running sum passes through infinity); `prefix_scan`
at R = 1, with the same point twice in a row and a point followed by its
negative in one lane. And the two launch geometries, which are pure
functions: every column and lane covered exactly once, never more blocks
than the card can hold resident (col_prefix: a column a lane of six
threads, tests/test_torch_scan_wide.py holds the rest)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm.ops import rows as jrows
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.reference import curve as ref

torch.set_num_threads(1)

CURVES = {"tiny62": (jc.TINY62, tc.TINY62),
          "bn254_s12": (jc.BN254_S12, tc.BN254_S12),
          "bn254_s13": (jc.BN254_S13, tc.BN254_S13)}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jstack(p):
    return np.asarray(jnp.stack([jnp.stack(p.x), jnp.stack(p.y),
                                 jnp.stack(p.z)]))


def jproj(a):
    a = jnp.asarray(a, jnp.int32)
    return jrows.ProjRows(*(jrows.from_stacked(a[c]) for c in range(3)))


def affine_multiples(curve, count):
    """Affine k * generator for k = 1..count."""
    g = (curve.gen_x, curve.gen_y, 1)
    acc, out = g, []
    for _ in range(count):
        out.append(ref.to_affine(curve, acc))
        acc = ref.add(curve, acc, g)
    return out


def mont_limbs(curve, v):
    return tc.int_to_limbs(curve.to_mont(v), curve.num_limbs,
                           curve.log_limb_size)


def stacked_column(curve, pt):
    """(3, L) Montgomery limbs of an affine point, of ("neg", point), or of
    None (infinity: 0 : 1 : 0)."""
    if pt is None:
        x, y, z = 0, 1, 0
    elif pt[0] == "neg":
        x, y, z = pt[1][0], curve.p - pt[1][1], 1
    else:
        x, y, z = pt[0], pt[1], 1
    return np.array([mont_limbs(curve, v) for v in (x, y, z)], np.int16)


# ---------------------------------------------------------------------------
# col_prefix
# ---------------------------------------------------------------------------


def col_inputs(curve, case):
    P = affine_multiples(curve, 8)
    neg = lambda p: ("neg", p)
    windows = {
        "C1": [[P[0]]],
        "C2": [[P[0], P[1]], [P[2], None]],
        "Wg3_infinity": [[None, P[0], None, None, P[1], P[2], None, P[3]],
                         [None] * 8,
                         [P[4], None, P[5], None, P[6], None, P[7], None]],
        "Wg3_equal_neighbours": [[P[0], P[0], P[1], P[1], P[1], P[2], P[3],
                                  P[3]],
                                 [P[2]] * 8,
                                 [P[0], P[1], P[2], P[2], P[4], P[5], P[5],
                                  P[6]]],
        "Wg3_negative_follows": [[P[0], neg(P[0]), P[1], P[2], neg(P[2]),
                                  neg(P[1]), P[3], P[4]],
                                 [P[5], neg(P[5])] * 4,
                                 [None, P[6], neg(P[6]), None, P[7], P[7],
                                  neg(P[7]), neg(P[7])]],
    }[case]
    cols = np.array([[stacked_column(curve, p) for p in w] for w in windows])
    return np.ascontiguousarray(cols.transpose(2, 3, 0, 1))    # (3, L, Wg, C)


def col_prefix_by_rows(coltot, J):
    """The TPU kernel's level order, replayed with eager JAX rows."""
    _, _, Wg, C = coltot.shape
    inf = np.asarray(jk.inf_stacked(J, (Wg, C)))
    v = np.concatenate([inf[..., :1], coltot[..., :-1].astype(np.int32)], -1)
    for lv in range(max(C.bit_length() - 1, 1)):
        k = 1 << lv
        sh = np.concatenate([inf[..., :k], v[..., :C - k]], -1)[..., :C]
        v = jstack(jrows.padd_rows(jproj(v), jproj(sh), J))
    return v.astype(np.int16)


COL_CASES = ["C1", "C2", "Wg3_infinity", "Wg3_equal_neighbours",
             "Wg3_negative_follows"]


@pytest.mark.parametrize("case", COL_CASES)
def test_col_prefix_edges_tiny_vs_pallas(case):
    J, T = CURVES["tiny62"]
    coltot = col_inputs(T, case)
    want = np.asarray(jk.col_prefix(jnp.asarray(coltot), J))
    got = tk.col_prefix(t(coltot), T)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", COL_CASES)
def test_col_prefix_edges_s12_vs_rows(case):
    J, T = CURVES["bn254_s12"]
    coltot = col_inputs(T, case)
    got = tk.col_prefix(t(coltot), T)
    assert np.array_equal(got.numpy(), col_prefix_by_rows(coltot, J))


@pytest.mark.parametrize("name", ["tiny62", "bn254_s12"])
def test_col_prefix_sum_passes_through_infinity(name):
    """The case means what it says: after P, -P the exclusive prefix is the
    point at infinity (Z = 0 in the group), and it recovers afterwards."""
    _, T = CURVES[name]
    got = tk.col_prefix(t(col_inputs(T, "Wg3_negative_follows")), T)
    w = T.log_limb_size
    val = lambda limbs: sum(int(v) << (w * i) for i, v in enumerate(limbs))
    z = [val(got[2, :, 0, c].tolist()) % T.p for c in range(8)]
    assert z[2] == 0 and z[6] == 0 and z[1] != 0 and z[3] != 0 and z[7] != 0


# ---------------------------------------------------------------------------
# prefix_scan
# ---------------------------------------------------------------------------


def scan_inputs(curve, Wg, C, R, case):
    """A table of real points and per-window payloads idx << 1 | sign."""
    n = C * R
    P = affine_multiples(curve, n)
    X = np.array([mont_limbs(curve, x) for x, _ in P], np.int32).T   # (L, n)
    Y = np.array([mont_limbs(curve, y) for _, y in P], np.int32).T
    rng = np.random.default_rng(R * 100 + C)
    pay = np.stack([(rng.permutation(n) << 1) | rng.integers(0, 2, n)
                    for _ in range(Wg)])
    a = pay[:, 0] & ~1
    pay[:, 0] = a
    if case == "twice_in_a_row":                 # lane 0: a, a -> doubling
        pay[:, 1] = a
    elif case == "negative_follows":             # lane 0: a, -a -> infinity
        pay[:, 1] = a | 1
        if R > 3:
            pay[:, 2], pay[:, 3] = a | 1, a      # -a, then back to infinity
    rows16 = np.concatenate([X, Y]).T.astype(np.int16)               # (n, 2L)
    return X, Y, pay.astype(np.int32), rows16


def scan_by_pallas(J, X, Y, pay, Wg, C, R):
    L, F = J.num_limbs, Wg * C
    F8, n8 = F // 8, R * F // 8
    p8 = (pay.reshape(Wg, C, R).transpose(2, 0, 1).reshape(R, 8, F8)
          .swapaxes(0, 1).reshape(8, n8))
    perm8, sign8 = p8 >> 1, p8 & 1
    sx8 = X[:, perm8].reshape(L * 8, n8)
    sy8 = Y[:, perm8].reshape(L * 8, n8)
    tb = np.asarray(jk.prefix_scan(jnp.asarray(sx8), jnp.asarray(sy8),
                                   jnp.asarray(sign8), J, F8, unroll=1))
    return (tb.reshape(3, L, 8, R, F8).transpose(0, 1, 3, 2, 4)
            .reshape(3, L, R, F))


def scan_by_rows(J, X, Y, pay, Wg, C, R):
    pos = np.arange(C) * R
    acc = jrows.proj_infinity_rows(J, jnp.zeros(Wg * C, jnp.int32))
    steps = []
    for r in range(R):
        v = pay[:, pos + r].reshape(-1)
        x = jrows.from_stacked(jnp.asarray(X[:, v >> 1]))
        y = jrows.from_stacked(jnp.asarray(Y[:, v >> 1]))
        y = jrows.select_rows(jnp.asarray((v & 1) != 0),
                              jrows.neg_rows(y, J, 2), y)
        acc = jrows.pmadd_rows(acc, x, y, J)
        steps.append(jstack(acc))
    return np.stack(steps, axis=2).astype(np.int16)


SCAN_CASES = [("R1", 1), ("twice_in_a_row", 2), ("negative_follows", 4)]


@pytest.mark.parametrize("case,R", SCAN_CASES)
def test_prefix_scan_edges_tiny_vs_pallas(case, R):
    J, T = CURVES["tiny62"]
    Wg, C = 2, 4
    X, Y, pay, rows16 = scan_inputs(T, Wg, C, R, case)
    got = tk.prefix_scan(t(rows16), t(pay), T, C)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), scan_by_pallas(J, X, Y, pay, Wg, C, R))


@pytest.mark.parametrize("case,R", SCAN_CASES)
def test_prefix_scan_edges_s12_vs_pmadd_chain(case, R):
    J, T = CURVES["bn254_s12"]
    Wg, C = 3, 2
    X, Y, pay, rows16 = scan_inputs(T, Wg, C, R, case)
    got = tk.prefix_scan(t(rows16), t(pay), T, C)
    assert np.array_equal(got.numpy(), scan_by_rows(J, X, Y, pay, Wg, C, R))


@pytest.mark.parametrize("case,R", SCAN_CASES)
def test_prefix_scan_edges_s13_vs_pmadd_chain(case, R):
    """BN254_S13: L = 21 limbs of 13 bits, whose 84-byte rows the kernel
    copies in 4-byte pieces, and whose multiply takes the mid-loop fold."""
    J, T = CURVES["bn254_s13"]
    Wg, C = 3, 2
    X, Y, pay, rows16 = scan_inputs(T, Wg, C, R, case)
    got = tk.prefix_scan(t(rows16), t(pay), T, C)
    assert np.array_equal(got.numpy(), scan_by_rows(J, X, Y, pay, Wg, C, R))


def test_prefix_scan_lane_passes_through_infinity():
    _, T = CURVES["bn254_s12"]
    Wg, C, R = 3, 2, 4
    _, _, pay, rows16 = scan_inputs(T, Wg, C, R, "negative_follows")
    got = tk.prefix_scan(t(rows16), t(pay), T, C)
    w = T.log_limb_size
    val = lambda limbs: sum(int(v) << (w * i) for i, v in enumerate(limbs))
    for wl in range(Wg):                          # lane f = wl * C
        z = [val(got[2, :, r, wl * C].tolist()) % T.p for r in range(R)]
        assert z[0] != 0 and z[1] == 0 and z[2] != 0 and z[3] == 0


def test_prefix_scan_threads_per_lane_is_a_launch_choice():
    """A number of threads per lane that the kernel is not built for is
    refused wherever the tensors lie; one it is built for changes nothing
    in the result, which is the Pallas kernel's."""
    J, T = CURVES["tiny62"]
    Wg, C, R = 2, 4, 2
    X, Y, pay, rows16 = scan_inputs(T, Wg, C, R, "twice_in_a_row")
    for G in (0, 1, 3, 4, 12):
        with pytest.raises(ValueError):
            tk.prefix_scan(t(rows16), t(pay), T, C, _threads_per_lane=G)
    want = scan_by_pallas(J, X, Y, pay, Wg, C, R)
    for G in tk.SCAN_THREADS_PER_LANE:
        got = tk.prefix_scan(t(rows16), t(pay), T, C, _threads_per_lane=G)
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# launch geometries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Wg,C,sms,per_sm,threads", [
    (1, 1, 132, 6, 64), (1, 2, 132, 6, 64), (3, 32, 132, 6, 64),
    (4, 2048, 132, 6, 64), (1, 8192, 132, 6, 64), (16, 8192, 132, 6, 64),
    (16, 8192, 132, 1, 64), (5, 8192, 7, 3, 64), (3, 4, 1, 1, 32)])
def test_col_prefix_geometry_covers_every_column_once(Wg, C, sms, per_sm,
                                                      threads):
    geo = tk.col_prefix_geometry(Wg, C, sms, per_sm, threads)
    blocks, per = geo.blocks, geo.columns_per_lane
    total, nlanes = Wg * C, blocks * geo.lanes_per_block
    assert 1 <= blocks <= sms * per_sm
    assert geo.lanes_per_block == (threads // 32) * (32 // 6)
    # lane l of the grid walks columns l, l + nlanes, ... below total (the
    # kernel's loop): each column once, the busiest lane `per` columns
    owner = np.concatenate([np.arange(lane, total, nlanes)
                            for lane in range(nlanes)])
    assert np.array_equal(np.sort(owner), np.arange(total))
    assert per == max(len(range(lane, total, nlanes))
                      for lane in range(min(nlanes, total)))
    # no block is idle unless the card has more room than columns
    assert (blocks - 1) * geo.lanes_per_block < total


def test_col_prefix_geometry_refuses_no_resident_block():
    with pytest.raises(ValueError):
        tk.col_prefix_geometry(1, 8192, 132, 0, 64)


@pytest.mark.parametrize("lanes,sms,want_G", [
    (32, 132, 6), (111, 132, 6), (2048, 132, 6), (4096, 132, 6),
    (5280, 132, 6), (5285, 132, 6), (7920, 132, 6), (7921, 132, 2),
    (8192, 132, 2), (8448, 132, 2),
    (8449, 132, 6), (16384, 132, 6), (131072, 132, 6), (8192, 66, 6),
    (1, 1, 6)])
def test_prefix_scan_geometry_rule_and_cover(lanes, sms, want_G):
    G, blocks, per_block = tk.prefix_scan_geometry(lanes, sms)
    assert G == want_G
    warps = tk.SCAN_THREADS // 32
    assert per_block == warps * (32 // G)
    # the kernel's lane of (block, warp, thread): the last 32 % G threads
    # of a warp hold no lane
    b, wp, th = np.meshgrid(np.arange(blocks), np.arange(warps),
                            np.arange(32), indexing="ij")
    lw, g = th // G, th % G
    f = (b * warps + wp) * (32 // G) + lw
    live = (lw < 32 // G) & (f < lanes)
    for k in range(G):                            # each of the G threads
        assert np.array_equal(np.sort(f[live & (g == k)]), np.arange(lanes))
    assert (blocks - 1) * per_block < lanes


@pytest.mark.parametrize("G,lanes", [(2, 8192), (6, 8192), (2, 111),
                                     (6, 131072)])
def test_prefix_scan_geometry_takes_a_named_G(G, lanes):
    got, blocks, per_block = tk.prefix_scan_geometry(lanes, 132, G)
    assert got == G and per_block == (tk.SCAN_THREADS // 32) * (32 // G)
    assert (blocks - 1) * per_block < lanes <= blocks * per_block


@pytest.mark.parametrize("L,G,piece,shared", [
    (22, 2, 8, 64 * (8 * 22 + 8 + 4 * 437)),
    (22, 6, 8, 20 * (8 * 22 + 8 + 4 * 437)),
    (21, 2, 4, 64 * (8 * 21 + 8 + 4 * 399)),
    (21, 6, 4, 20 * (8 * 21 + 8 + 4 * 399)),
    (32, 2, 8, 177_408), (30, 2, 8, 64 * (8 * 30 + 8 + 4 * 589)),
    (6, 6, 8, 20 * (8 * 6 + 8 + 4 * 133))])
def test_prefix_scan_smem_pieces_and_bytes(L, G, piece, shared):
    """A row of 2 L int16 is copied in 8-byte pieces where L is even and
    in 4-byte pieces where it is odd, a whole number either way; the
    block's bytes (rows and payloads twice, the lanes' states of 19
    segments of L | 1 words, the whole padded to an odd count) fit the
    227 KB a block can have at every profile of the library. (On the
    card the launch refuses a count other than its kernel's own.)"""
    got = tk.prefix_scan_smem(L, G)
    assert got.piece_bytes == piece and (4 * L) % piece == 0
    assert got.shared_bytes == shared <= tk.BLOCK_SHARED_BYTES
    for Lp, _ in tk.CUDA_PROFILES:
        for Gp in tk.SCAN_THREADS_PER_LANE:
            assert tk.prefix_scan_smem(Lp, Gp).shared_bytes \
                <= tk.BLOCK_SHARED_BYTES
    with pytest.raises(ValueError):
        tk.prefix_scan_smem(L, 3)


def test_prefix_scan_geometry_refuses_other_G():
    for G in (1, 3, 4):
        with pytest.raises(ValueError):
            tk.prefix_scan_geometry(8192, 132, G)
    with pytest.raises(ValueError):
        tk.prefix_scan_geometry(0, 132)
