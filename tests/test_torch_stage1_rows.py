"""Stage 1 from the wire to the row table (tpu_msm_torch/cuzk/pipeline_cuda.py
`stage1`), on CPU tensors, bit for bit against the JAX package.

- `kernels.encode_rows`' plain version against the JAX encode (its rows
  body, `tpu_msm/ops/rows.py` `to_mont_rows`, as tests/test_torch_kernels.py
  runs it at these profiles; the Pallas kernel in interpret mode at
  TINY62), concatenated, cast and transposed in numpy; int16 and int32
  wire limbs, a slice of a wider array;
- `cuzk/glv.glv_rows` (the rows form of `kernels.glv_rows` and the one
  `decompose_digits`) against the JAX `apply_glv` laid out as rows;
- `decompose_digits` on uint16 and int32 halfwords with Wp > W against
  the JAX digits and zero rows;
- `col_prefix` on `column_totals`, a view of the scan output, against the
  JAX `col_prefix` of its last row;
- `windows_device` and the XLA path's `_windows_device` against the
  stage-1 sequence they ran before (`old_windows_device`, kept here as
  the reference), bit for bit, and the oracle by value, with GLV and
  with window shards;
- the wrappers' arguments to a fake library (strides, widths, Wp, the
  totals' row stride), and `utils/preprocess.aggregate_scalars` against
  the loop it replaced.

n is 1, 7 and 1,024 at the four signed profiles of the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm import glv as jglv
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import decompose as jdecompose
from tpu_msm.cuzk import glv as jdglv
from tpu_msm.cuzk import kernels as jk
from tpu_msm.ops import rows as jrows
from tpu_msm_torch import _build
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.constants import (BLS12_377_S12, BLS12_377_S13, BN254_S12,
                                     BN254_S13, TINY62)
from tpu_msm_torch.cuzk import glv as dglv
from tpu_msm_torch.cuzk import kernels, pipeline, pipeline_cuda
from tpu_msm_torch.cuzk.pipeline import MSMPipeline
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils import preprocess
from tpu_msm_torch.utils.limbs_conversion import (points_to_planar,
                                                  scalars_to_planar)

# The tensors here are small: more intra-op threads only make parallel
# test workers fight for the cores.
torch.set_num_threads(1)

I16, I32 = torch.int16, torch.int32
CURVES = (BN254_S12, BN254_S13, BLS12_377_S12, BLS12_377_S13)
SIZES = (1, 7, 1024)


def canon(curve, n, seed):
    """(L, n) canonical standard-form limbs of values below p."""
    rng = np.random.default_rng(seed)
    L, w = curve.num_limbs, curve.log_limb_size
    vals = [int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 1 << 62))
            * int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62))
            % curve.p for _ in range(n)]
    vals[:3] = [0, 1, curve.p - 1][:n]
    return np.array([[(v >> (w * i)) & ((1 << w) - 1) for v in vals]
                     for i in range(L)], dtype=np.int32).reshape(L, n)


def jax_to_mont(curve, xs: np.ndarray) -> np.ndarray:
    J = jc.CURVES[curve.name]
    return np.asarray(jrows.to_stacked(jrows.to_mont_rows(
        jrows.from_stacked(jnp.asarray(xs)), J)))


def rows_of(xm: np.ndarray, ym: np.ndarray) -> np.ndarray:
    """pipeline_pallas.py:258 in numpy: cat, cast to int16, transpose."""
    return np.ascontiguousarray(
        np.concatenate([xm, ym]).astype(np.int16).T)


def halfwords(curve, n, seed):
    """(H + 2, n) uint16 halfwords of scalars below r (0, 1, r - 1 first),
    with the two zero pad rows of `MSMPipeline.pack`."""
    rng = np.random.default_rng(seed)
    r = curve.scalar_modulus
    ks = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
    ks[:3] = [0, 1, r - 1][:n]
    hw = scalars_to_planar(ks, curve)
    return np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.uint16)


def t(a, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


# ---------------------------------------------------------------------------
# encode_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_encode_rows_vs_jax_encode(curve, n):
    xs, ys = canon(curve, n, 3 * n + 1), canon(curve, n, 3 * n + 2)
    want = rows_of(jax_to_mont(curve, xs), jax_to_mont(curve, ys))
    for dt in (I16, I32):
        got = kernels.encode_rows(t(xs, dt), t(ys, dt), curve)
        assert got.dtype == I16 and got.shape == (n, 2 * curve.num_limbs)
        assert np.array_equal(got.numpy(), want), dt
    # a slice of the columns of a wider array reads the same
    wide = t(np.concatenate([xs, xs, xs], axis=1), I16)
    widey = t(np.concatenate([ys, ys, ys], axis=1), I16)
    got = kernels.encode_rows(wide[:, n:2 * n], widey[:, n:2 * n], curve)
    assert np.array_equal(got.numpy(), want)
    # the rows are encode_mont's limbs, cast
    assert torch.equal(got, kernels.row_table(
        kernels.encode_mont(t(xs), curve), kernels.encode_mont(t(ys), curve)))


def test_encode_rows_tiny_vs_pallas():
    xs, ys = canon(TINY62, 64, 5), canon(TINY62, 64, 6)
    J = jc.TINY62
    want = rows_of(np.asarray(jk.encode_mont(jnp.asarray(xs), J)),
                   np.asarray(jk.encode_mont(jnp.asarray(ys), J)))
    for dt in (I16, I32):
        got = kernels.encode_rows(t(xs, dt), t(ys, dt), TINY62)
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# glv rows
# ---------------------------------------------------------------------------


def glv_cfg(curve, s=13, Wg=4):
    return MSMConfig(curve=curve, window_size=s, columns=8, pbpr_threads=4,
                     subtask_group=Wg, glv=True)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_glv_rows_vs_jax_apply_glv(curve, n):
    """s = 13, Wg = 4: W = 10 windows a magnitude padded to Wp = 12."""
    cfg = glv_cfg(curve)
    W, Wp = cfg.num_windows, cfg.padded_windows
    xs, ys = canon(curve, n, 7 * n + 1), canon(curve, n, 7 * n + 2)
    hw = halfwords(curve, n, 7 * n + 3)
    J = jc.CURVES[curve.name]
    jcfg = JaxConfig(curve=J, window_size=13, columns=8, pbpr_threads=4,
                     subtask_group=4, glv=True)
    wx, wy, wd = jdglv.apply_glv(jnp.asarray(jax_to_mont(curve, xs)),
                                 jnp.asarray(jax_to_mont(curve, ys)),
                                 jnp.asarray(hw.astype(np.uint32)), jcfg)
    want_rows = rows_of(np.asarray(wx), np.asarray(wy))
    want_digits = np.concatenate(
        [np.asarray(wd), np.zeros((Wp - W, 2 * n), np.int32)])
    assert Wp > W
    for dl, dh in ((I16, torch.uint16), (I32, I32), (I16, I32)):
        table, digits = dglv.glv_rows(t(xs, dl), t(ys, dl), t(hw, dh), cfg)
        assert table.dtype == digits.dtype == I16
        assert np.array_equal(table.numpy(), want_rows), (dl, dh)
        assert np.array_equal(digits.numpy().astype(np.int32), want_digits)
    # the JAX-shaped form on Montgomery limbs, laid out as rows
    xm, ym = (kernels.encode_mont(t(v), curve) for v in (xs, ys))
    table, mags, n1, n2 = kernels.glv_rows(t(xs, I16), t(ys, I16),
                                           t(hw, torch.uint16), curve,
                                           cfg.glv_params)
    x2, y2, mags2, m1, m2 = kernels.glv_apply(xm, ym, t(hw, I32), curve,
                                              cfg.glv_params)
    assert torch.equal(kernels.row_table(x2, y2), table)
    assert all(torch.equal(a, b) for a, b in ((mags, mags2), (n1, m1),
                                              (n2, m2)))


# ---------------------------------------------------------------------------
# decompose_digits: the wire's halfwords, Wp > W
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_decompose_digits_wire_halfwords_and_pad_rows(curve, n):
    """The scalars' halfwords at s = 13, Wg = 8 (Wp > W at every
    profile) against the JAX `decompose`; the GLV magnitudes at s = 13
    (W = 10, Wp = 12) against the JAX windows of `apply_glv`."""
    hw = halfwords(curve, n, 11 * n + 1)
    cfg = MSMConfig(curve=curve, window_size=13, columns=8, pbpr_threads=4,
                    subtask_group=8)
    W, Wp = cfg.num_windows, cfg.padded_windows
    assert Wp > W
    jcfg = JaxConfig(curve=jc.CURVES[curve.name], window_size=13, columns=8,
                     pbpr_threads=4, subtask_group=8)
    want = np.asarray(jdecompose.decompose(jnp.asarray(hw.astype(np.uint32)),
                                           jcfg))
    want = np.concatenate([want, np.zeros((Wp - W, n), np.int32)])
    for dt in (torch.uint16, I32):
        got = kernels.decompose_digits(t(hw, dt), 13, W, Wp)
        assert got.dtype == I16 and got.shape == (Wp, n)
        assert np.array_equal(got.numpy().astype(np.int32), want), dt
    assert torch.equal(kernels.decompose_digits(t(hw, I32), 13, W),
                       t(want[:W], I16))

    gcfg = glv_cfg(curve)
    _, mags, _, _ = kernels.glv_rows_plain(
        t(canon(curve, n, 1)), t(canon(curve, n, 2)), t(hw, I32), curve,
        gcfg.glv_params)
    W, Wp = gcfg.num_windows, gcfg.padded_windows
    assert (W, Wp) == (10, 12)
    jm = jnp.asarray(mags.numpy().astype(np.uint32))
    want = np.asarray(jdecompose.signed_digits(
        jdecompose.extract_windows(jm, 13, W), 13))
    want = np.concatenate([want, np.zeros((Wp - W, 2 * n), np.int32)])
    for dt in (torch.uint16, I32):
        got = kernels.decompose_digits(mags.to(dt), 13, W, Wp)
        assert np.array_equal(got.numpy().astype(np.int32), want), dt


def test_decompose_digits_tiny_vs_pallas_with_pad_rows():
    hw = halfwords(TINY62, 64, 9)
    W = 8
    want = np.asarray(jk.decompose_digits(jnp.asarray(hw.astype(np.int32)),
                                          8, W))
    for dt in (torch.uint16, I32):
        got = kernels.decompose_digits(t(hw, dt), 8, W, W + 3)
        assert np.array_equal(got.numpy()[:W].astype(np.int32), want)
        assert not got[W:].any()
    with pytest.raises(ValueError):
        kernels.decompose_digits(t(hw, I32), 8, W, W - 1)


# ---------------------------------------------------------------------------
# col_prefix on the scan output, read in place
# ---------------------------------------------------------------------------


def lazy_tbuf(curve, R, F, seed):
    """(3, L, R, F) int16 limbs in the lazy point range, top limb small."""
    L, w = curve.num_limbs, curve.log_limb_size
    rng = np.random.default_rng(seed)
    a = rng.integers(-(1 << w) + 1, 1 << (w + 1), (3, L, R, F))
    a[:, L - 1] = np.abs(a[:, L - 1]) % 8 + 1
    return a.astype(np.int16)


def jax_col_prefix_by_rows(curve, coltot):
    """The TPU kernel's level order, replayed with eager JAX rows (as
    tests/test_torch_scan_edges.py runs it)."""
    J = jc.CURVES[curve.name]
    _, _, Wg, C = coltot.shape
    inf = np.asarray(jk.inf_stacked(J, (Wg, C)))

    def proj(a):
        a = jnp.asarray(a, jnp.int32)
        return jrows.ProjRows(*(jrows.from_stacked(a[c]) for c in range(3)))

    def stack(p):
        return np.asarray(jnp.stack([jnp.stack(p.x), jnp.stack(p.y),
                                     jnp.stack(p.z)]))

    v = np.concatenate([inf[..., :1], coltot[..., :-1].astype(np.int32)], -1)
    for lv in range(max(C.bit_length() - 1, 1)):
        k = 1 << lv
        sh = np.concatenate([inf[..., :k], v[..., :C - k]], -1)[..., :C]
        v = stack(jrows.padd_rows(proj(v), proj(sh), J))
    return v.astype(np.int16)


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_col_prefix_on_the_scan_output_vs_jax(curve):
    Wg, C, R = 2, 4, 3
    tbuf = lazy_tbuf(curve, R, Wg * C, 21)
    view = kernels.column_totals(t(tbuf), Wg)
    last = np.ascontiguousarray(tbuf[:, :, R - 1].reshape(3, -1, Wg, C))
    assert np.array_equal(view.numpy(), last)
    got = kernels.col_prefix(view, curve)
    assert np.array_equal(got.numpy(), jax_col_prefix_by_rows(curve, last))


def test_col_prefix_on_the_scan_output_tiny_vs_pallas():
    Wg, C, R = 4, 8, 5
    tbuf = t(lazy_tbuf(TINY62, R, Wg * C, 22))
    view = kernels.column_totals(tbuf, Wg)
    want = np.asarray(jk.col_prefix(jnp.asarray(view.numpy()), jc.TINY62))
    assert np.array_equal(kernels.col_prefix(view, TINY62).numpy(), want)


def test_column_totals_is_a_view_the_kernel_reads_in_place():
    """No copy: the view shares the scan output's storage at row R - 1,
    and its (coordinate, limb) rows are R F apart, the stride the kernel
    is handed; a contiguous array's is Wg C; other layouts are refused."""
    L, R, Wg, C = TINY62.num_limbs, 5, 3, 4
    tbuf = torch.zeros((3, L, R, Wg * C), dtype=I16)
    view = kernels.column_totals(tbuf, Wg)
    assert view.data_ptr() == tbuf[:, :, R - 1].data_ptr()
    assert view.untyped_storage().data_ptr() == \
        tbuf.untyped_storage().data_ptr()
    assert kernels.col_prefix_row_stride(view, L) == R * Wg * C
    assert kernels.col_prefix_row_stride(view.contiguous(), L) == Wg * C
    for bad in (view.transpose(2, 3), view.to(I32), view[:, :L - 1],
                tbuf.permute(1, 0, 2, 3)[:, :, :Wg, :C]):
        with pytest.raises(ValueError):
            kernels.col_prefix_row_stride(bad, L)


# ---------------------------------------------------------------------------
# windows_device against the stage-1 sequence it ran before
# ---------------------------------------------------------------------------


def old_stage1(xs, ys, halfwords_, cfg):
    """Stage 1 as `windows_device` ran it before its row table was a
    kernel's: the casts to int32, encode_mont of each coordinate, the
    digits (under GLV `glv.apply_glv`), the zero digit rows by `cat` and
    the row table by cat, cast and transpose."""
    xs, ys, hw = xs.to(I32), ys.to(I32), halfwords_.to(I32)
    xm = kernels.encode_mont(xs.contiguous(), cfg.curve)
    ym = kernels.encode_mont(ys.contiguous(), cfg.curve)
    if cfg.glv:
        xm, ym, digits = dglv.apply_glv(xm, ym, hw, cfg)
    else:
        digits = kernels.decompose_digits(hw.contiguous(), cfg.window_size,
                                          cfg.num_windows)
    n = xm.shape[-1]
    W, Wp = cfg.num_windows, cfg.padded_windows
    if Wp > W:
        digits = torch.cat([digits, digits.new_zeros((Wp - W, n))])
    return torch.cat([xm, ym]).to(I16).T.contiguous(), digits


def old_windows_device(xs, ys, halfwords_, cfg, w_shards=1, w_index=0):
    """The parent's `windows_device`, stages 2 to 4 as they are, with the
    column totals copied out of the scan output."""
    curve = cfg.curve
    L = curve.num_limbs
    pts_rows, digits = old_stage1(xs, ys, halfwords_, cfg)
    n = pts_rows.shape[0]
    Wg, G = cfg.subtask_group, cfg.num_groups
    B, Wp = cfg.half_columns, cfg.padded_windows
    C = min(cfg.columns, n)
    R = n // C
    Wp, G = Wp // w_shards, G // w_shards
    digits = digits[w_index * Wp:(w_index + 1) * Wp]
    pay_all, cnt_all = kernels.bucket_sort(digits.contiguous(), B)
    buckets = torch.empty((3, L, Wp, B), dtype=I16)
    for g in range(G):
        sl = slice(g * Wg, (g + 1) * Wg)
        tbuf = kernels.prefix_scan(pts_rows, pay_all[sl], curve, C)
        coltot = tbuf[:, :, R - 1].reshape(3, L, Wg, C).contiguous()
        S = kernels.col_prefix(coltot, curve)
        kernels.extract_buckets(tbuf, S, cnt_all, buckets, g, Wg, C, R,
                                curve)
    return kernels.pbpr_full(buckets, curve, min(cfg.pbpr_threads, B))


# (curve, n points, window_size, subtask_group, glv, the shard counts)
WINDOW_CASES = (
    (TINY62, 64, 4, 3, False, (1, 2, 3)),       # W 16, Wp 18, 6 groups
    (BN254_S12, 32, 8, 3, True, (1, 2)),        # W 17, Wp 18, 6 groups
    (BN254_S12, 32, 8, 4, False, (2,)),         # W 32, 8 groups
)


def wire(curve, n, seed):
    pts, scalars = ref.gen_points_scalars(curve, n, seed=seed)
    xs, ys = points_to_planar(pts, curve)
    hw = np.concatenate([scalars_to_planar(scalars, curve),
                         np.zeros((2, n), np.uint32)])
    return pts, scalars, (t(xs, I16), t(ys, I16), t(hw.astype(np.uint16)))


@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=lambda c: f"{c[0].name}-glv{int(c[4])}-s{c[2]}")
def test_windows_device_same_as_the_old_stage1(case):
    curve, n, s, Wg, glv, shards = case
    cfg = MSMConfig(curve=curve, window_size=s, columns=8, pbpr_threads=4,
                    subtask_group=Wg, glv=glv)
    pts, scalars, dev_in = wire(curve, n, 40 + s)
    int32_in = tuple(a.to(I32) for a in dev_in)
    whole = pipeline_cuda.windows_device(*dev_in, cfg)
    assert torch.equal(whole, old_windows_device(*dev_in, cfg))
    assert torch.equal(pipeline_cuda.windows_device(*int32_in, cfg), whole)
    # by value: the oracle through the host decode and Horner
    pipe = MSMPipeline(cfg, "cpu")
    got = pipe.horner(pipe._decode_windows(whole))
    assert ref.jac_eq(curve, got,
                      ref.msm_pippenger_signed(curve, pts, scalars, window=8))
    for w in shards:
        if w == 1:
            continue
        parts = [pipeline_cuda.windows_device(*dev_in, cfg, w_shards=w,
                                              w_index=i) for i in range(w)]
        for i, part in enumerate(parts):
            assert torch.equal(part, old_windows_device(
                *dev_in, cfg, w_shards=w, w_index=i))
        assert torch.equal(torch.cat(parts, dim=2), whole)


@pytest.mark.parametrize("glv", [False, True])
def test_xla_path_takes_the_new_stage1(glv):
    """`_windows_device` (backend="xla") on the wire dtypes equals itself
    on int32 inputs and the kernel path's window sums by value."""
    cfg = MSMConfig(curve=BN254_S12, window_size=8, columns=8, pbpr_threads=4,
                    subtask_group=4 if not glv else 3, glv=glv, backend="xla")
    _, _, dev_in = wire(BN254_S12, 32, 61)
    got = pipeline._windows_device(*dev_in, cfg)
    assert torch.equal(
        got, pipeline._windows_device(*(a.to(I32) for a in dev_in), cfg))
    pipe = MSMPipeline(cfg, "cpu")
    main = pipeline_cuda.windows_device(
        *dev_in, dataclasses.replace(cfg, backend="cuda"))
    for a, b in zip(pipe._decode_windows(got), pipe._decode_windows(main)):
        assert ref.jac_eq(BN254_S12, a, b)


def test_stage1_calls(monkeypatch):
    """Stage 1 is two wrapper calls: encode_rows and decompose_digits, or
    under GLV glv_rows and decompose_digits; encode_mont and glv_apply
    (the JAX-shaped wrappers) are not called."""
    calls = []
    for name in ("encode_mont", "encode_rows", "decompose_digits",
                 "glv_rows", "glv_apply"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    _, _, dev_in = wire(BN254_S12, 16, 62)
    for glv, want in ((False, ["encode_rows", "decompose_digits"]),
                      (True, ["glv_rows", "decompose_digits"])):
        calls.clear()
        cfg = glv_cfg(BN254_S12, s=8, Wg=3) if glv else MSMConfig(
            curve=BN254_S12, window_size=8, columns=8, pbpr_threads=4,
            subtask_group=3)
        rows_, digits = pipeline_cuda.stage1(*dev_in, cfg)
        assert calls == want
        assert digits.shape == (cfg.padded_windows, (2 if glv else 1) * 16)
        assert rows_.shape == ((2 if glv else 1) * 16,
                               2 * BN254_S12.num_limbs)


# ---------------------------------------------------------------------------
# the launches' arguments, against a fake library
# ---------------------------------------------------------------------------


class FakeLib:
    def __init__(self):
        self.calls = []

    def msm_encode_rows(self, L, w, xs, ys, nb, ldx, ldy, out, n, wide, st):
        self.calls.append(("encode_rows", L, w, nb, ldx, ldy, n))
        return 0

    def msm_decompose_digits(self, hw, nb, ld, out, H, n, s, W, Wp, rows,
                             P, head, threads, vl, vs, st):
        self.calls.append(("decompose_digits", nb, ld, H, n, s, W, Wp, rows,
                           P, head, threads, vl, vs))
        return 0

    def msm_glv_apply(self, L, w, xs, ys, nb, ldx, ldy, hw, hb, ldh,
                      rows_, n, table, mags, n1, n2, consts, words, st):
        self.calls.append(("glv_apply", L, w, nb, ldx, ldy, hb, ldh,
                           rows_, n))
        return 0

    def msm_col_prefix(self, L, w, coltot, row, out, scratch, Wg, C, levels,
                       G, blocks, consts, wide, st):
        self.calls.append(("col_prefix", L, row, Wg, C, levels))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(kernels, "_on_cuda", lambda name, *a: True)
    monkeypatch.setattr(kernels, "_stream", lambda a: 0)
    monkeypatch.setattr(kernels, "_col_prefix_limits",
                        lambda curve, dev: (132, 8, 64, 6))
    monkeypatch.setattr(_build, "library", lambda: lib)
    kernels.reset_launches()
    return lib


def test_wrappers_hand_the_kernels_strides_and_widths(fake_card):
    c = BN254_S12
    L, N, lo, n = c.num_limbs, 40, 8, 16
    xs = torch.zeros((L, N), dtype=I16)
    hw = torch.zeros((18, N), dtype=torch.uint16)
    rows_ = kernels.encode_rows(xs[:, lo:lo + n], xs[:, lo:lo + n], c)
    assert rows_.shape == (n, 2 * L) and rows_.dtype == I16
    d = kernels.decompose_digits(hw[:, lo:lo + n], 16, 16, 18)
    assert d.shape == (18, n)
    # the slice starts 16 bytes in: 2 scalars a thread (n is small), words
    # aligned, no head
    geo = kernels.decompose_digits_geometry(
        n, N, 2, hw[:, lo:].data_ptr() % 16, 18, 16, 16)
    assert kernels.LAUNCHED["decompose_digits"] == geo._asdict()
    cfg = glv_cfg(c)
    table, mags, n1, n2 = kernels.glv_rows(xs[:, lo:lo + n].to(I32),
                                           xs[:, lo:lo + n].to(I32),
                                           hw[:, lo:lo + n], c,
                                           cfg.glv_params)
    assert table.shape == (2 * n, 2 * L) and mags.shape == (12, 2 * n)
    tbuf = torch.zeros((3, L, 7, 2 * 8), dtype=I16)
    kernels.col_prefix(kernels.column_totals(tbuf, 2), c)
    assert fake_card.calls == [
        ("encode_rows", L, 12, 2, N, N, n),
        ("decompose_digits", 2, N, 18, n, 16, 16, 18, 16, geo.
         points_per_thread, geo.head, geo.threads, int(geo.vector_loads),
         int(geo.vector_stores)),
        ("glv_apply", L, 12, 4, n, n, 2, N, 16, n),
        ("col_prefix", L, 7 * 16, 2, 8, 3)]
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "encode_rows": 1, "decompose_digits": 1, "glv_apply": 1,
        "col_prefix": 1}


def test_wrappers_refuse_what_the_kernels_cannot_read(fake_card):
    c = BN254_S12
    L = c.num_limbs
    xs = torch.zeros((L, 8), dtype=I16)
    hw = torch.zeros((18, 8), dtype=torch.uint16)
    for args in ((xs.T.contiguous().T, xs),            # lanes not contiguous
                 (xs.to(torch.int64), xs.to(torch.int64)),
                 (xs, xs.to(I32)),                      # widths differ
                 (xs[:L - 1], xs[:L - 1])):
        with pytest.raises(ValueError):
            kernels.encode_rows(*args, c)
    for bad in (hw.to(torch.int64), hw.T.contiguous().T, hw.to(I16)):
        with pytest.raises(ValueError):
            kernels.decompose_digits(bad, 16, 16)
    with pytest.raises(ValueError):
        kernels.glv_rows(xs, xs, hw.to(torch.int64), c, glv_cfg(c).glv_params)
    with pytest.raises(ValueError):                # the planar form: CPU only
        kernels.glv_apply(xs.to(I32), xs.to(I32), hw.to(I32), c,
                          glv_cfg(c).glv_params)
    assert fake_card.calls == [] and set(kernels.LAUNCHES.values()) == {0}


def test_staging_converts_what_the_kernels_cannot_read():
    """window_sums takes any integer dtype: the wire dtypes are staged as
    they are, any other as int32."""
    pipe = MSMPipeline(MSMConfig(curve=BN254_S12, window_size=8, columns=8,
                                 pbpr_threads=4, subtask_group=3), "cpu")
    a = np.arange(24, dtype=np.int64).reshape(2, 12)
    for (dx, dh), want in (((np.int16, np.uint16), (I16, torch.uint16)),
                           ((np.int32, np.int32), (I32, I32)),
                           ((np.int64, np.uint32), (I32, I32)),
                           ((np.uint16, np.int64), (I32, I32))):
        (x, y, h), event = pipe._stage([a.astype(dx), a.astype(dx),
                                        a.astype(dh)])
        assert event is None and (x.dtype, h.dtype) == want
        assert y.dtype == x.dtype
        assert np.array_equal(h.numpy().astype(np.int64), a)


# ---------------------------------------------------------------------------
# the oracle's aggregation
# ---------------------------------------------------------------------------


def aggregate_by_loop(hw, k_base, curve):
    """`aggregate_scalars` as the loop over python ints it was."""
    agg = [0] * k_base
    for i, s in enumerate(preprocess.halfwords_to_ints(hw)):
        agg[i % k_base] = (agg[i % k_base] + s) % curve.scalar_modulus
    return agg


@pytest.mark.parametrize("n,k_base", [(1, 1), (7, 64), (1000, 64),
                                      (4096, 64), (4099, 7)])
@pytest.mark.parametrize("curve", [BN254_S12, BLS12_377_S12],
                         ids=lambda c: c.name)
def test_aggregate_scalars_matches_the_loop(curve, n, k_base):
    hw = preprocess.gen_scalar_halfwords(curve, n, seed=n + k_base)
    hw[:, :1] = 0xFFFF                                  # the top of a row
    assert (preprocess.aggregate_scalars(hw, k_base, curve)
            == aggregate_by_loop(hw, k_base, curve))
    if n >= 64:
        _, _, hw, base = preprocess.gen_planar_inputs(curve, n, seed=3,
                                                      k_base=4)
        assert ref.jac_eq(curve, preprocess.expected_msm(base, hw, curve),
                          ref.msm_pippenger_signed(
                              curve, base, aggregate_by_loop(hw, 4, curve),
                              window=8))


def test_jax_glv_params_are_the_ports():
    """The GLV constants both sides split with (glv_rows' JAX reference)."""
    for c in CURVES:
        j, p = jglv.derive(jc.CURVES[c.name]), glv_cfg(c).glv_params
        assert (j.lam, j.beta, j.g1, j.g2) == (p.lam, p.beta, p.g1, p.g2)


def test_rest_check_flags_the_old_stage1_ops():
    """`chip_smoke.over_the_stream`, the check of its [rest] profile, on
    the ops of a CPU profile (CPU time standing for device time): the
    old stage 1's casts, cat and transpose over the stream are flagged,
    and a copy of the (3, L, Wp) window sums is not."""
    import chip_smoke

    L, n = TINY62.num_limbs, 4096
    xm = torch.zeros((L, n), dtype=I32)
    sums = torch.zeros((3, L, 16), dtype=I32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        kernels.row_table(xm.to(I32), xm)
        sums.clone()
    shaped = [dict(op=r.key, shapes=[list(x) for x in r.input_shapes if x],
                   calls=r.count, device_ms=r.self_cpu_time_total / 1e3)
              for r in prof.key_averages(group_by_input_shape=True)
              if r.key in ("aten::cat", "aten::copy_", "aten::clone")]
    flagged = {r["op"] for r in chip_smoke.over_the_stream(shaped, n)}
    # the cat, the cast's copy and the transpose's contiguous clone
    assert flagged == {"aten::cat", "aten::copy_", "aten::clone"}
    small = [r for r in shaped if r["shapes"] == [[3, L, 16]]]
    assert small and not chip_smoke.over_the_stream(small, n)


@pytest.mark.parametrize("s, W, rows_read", [(16, 16, 16), (13, 10, 9),
                                             (16, 9, 9), (8, 32, 17)])
def test_digits_bound_counts_the_rows_read(s, W, rows_read):
    """`chip_smoke.work` charges `decompose_digits` the halfword rows its
    windows read (the top window's first, and the next off a halfword's
    start), not the pad rows past them, and its Wp output rows."""
    import chip_smoke

    n, Wp = 64, W + 2
    for dt in (torch.uint16, I32):
        hw = torch.zeros((18, n), dtype=dt)
        out = torch.zeros((Wp, n), dtype=I16)
        nbytes, _ = chip_smoke.work(BN254_S12, "decompose_digits",
                                    (hw, s, W, Wp), out)
        assert nbytes == n * (rows_read * hw.element_size() + 2 * Wp)
