"""The GLV kernel's plain version and the one-launch `apply_glv`
(tpu_msm_torch/cuzk/kernels.py `glv_apply_plain`, cuzk/glv.py
`apply_glv`) on CPU tensors, against the JAX package bit for bit.

At BN254_S12, BN254_S13, BLS12_377_S12 and BLS12_377_S13, n = 64 points
with the edge scalars that `chip_smoke.py` gives the kernel (0, 1,
r - 1, 2^15, lambda, r - lambda, +-max_abs and scalars whose k1 or k2
is negative), s = 8, 13 and 16: the signs and magnitudes against
`tpu_msm.cuzk.glv.split_scalars`, the doubled x, y stream and the digits
of the single `decompose_digits` against `tpu_msm.cuzk.glv.apply_glv`
(eager). No tolerance: equal limbs, equal signs, equal digits.

The split's word arithmetic (csrc/glv_split.cuh, PTX-free) is built here
with g++ and held against `split_scalars` and the python-int oracle on
10,000 seeded scalars; the constant layouts are held against the C
structs' sizes."""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm import glv as jglv
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import glv as jdglv
from tpu_msm.ops import lazy as jlazy
from tpu_msm_torch import _build, glv
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.constants import (BLS12_377_S12, BLS12_377_S13, BN254_S12,
                                     BN254_S13, TINY62)
from tpu_msm_torch.cuzk import glv as dglv
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import (points_to_planar,
                                                  scalars_to_planar)

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

CURVES = (BN254_S12, BN254_S13, BLS12_377_S12, BLS12_377_S13)
FIELDS = dict(window_size=8, columns=32, pbpr_threads=16, subtask_group=8)


def edge_scalars(curve, n, seed):
    """The edges first, then seeded scalars; among them k1 and k2 are each
    negative somewhere and non-negative somewhere."""
    g = glv.derive(curve)
    r = curve.scalar_modulus
    rng = random.Random(seed)
    ks = [0, 1, r - 1, 1 << 15, g.lam, r - g.lam, g.max_abs, r - g.max_abs,
          g.max_abs * g.lam % r, (r - g.max_abs) * g.lam % r]
    ks += [rng.randrange(r) for _ in range(n - len(ks))]
    signs = [g.split_signed(k) for k in ks]
    for i in (0, 2):
        assert {s[i] for s in signs} == {True, False}
    return ks


def halfwords(ks, curve):
    """(18, n) int32 halfwords with the two zero pad rows of `pack`."""
    n = len(ks)
    return np.concatenate([scalars_to_planar(ks, curve),
                           np.zeros((2, n), np.uint32)]).astype(np.int32)


def encoded_points(curve, n, seed):
    pts, _ = ref.gen_points_scalars(curve, n, seed=seed)
    xs, ys = points_to_planar(pts, curve)
    to = lambda a: kernels.encode_mont(torch.from_numpy(a.astype(np.int32)),
                                       curve)
    return xs, ys, to(xs), to(ys)


def same(mine: torch.Tensor, theirs) -> bool:
    return np.array_equal(mine.numpy().astype(np.int64),
                          np.asarray(theirs).astype(np.int64))


@pytest.mark.parametrize("s", [8, 13, 16])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_glv_kernel_plain_and_apply_glv_match_jax(curve, s):
    n = 64
    jcurve = jc.CURVES[curve.name]
    fields = dict(FIELDS, window_size=s, pbpr_threads=min(16, 1 << (s - 1)))
    cfg = MSMConfig(curve=curve, glv=True, **fields)
    jcfg = JaxConfig(curve=jcurve, glv=True, backend="xla", unroll=False,
                     **fields)
    assert cfg.num_windows == jcfg.num_windows
    xs, ys, xm, ym = encoded_points(curve, n, 85 + s)
    hw = halfwords(edge_scalars(curve, n, 86 + s), curve)
    thw = torch.from_numpy(hw)

    x2, y2, mags, neg1, neg2 = kernels.glv_apply_plain(
        xm, ym, thw, curve, cfg.glv_params)
    assert mags.shape == (kernels.B_LIMBS, 2 * n) and mags.dtype == torch.int32
    assert neg1.dtype == neg2.dtype == torch.bool and neg1.shape == (n,)
    jn1, jm1, jn2, jm2 = jdglv.split_scalars(jnp.asarray(hw.astype(np.uint32)),
                                             jglv.derive(jcurve))
    assert same(neg1, jn1) and same(neg2, jn2)
    assert same(mags[:, :n], jm1) and same(mags[:, n:], jm2)

    jx = jlazy.to_mont(jnp.asarray(xs.astype(np.int32)), jcurve)
    jy = jlazy.to_mont(jnp.asarray(ys.astype(np.int32)), jcurve)
    wx, wy, wd = jdglv.apply_glv(jx, jy, jnp.asarray(hw.astype(np.uint32)),
                                 jcfg)
    assert same(x2, wx) and same(y2, wy)
    for v in (x2, y2):
        assert int(v.min()) >= 0 and int(v.max()) < (1 << curve.log_limb_size)

    # the one-launch apply_glv: glv_apply, then ONE decompose_digits
    calls = []
    orig = kernels.decompose_digits
    kernels.decompose_digits = lambda *a: calls.append(a[0].shape) or orig(*a)
    try:
        gx, gy, digits = dglv.apply_glv(xm, ym, thw, cfg)
    finally:
        kernels.decompose_digits = orig
    assert calls == [(kernels.B_LIMBS, 2 * n)]
    assert torch.equal(gx, x2) and torch.equal(gy, y2)
    assert digits.dtype == torch.int16
    assert digits.shape == (cfg.num_windows, 2 * n)
    assert same(digits, wd)
    assert torch.equal(digits, kernels.decompose_digits_plain(
        mags, s, cfg.num_windows))


def test_glv_kernel_cpu_path_makes_no_cuda_call(monkeypatch):
    """CPU tensors take the plain version: no library, no stream, no
    launch counted."""
    def refuse(*_):
        raise AssertionError("a CUDA call on the CPU path")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    kernels.reset_launches()
    c = BN254_S12
    _, _, xm, ym = encoded_points(c, 8, 90)
    hw = torch.from_numpy(halfwords(edge_scalars(c, 16, 91)[-8:], c))
    dglv.apply_glv(xm, ym, hw, MSMConfig(curve=c, glv=True, **FIELDS))
    kernels.glv_apply(xm, ym, hw, c, glv.derive(c))
    assert set(kernels.LAUNCHES.values()) == {0}


def test_glv_kernel_refusals():
    c = BN254_S12
    g = glv.derive(c)
    _, _, xm, ym = encoded_points(c, 4, 92)
    hw = torch.from_numpy(halfwords([1, 2, 3, 4], c))
    with pytest.raises(ValueError):                 # mixed devices
        kernels.glv_apply(xm, ym, hw.to("meta"), c, g)
    with pytest.raises(ValueError):                 # another curve's split
        kernels.glv_apply(xm, ym, hw, BN254_S13, g)
    with pytest.raises(ValueError):                 # no endomorphism
        glv.derive(TINY62)
    with pytest.raises(ValueError):
        kernels.glv_apply(xm[:6], ym[:6], hw, TINY62, g)
    with pytest.raises(ValueError):
        dglv.apply_glv(xm, ym, hw, MSMConfig(curve=TINY62, glv=True,
                                             **FIELDS))
    assert (22, 12) in kernels.GLV_PROFILES
    assert (6, 12) in kernels.CUDA_PROFILES - kernels.GLV_PROFILES


def _struct_words(curve) -> int:
    """Words of GlvConsts<L, W> (csrc/glv_apply.cu): WideConsts (NF words
    of p, n0, N of R^2), beta in N words, 2p in L limbs, GlvSplit."""
    bits = curve.num_limbs * curve.log_limb_size
    n, nf = -(-bits // 32), bits // 32
    return nf + 1 + n + n + curve.num_limbs + 2 * 5 + 4 * 6


@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_glv_consts_layout(curve):
    g = glv.derive(curve)
    words = kernels._glv_consts_host(curve, g)
    assert len(words) == _struct_words(curve)
    assert all(0 <= v < 1 << 32 for v in words)
    split = kernels._glv_split_words(g)
    assert words[-len(split):] == split and len(split) == 34
    n = -(-curve.num_limbs * curve.log_limb_size // 32)
    beta = words[len(kernels._wide_consts_host(curve)):][:n]
    assert sum(v << (32 * i) for i, v in enumerate(beta)) == \
        curve.to_mont(g.beta)


SPLIT_SOURCE = r"""
#include <cstring>
#include "glv_split.cuh"

extern "C" void split_many(const uint32_t* k, const uint32_t* consts,
                           long n, uint32_t* out) {
  msm::GlvSplit C;
  std::memcpy(&C, consts, sizeof(C));
  for (long i = 0; i < n; i++) {
    uint32_t kk[msm::kGlvK], m1[msm::kGlvB], m2[msm::kGlvB];
    for (int j = 0; j < msm::kGlvK; j++) kk[j] = k[i * msm::kGlvK + j];
    bool n1, n2;
    msm::glv_split(kk, C, n1, m1, n2, m2);
    uint32_t* o = out + i * 14;
    o[0] = n1;
    o[7] = n2;
    for (int j = 0; j < msm::kGlvB; j++) {
      o[1 + j] = m1[j];
      o[8 + j] = m2[j];
    }
  }
}
"""


@pytest.fixture(scope="module")
def split_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build csrc/glv_split.cuh for the host")
    d = tmp_path_factory.mktemp("glv_split")
    (d / "split.cpp").write_text(SPLIT_SOURCE)
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(d / "split.so"),
                    str(d / "split.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "split.so"))
    lib.split_many.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_long, ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("curve", (BN254_S12, BLS12_377_S12),
                         ids=lambda c: c.name)
def test_glv_split_header_on_the_host(split_lib, curve):
    """10,000 seeded scalars (the edges first) and 2^256 - 1 through the
    header's words, against split_scalars and the python-int oracle."""
    g = glv.derive(curve)
    n = 10_000
    ks = edge_scalars(curve, n - 1, 93) + [(1 << 256) - 1]
    hw = np.asarray([[(k >> (16 * j)) & 0xFFFF for k in ks]
                     for j in range(16)], dtype=np.int64)
    words = (hw[0::2] | (hw[1::2] << 16)).T.astype(np.uint32).copy()
    consts = np.asarray(kernels._glv_split_words(g), dtype=np.uint32)
    out = np.zeros((n, 14), dtype=np.uint32)
    split_lib.split_many(words.ctypes.data, consts.ctypes.data, n,
                         out.ctypes.data)

    neg1, mag1, neg2, mag2 = kernels.split_scalars(
        torch.from_numpy(hw.astype(np.int32)), g)
    for sign, mag, col in ((neg1, mag1, 0), (neg2, mag2, 7)):
        assert np.array_equal(out[:, col].astype(bool), sign.numpy())
        got = out[:, col + 1:col + 7].astype(np.int64)
        want = mag.numpy().astype(np.int64)
        assert np.array_equal(got & 0xFFFF, want[0::2].T)
        assert np.array_equal(got >> 16, want[1::2].T)
    for i in range(0, n - 1, 97):
        n1, m1, n2, m2 = g.split_signed(ks[i])
        o = out[i]
        assert (bool(o[0]), bool(o[7])) == (n1, n2)
        assert sum(int(v) << (32 * j) for j, v in enumerate(o[1:7])) == m1
        assert sum(int(v) << (32 * j) for j, v in enumerate(o[8:14])) == m2
