"""The two-stage bucket reduction of the port on CPU tensors:
`kernels.pbpr_stage1` (plain version) and `cuzk/pbpr.bucket_reduce`
against the JAX package, bit for bit, and against the oracle by group
value.

`pbpr_stage1`: against the Pallas kernel in interpret mode on TINY62
(int16 buckets, which the kernel widens) and on BN254_S12 against the
loop of tests/test_pallas.py built on `ops.complete.padd` (int32 and
int16 buckets). `bucket_reduce`: against `tpu_msm.cuzk.pbpr.bucket_reduce`
on TINY62, two (B, T) geometries with Bt = 1 included, some buckets at
infinity; bit for bit (the port keeps the JAX order of operations), and
after decoding equal to `pbpr_full` and to the direct sum
sum_b (b+1) * S_b. In a file of its own: the interpret-mode kernel
alone takes tens of seconds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import kernels as jk
from tpu_msm.cuzk import pbpr as jpbpr
from tpu_msm.ops.complete import ProjPoint, padd, proj_infinity
from tpu_msm_torch import constants as tc
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.cuzk import pbpr as tpbpr
from tpu_msm_torch.cuzk.pipeline import get_pipeline
from tpu_msm_torch.reference import curve as ref

from test_torch_kernels import lazy_points
from test_torch_pbpr import mont_buckets

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# pbpr_stage1
# ---------------------------------------------------------------------------


def test_pbpr_stage1_tiny_vs_pallas():
    W, B, T = 2, 8, 4
    b = lazy_points(jc.TINY62, np.random.default_rng(21), (W, B), np.int16)
    jm, jg = jk.pbpr_stage1(jnp.asarray(b), jc.TINY62, T)
    m, g = tk.pbpr_stage1(torch.from_numpy(b), tc.TINY62, T)
    assert m.dtype == g.dtype == torch.int32 and m.shape == (3, 6, W, T)
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(g.numpy(), np.asarray(jg))
    # int32 buckets of the same values give the same sums
    m32, g32 = tk.pbpr_stage1(torch.from_numpy(b.astype(np.int32)),
                              tc.TINY62, T)
    assert torch.equal(m32, m) and torch.equal(g32, g)


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_pbpr_stage1_s12_vs_padd_loop(dtype):
    """The reference loop of tests/test_pallas.py (ops.complete.padd)."""
    C = jc.BN254_S12
    W, B, T = 3, 16, 4
    Bt = B // T
    bk = lazy_points(C, np.random.default_rng(22), (W, B), dtype)
    jb = jnp.asarray(bk.astype(np.int32))
    mw = gw = proj_infinity(C, (W, T))
    for j in range(Bt):
        idx = jnp.arange(T) * Bt + (Bt - 1 - j)
        pt = ProjPoint(jb[0][:, :, idx], jb[1][:, :, idx], jb[2][:, :, idx])
        mw = padd(mw, pt, C)
        gw = padd(gw, mw, C)
    m, g = tk.pbpr_stage1(torch.from_numpy(bk), tc.BN254_S12, T)
    assert np.array_equal(m.numpy(), np.asarray(jnp.stack(mw)))
    assert np.array_equal(g.numpy(), np.asarray(jnp.stack(gw)))


def test_pbpr_stage1_refuses_bad_threads():
    b = torch.zeros((3, 6, 2, 12), dtype=torch.int16)
    with pytest.raises(ValueError):
        tk.pbpr_stage1(b, tc.TINY62, 8)          # 8 does not divide 12
    with pytest.raises(ValueError):
        tk.pbpr_stage1(b, tc.TINY62, 3)          # not a power of two


# ---------------------------------------------------------------------------
# bucket_reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,T", [(16, 4), (8, 8)], ids=["Bt4", "Bt1"])
def test_bucket_reduce_tiny_vs_jax(B, T):
    W = 3
    C = tc.TINY62
    fields = dict(window_size=B.bit_length(), columns=16, pbpr_threads=T,
                  subtask_group=W)
    cfg = MSMConfig(curve=C, **fields)
    jcfg = JaxConfig(curve=jc.TINY62, backend="xla", **fields)
    assert cfg.half_columns == B
    pts, _ = ref.gen_points_scalars(C, W * B, seed=35)
    kill = np.random.default_rng(49).random((W, B)) < 0.3
    buckets = mont_buckets(C, pts, (W, B), kill)
    got = tpbpr.bucket_reduce(buckets, cfg)
    assert got.dtype == torch.int32 and got.shape == (3, 6, W)

    jb = jnp.asarray(buckets.numpy().astype(np.int32))
    want = jpbpr.bucket_reduce(ProjPoint(jb[0], jb[1], jb[2]), jcfg)
    assert np.array_equal(got.numpy(), np.asarray(jnp.stack(want)))

    decode = get_pipeline(cfg, "cpu")._decode_windows
    full, mine = decode(tk.pbpr_full(buckets, C, T)), decode(got)
    for w in range(W):
        direct = ref.INF
        for b in range(B):
            if not kill[w, b]:
                direct = ref.add(C, direct, ref.scalar_mul(
                    C, (*pts[w * B + b], 1), b + 1))
        assert ref.jac_eq(C, mine[w], full[w]), w
        assert ref.jac_eq(C, mine[w], direct), w


def test_bucket_reduce_s12_int32_buckets():
    """BN254_S12, int32 buckets, against pbpr_full and the direct sum."""
    W, B, T = 2, 16, 4
    C = tc.BN254_S12
    cfg = MSMConfig(curve=C, window_size=5, columns=16, pbpr_threads=T,
                    subtask_group=W)
    pts, _ = ref.gen_points_scalars(C, W * B, seed=36)
    kill = np.random.default_rng(50).random((W, B)) < 0.3
    buckets = mont_buckets(C, pts, (W, B), kill)
    decode = get_pipeline(cfg, "cpu")._decode_windows
    mine = decode(tpbpr.bucket_reduce(buckets.to(torch.int32), cfg))
    full = decode(tk.pbpr_full(buckets, C, T))
    for w in range(W):
        direct = ref.INF
        for b in range(B):
            if not kill[w, b]:
                direct = ref.add(C, direct, ref.scalar_mul(
                    C, (*pts[w * B + b], 1), b + 1))
        assert ref.jac_eq(C, mine[w], full[w]), w
        assert ref.jac_eq(C, mine[w], direct), w
