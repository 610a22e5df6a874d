"""The plain versions of the port's kernels (tpu_msm_torch/cuzk/kernels.py)
against the JAX package, bit for bit, on CPU tensors.

TINY62: against the Pallas kernels themselves, in interpret mode as
tests/test_pallas_tiny.py runs them. BN254_S12: against the JAX
non-Pallas counterparts of the kernel bodies (tpu_msm/ops/rows.py run
eagerly, cuzk/decompose.py, a pmadd_rows chain for the scan). Also the
searchsorted bucket counts against `_bucket_counts`, and every profile's
limb constants against tpu_msm.constants. pbpr_full is in
test_torch_pbpr.py."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import decompose as jdecompose
from tpu_msm.cuzk import kernels as jk
from tpu_msm.cuzk.pipeline_pallas import _bucket_counts
from tpu_msm.ops import rows as jrows
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.cuzk.pipeline_cuda import bucket_counts

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

TINY_J, TINY_T = jc.TINY62, tc.TINY62
S12_J, S12_T = jc.BN254_S12, tc.BN254_S12


def canon(curve, rng, shape):
    return rng.integers(0, 1 << curve.log_limb_size,
                        (curve.num_limbs,) + shape).astype(np.int32)


def lazy_points(curve, rng, batch, dtype=np.int32):
    """(3, L, *batch) limbs in the lazy point range (-2^w, 2^(w+1)), top
    limb small and positive."""
    L, w = curve.num_limbs, curve.log_limb_size
    a = rng.integers(-(1 << w) + 1, 1 << (w + 1), (3, L) + batch)
    a[:, L - 1] = np.abs(a[:, L - 1]) % 8 + 1
    return a.astype(dtype)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jstack(p):
    return np.asarray(jnp.stack([jnp.stack(p.x), jnp.stack(p.y),
                                 jnp.stack(p.z)]))


def jproj(a):
    a = jnp.asarray(a, jnp.int32)
    return jrows.ProjRows(*(jrows.from_stacked(a[c]) for c in range(3)))


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny62", "bn254", "bn254_s12",
                                  "bn254_s13", "bn254_f13", "bls12_377",
                                  "bls12_377_s12", "bls12_377_s13",
                                  "bls12_377_f12"])
def test_profile_constants_match(name):
    J, T = jc.CURVES[name], tc.CURVES[name]
    for f in ("p", "scalar_modulus", "b_coeff", "gen_x", "gen_y",
              "num_limbs", "log_limb_size", "r_mod_p", "r2_mod_p", "rinv",
              "n0", "scalar_bits", "scalar_limbs_u32"):
        assert getattr(J, f) == getattr(T, f), f
    assert J.p_limbs() == T.p_limbs()
    assert J.r_limbs() == T.r_limbs() and J.r2_limbs() == T.r2_limbs()
    assert (jc.signed_fold_interval(J.log_limb_size)
            == tc.signed_fold_interval(T.log_limb_size))
    for k in (2, 4, 6, 18) if name != "bn254" else ():
        assert (jc.int_to_limbs(k * J.p, J.num_limbs, J.log_limb_size)
                == tc.int_to_limbs(k * T.p, T.num_limbs, T.log_limb_size))


def test_cuda_constant_table_layout():
    """The flat table handed to the kernels holds, in Consts<L> order:
    n0, 3b, p (L+1 limbs), R, R^2, 3bR, 2p, 4p, 6p, 18p."""
    C = S12_T
    L = C.num_limbs
    flat = tk._consts_host(C)
    assert len(flat) == 3 + 8 * L
    assert flat[:2] == [C.n0, 9]
    assert flat[2:3 + L] == tc.int_to_limbs(C.p, L + 1, 12)
    assert flat[3 + 7 * L:] == tc.int_to_limbs(18 * C.p, L, 12)


# ---------------------------------------------------------------------------
# encode_mont
# ---------------------------------------------------------------------------


def test_encode_mont_tiny_vs_pallas():
    xs = canon(TINY_J, np.random.default_rng(1), (64,))
    want = np.asarray(jk.encode_mont(jnp.asarray(xs), TINY_J))
    assert np.array_equal(tk.encode_mont(t(xs), TINY_T).numpy(), want)


def test_encode_mont_s12_vs_rows():
    xs = canon(S12_J, np.random.default_rng(2), (4, 16))
    want = np.asarray(jrows.to_stacked(
        jrows.to_mont_rows(jrows.from_stacked(jnp.asarray(xs)), S12_J)))
    assert np.array_equal(tk.encode_mont(t(xs), S12_T).numpy(), want)


# ---------------------------------------------------------------------------
# decompose_digits
# ---------------------------------------------------------------------------


def scalar_halfwords(curve, n, rng):
    from tpu_msm.utils.limbs_conversion import scalars_to_planar
    scalars = [int.from_bytes(rng.bytes(32), "little") % curve.scalar_modulus
               for _ in range(n)]
    hw = scalars_to_planar(scalars, curve)
    return np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.int32)


def test_decompose_digits_tiny_vs_pallas():
    cfg = JaxConfig(curve=TINY_J, window_size=8, columns=16, pbpr_threads=8,
                    subtask_group=8)
    hw = scalar_halfwords(TINY_J, 64, np.random.default_rng(3))
    want = np.asarray(jk.decompose_digits(jnp.asarray(hw), 8,
                                          cfg.num_windows))
    got = tk.decompose_digits(t(hw), 8, cfg.num_windows)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy().astype(np.int32), want)


@pytest.mark.parametrize("s", [12, 13, 16])
def test_decompose_digits_s12_vs_decompose(s):
    cfg = JaxConfig(curve=S12_J, window_size=s, columns=16, pbpr_threads=8,
                    subtask_group=4)
    hw = scalar_halfwords(S12_J, 128, np.random.default_rng(s))
    want = np.asarray(jdecompose.decompose(jnp.asarray(hw.astype(np.uint32)),
                                           cfg))
    got = tk.decompose_digits(t(hw), s, cfg.num_windows)
    assert np.array_equal(got.numpy().astype(np.int32), want)


# ---------------------------------------------------------------------------
# padd_batch / psub_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dt,out_dt", [(np.int16, np.int32),
                                          (np.int32, np.int16)])
def test_padd_psub_tiny_vs_pallas(in_dt, out_dt):
    rng = np.random.default_rng(4)
    p = lazy_points(TINY_J, rng, (2, 16), in_dt)
    q = lazy_points(TINY_J, rng, (2, 16), in_dt)
    tdt = {np.int16: torch.int16, np.int32: torch.int32}[out_dt]
    want = np.asarray(jk.padd_batch(jnp.asarray(p), jnp.asarray(q), TINY_J,
                                    out_dtype=out_dt))
    got = tk.padd_batch(t(p), t(q), TINY_T, out_dtype=tdt)
    assert got.dtype == tdt and np.array_equal(got.numpy(), want)
    if in_dt == np.int32:
        want = np.asarray(jk.psub_batch(jnp.asarray(p), jnp.asarray(q),
                                        TINY_J, out_dtype=out_dt))
        got = tk.psub_batch(t(p), t(q), TINY_T, out_dtype=tdt)
        assert np.array_equal(got.numpy(), want)


def test_padd_psub_s12_vs_rows():
    rng = np.random.default_rng(5)
    p = lazy_points(S12_J, rng, (2, 8), np.int16)
    q = lazy_points(S12_J, rng, (2, 8), np.int16)
    want = jstack(jrows.padd_rows(jproj(p), jproj(q), S12_J))
    got = tk.padd_batch(t(p), t(q), S12_T)
    assert np.array_equal(got.numpy(), want)
    qn = np.asarray(jk.pneg_stacked(jnp.asarray(q), S12_J))
    assert np.array_equal(tk.pneg_stacked(t(q), S12_T).numpy(), qn)
    want = jstack(jrows.padd_rows(jproj(p), jproj(qn), S12_J))
    got = tk.psub_batch(t(p), t(q), S12_T, out_dtype=torch.int16)
    assert np.array_equal(got.numpy(), want.astype(np.int16))


def test_inf_stacked_matches():
    want = np.asarray(jk.inf_stacked(S12_J, (3, 5)))
    assert np.array_equal(tk.inf_stacked(S12_T, (3, 5)).numpy(), want)


# ---------------------------------------------------------------------------
# prefix_scan
# ---------------------------------------------------------------------------


def scan_inputs(curve, Wg, C, R, seed):
    """Random Montgomery-limb point table and a sorted-payload stand-in:
    per window a random permutation with random sign bits."""
    rng = np.random.default_rng(seed)
    n = C * R
    X, Y = canon(curve, rng, (n,)), canon(curve, rng, (n,))
    pay = np.stack([(rng.permutation(n) << 1) | rng.integers(0, 2, n)
                    for _ in range(Wg)]).astype(np.int32)
    rows16 = np.concatenate([X, Y]).T.astype(np.int16)        # (n, 2L)
    return X, Y, pay, rows16


def test_prefix_scan_tiny_vs_pallas():
    """The port's (3, L, R, F) lanes against the TPU kernel's (8, F8)
    tiling of the same stream (pipeline_pallas.to_kernel8). One stream
    row per grid step: the row unroll is loop restructuring, bit-identical
    by tests/test_pallas_tiny.py, and costs minutes in interpret mode."""
    Wg, C, R = 2, 8, 4
    L, F = TINY_J.num_limbs, Wg * C
    F8, n8 = F // 8, R * F // 8
    X, Y, pay, rows16 = scan_inputs(TINY_J, Wg, C, R, 6)
    p8 = (pay.reshape(Wg, C, R).transpose(2, 0, 1).reshape(R, 8, F8)
          .swapaxes(0, 1).reshape(8, n8))
    perm8, sign8 = p8 >> 1, p8 & 1
    sx8 = X[:, perm8].reshape(L * 8, n8)
    sy8 = Y[:, perm8].reshape(L * 8, n8)
    tb = np.asarray(jk.prefix_scan(jnp.asarray(sx8), jnp.asarray(sy8),
                                   jnp.asarray(sign8), TINY_J, F8,
                                   unroll=1))
    want = (tb.reshape(3, L, 8, R, F8).transpose(0, 1, 3, 2, 4)
            .reshape(3, L, R, F))
    got = tk.prefix_scan(t(rows16), t(pay), TINY_T, C)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)


def test_prefix_scan_s12_vs_pmadd_chain():
    Wg, C, R = 2, 4, 3
    X, Y, pay, rows16 = scan_inputs(S12_J, Wg, C, R, 7)
    # lane f = w*C + c walks sorted positions c*R + r of window w
    pos = (np.arange(C) * R)[None, :]
    acc = jrows.proj_infinity_rows(S12_J, jnp.zeros(Wg * C, jnp.int32))
    steps = []
    for r in range(R):
        v = pay[:, pos[0] + r].reshape(-1)
        x = jrows.from_stacked(jnp.asarray(X[:, v >> 1]))
        y = jrows.from_stacked(jnp.asarray(Y[:, v >> 1]))
        y = jrows.select_rows(jnp.asarray((v & 1) != 0),
                              jrows.neg_rows(y, S12_J, 2), y)
        acc = jrows.pmadd_rows(acc, x, y, S12_J)
        steps.append(jstack(acc))
    want = np.stack(steps, axis=2).astype(np.int16)           # (3,L,R,F)
    got = tk.prefix_scan(t(rows16), t(pay), S12_T, C)
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# col_prefix
# ---------------------------------------------------------------------------


def test_col_prefix_tiny_vs_pallas():
    coltot = lazy_points(TINY_J, np.random.default_rng(8), (4, 8), np.int16)
    want = np.asarray(jk.col_prefix(jnp.asarray(coltot), TINY_J))
    got = tk.col_prefix(t(coltot), TINY_T)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)


def test_col_prefix_s12_vs_rows_levels():
    """The TPU kernel's level order, replayed with eager JAX rows."""
    Wg, C = 2, 4
    coltot = lazy_points(S12_J, np.random.default_rng(9), (Wg, C), np.int16)
    inf = np.asarray(jk.inf_stacked(S12_J, (Wg, C)))
    v = np.concatenate([inf[..., :1], coltot[..., :-1].astype(np.int32)], -1)
    for lv in range(2):
        k = 1 << lv
        sh = np.concatenate([inf[..., :k], v[..., :C - k]], -1)
        v = jstack(jrows.padd_rows(jproj(v), jproj(sh), S12_J))
    got = tk.col_prefix(t(coltot), S12_T)
    assert np.array_equal(got.numpy(), v.astype(np.int16))


# ---------------------------------------------------------------------------
# bucket counts (searchsorted) vs _bucket_counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [96, 512])
def test_bucket_counts_match(n):
    W, B = 4, 16
    rng = np.random.default_rng(n)
    keys2 = rng.integers(0, 2 * B + 2, (W, n)).astype(np.int32)
    keys2[1] = 0                  # every key below every query
    keys2[2] = 2 * B + 1          # every key at the top
    skeys2 = np.sort(keys2, axis=-1)
    want = np.asarray(_bucket_counts(jnp.asarray(keys2), n, B,
                                     jnp.asarray(skeys2)))
    got = bucket_counts(t(skeys2), B)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_wrapper_refuses_mixed_devices_and_profiles():
    p = torch.zeros((3, 6, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.padd_batch(p, p.to(torch.int16), TINY_T)
    with pytest.raises(ValueError):
        tk._profile("x", dataclasses.replace(TINY_T, num_limbs=7))
