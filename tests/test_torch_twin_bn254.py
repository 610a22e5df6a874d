"""The port's XLA path at BN254_S12 against the JAX functions, bit for
bit (so equal by decoded value): `smvp.bucket_accumulate` on the first
window group, and `pipeline._windows_device` without GLV, unsharded and
at w_shards = 2 for both w_index (each shard against its block of the
JAX window sums). Each JAX function is one jit, a minute or more of
XLA's compile on a cold cache; the GLV case is in
tests/test_torch_twin_glv.py, so that the two compiles can run on two
test workers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_twin as tw
from tpu_msm.cuzk import smvp as jsmvp
from tpu_msm_torch.cuzk import decompose, kernels, smvp
from tpu_msm_torch.cuzk.pipeline import _windows_device
from tpu_msm_torch.cuzk.pipeline_cuda import windows_device

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

NAME = "bn254_s12"


def test_bucket_accumulate_matches_jax_bn254():
    """The first group: 16 windows of 16 rows by 4 columns, each with a
    run of 40 positions (three columns continue one bucket)."""
    cfg = tw.config(NAME)
    _, _, xs, ys, hw = tw.inputs(NAME)
    xm, ym = decompose.points_to_mont(*tw.tensors(xs, ys), cfg.curve)
    digits = decompose.decompose(torch.from_numpy(hw), cfg)[
        :cfg.subtask_group].to(torch.int32)
    kernels.reset_launches()
    got = smvp.bucket_accumulate(xm, ym, digits, cfg)
    assert set(kernels.LAUNCHES.values()) == {0}      # plain on the CPU
    fn = jax.jit(lambda x, y, d: jsmvp.bucket_accumulate(
        x, y, d, tw.jax_config(NAME)))
    want = fn(*(jnp.asarray(a.numpy()) for a in (xm, ym, digits)))
    assert np.array_equal(np.stack([np.asarray(a) for a in want]),
                          got.numpy())


def test_windows_device_matches_jax_bn254():
    cfg = tw.config(NAME)
    _, _, xs, ys, hw = tw.inputs(NAME)
    got = _windows_device(*tw.tensors(xs, ys, hw), cfg=cfg)
    want = tw.jax_windows(NAME, False, xs, ys, hw)
    tw.check_windows(cfg.curve, got, want)
    tw.same_points(cfg.curve, tw.decode(got, cfg.curve)[:cfg.num_windows],
                   tw.decode(windows_device(*tw.tensors(xs, ys, hw), cfg),
                             cfg.curve)[:cfg.num_windows])
    Wl = cfg.padded_windows // 2
    for i in range(2):
        g = _windows_device(*tw.tensors(xs, ys, hw), cfg=cfg, w_shards=2,
                            w_index=i)
        tw.check_windows(cfg.curve, g, want[:, :, i * Wl:(i + 1) * Wl])
