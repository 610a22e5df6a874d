"""Shared pieces of the tests of the port's XLA path
(tests/test_torch_twin*.py): the configs, the inputs, one run of JAX
`_windows_device` under jit, and the comparisons, bit for bit and by
decoded group value."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk.pipeline import _windows_device as jax_windows_device
from tpu_msm_torch import constants as tc
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.cuzk.pipeline import get_pipeline
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import planar_signed_to_ints_modp

# Small configs: JAX's compile of the XLA path grows with its point
# formulas (the scan levels, the reduction's tree and doublings), not with
# the windows. TINY62: 16 windows in 4 groups of 4, 8 rows of 8 columns
# at 64 points, 2 slices of 4 buckets (two doublings). BN254_S12: 85
# windows (96 padded, 6 groups of 16; under GLV 43 windows, 3 groups), 4
# columns, 2 slices of 2 buckets (one doubling).
FIELDS = {
    "tiny62": dict(window_size=4, columns=8, pbpr_threads=2,
                   subtask_group=4),
    "bn254_s12": dict(window_size=3, columns=4, pbpr_threads=2,
                      subtask_group=16),
}
N = 64


def config(name, glv=False, backend="xla"):
    return MSMConfig(curve=tc.CURVES[name], glv=glv, backend=backend,
                     **FIELDS[name])


def jax_config(name, glv=False):
    return JaxConfig(curve=jc.CURVES[name], glv=glv, backend="xla",
                     **FIELDS[name])


@functools.lru_cache(maxsize=None)
def inputs(name, seed=101):
    """(points, scalars, xs, ys, halfwords) of N points: random scalars,
    and the same scalar on 40 of the points, so that each window has a
    bucket run of at least 40 positions, across several columns."""
    cfg = config(name)
    pts, scalars = ref.gen_points_scalars(cfg.curve, N, seed=seed)
    scalars[8:48] = [scalars[8]] * 40
    xs, ys, hw = get_pipeline(cfg, "cpu").pack(pts, scalars)
    return pts, scalars, xs, ys, hw


def tensors(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def jax_windows(name, glv, xs, ys, hw) -> np.ndarray:
    """JAX `_windows_device` under jit -> (3, L, Wp) int32."""
    fn = jax.jit(functools.partial(jax_windows_device,
                                   cfg=jax_config(name, glv)))
    g = fn(jnp.asarray(xs), jnp.asarray(ys),
           jnp.asarray(hw.astype(np.uint32)))
    return np.stack([np.asarray(g.x), np.asarray(g.y), np.asarray(g.z)])


def decode(arr, curve):
    """(3, L, k) signed lazy Montgomery limbs -> k Jacobian int tuples."""
    arr = np.asarray(arr)
    out = []
    for x, y, z in zip(*(planar_signed_to_ints_modp(a, curve) for a in arr)):
        if z == 0:
            out.append(ref.INF)
        else:
            zi = pow(z, -1, curve.p)
            out.append((x * zi % curve.p, y * zi % curve.p, 1))
    return out


def same_points(curve, got, want):
    assert len(got) == len(want)
    for w, (a, b) in enumerate(zip(got, want)):
        assert ref.jac_eq(curve, a, b), f"window {w}"


def check_windows(curve, got: torch.Tensor, want: np.ndarray):
    """The port's window sums against JAX's: the same int32 limbs, and
    so the same points after decoding."""
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    same_points(curve, decode(got, curve), decode(want, curve))
