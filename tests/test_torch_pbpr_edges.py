"""pbpr_full's plain version against the JAX Pallas kernel in interpret
mode on TINY62, bit for bit, at the edges of the launch geometry of its
CUDA kernel: T = 1 (no scan levels), T = B (one bucket a slice, no
doublings), one window, and three windows with both scans three levels
deep. Each shape costs the interpret-mode kernel some 40 s, so the
kernel's schedule and geometry are held apart, in
test_torch_pbpr_schedule.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.cuzk import kernels as jk
from tpu_msm_torch import constants as tc
from tpu_msm_torch.cuzk import kernels as tk
from tpu_msm_torch.reference import curve as ref

from test_torch_pbpr import mont_buckets

torch.set_num_threads(1)


@pytest.mark.parametrize("Wp,B,T", [(2, 8, 1), (2, 8, 8), (1, 16, 4),
                                    (3, 64, 8)])
def test_pbpr_full_edges_tiny_vs_pallas(Wp, B, T):
    C = tc.TINY62
    pts, _ = ref.gen_points_scalars(C, Wp * B, seed=60 + T)
    kill = np.random.default_rng(61 + B).random((Wp, B)) < 0.3
    buckets = mont_buckets(C, pts, (Wp, B), kill)
    want = np.asarray(jk.pbpr_full(jnp.asarray(buckets.numpy()), jc.TINY62,
                                   T))
    got = tk.pbpr_full(buckets, C, T)
    assert got.dtype == torch.int32 and got.shape == (3, C.num_limbs, Wp)
    assert np.array_equal(got.numpy(), want)
