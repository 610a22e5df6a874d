"""Device-side GLV scalar split and endomorphism point-stream doubling.

The port of `tpu_msm/cuzk/glv.py` (see `tpu_msm_torch/glv.py` for the
math and the parameter derivation): planar fixed-point Babai rounding on
16-bit halfword limbs, giving for each scalar k the pair (|k1|, |k2|)
and two sign masks with k = +-|k1| + lambda * (+-|k2|) mod r.

`apply_glv` then rewrites the pipeline inputs:

    points:  (P_i)          -> (sign1_i * P_i, sign2_i * phi(P_i))
    digits:  decompose(k)   -> decompose(|k1|) ++ decompose(|k2|)

so every later stage runs unchanged on a 2n-point stream with
`cfg.num_windows` halved. Signs are applied by negating y, not the
digits: a negated digit +2^(s-1) would leave the signed-digit range (and
int16 at s = 16).

In the JAX package these are XLA ops outside any Pallas kernel. Here
the split and the doubled stream are one kernel, `kernels.glv_apply`
(csrc/glv_apply.cu; on CPU tensors its plain version, torch ops on int64
halfwords), and the digits of both magnitudes one `decompose_digits`.
`split_scalars` and `B_LIMBS` live beside the kernel's wrapper.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MSMConfig
from . import kernels
from .kernels import B_LIMBS, split_scalars  # noqa: F401  (public here)


def apply_glv(xm: torch.Tensor, ym: torch.Tensor, halfwords: torch.Tensor,
              cfg: MSMConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Montgomery-encoded (L, n) points and raw (H, n) scalar halfwords ->
    the doubled GLV stream (xm', ym', digits): n' = 2n lanes of canonical
    limbs and (cfg.num_windows, 2n) int16 signed digits.

    Lanes [0, n) carry sign1 * P with the digits of |k1|, lanes [n, 2n)
    carry sign2 * phi(P) with the digits of |k2|."""
    curve = cfg.curve
    glvp = cfg.glv_params
    W, s = cfg.num_windows, cfg.window_size
    # the top window reads halfword ((W-1)*s >> 4) + 1, which must exist
    if ((W - 1) * s >> 4) + 1 >= B_LIMBS:
        raise ValueError("apply_glv: the windows reach past the "
                         f"{B_LIMBS}-halfword magnitudes")

    x2, y2, mags, _, _ = kernels.glv_apply(xm, ym, halfwords.contiguous(),
                                           curve, glvp)
    return x2, y2, kernels.decompose_digits(mags, s, W)
