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
the split and the doubled stream are one kernel (csrc/glv_apply.cu; on
CPU tensors its plain version, torch ops on int64 halfwords), and the
digits of both magnitudes one `decompose_digits`. The pipelines call
`glv_rows`: the kernel encodes the wire limbs itself and writes the
doubled stream as the (2n, 2L) row table, so stage 1 under GLV is those
two launches. `apply_glv` keeps the JAX function's planar form, on
Montgomery inputs, for the tests that hold the port against it: CPU
tensors only (the card runs `glv_rows`). `split_scalars` and `B_LIMBS` live beside the
kernel's wrapper.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MSMConfig
from . import kernels
from .kernels import B_LIMBS, split_scalars  # noqa: F401  (public here)


def _check_windows(cfg: MSMConfig) -> None:
    W, s = cfg.num_windows, cfg.window_size
    # the top window reads halfword ((W-1)*s >> 4) + 1, which must exist
    if ((W - 1) * s >> 4) + 1 >= B_LIMBS:
        raise ValueError("apply_glv: the windows reach past the "
                         f"{B_LIMBS}-halfword magnitudes")


def apply_glv(xm: torch.Tensor, ym: torch.Tensor, halfwords: torch.Tensor,
              cfg: MSMConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Montgomery-encoded (L, n) points and raw (H, n) scalar halfwords ->
    the doubled GLV stream (xm', ym', digits): n' = 2n lanes of canonical
    limbs and (cfg.num_windows, 2n) int16 signed digits.

    Lanes [0, n) carry sign1 * P with the digits of |k1|, lanes [n, 2n)
    carry sign2 * phi(P) with the digits of |k2|. CPU tensors only: the
    card runs `glv_rows`."""
    _check_windows(cfg)
    x2, y2, mags, _, _ = kernels.glv_apply(xm, ym, halfwords.contiguous(),
                                           cfg.curve, cfg.glv_params)
    return x2, y2, kernels.decompose_digits(mags, cfg.window_size,
                                            cfg.num_windows)


def glv_rows(xs: torch.Tensor, ys: torch.Tensor, halfwords: torch.Tensor,
             cfg: MSMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 under GLV, from the wire: standard-form (L, n) limbs (int16
    or int32) and raw (H, n) halfwords (uint16 or int32), read in place ->
    the doubled stream's (2n, 2L) int16 row table (the rows of
    `apply_glv`'s xm', ym') and its (cfg.padded_windows, 2n) int16 digits,
    zero from cfg.num_windows up. Two launches: `kernels.glv_rows` and
    `decompose_digits`."""
    _check_windows(cfg)
    table, mags, _, _ = kernels.glv_rows(xs, ys, halfwords, cfg.curve,
                                         cfg.glv_params)
    return table, kernels.decompose_digits(
        mags, cfg.window_size, cfg.num_windows, cfg.padded_windows)
