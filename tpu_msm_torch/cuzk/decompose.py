"""The JAX package's stage-1 functions: Montgomery encoding of the points
and the signed scalar-window decomposition.

The port of `tpu_msm/cuzk/decompose.py`, kept as the counterpart of the
JAX functions for the parity tests; both device programs run
`pipeline_cuda.stage1` (`encode_rows` and `decompose_digits` from the
wire tensors) instead. `points_to_mont` runs the
`encode_mont` kernel on each coordinate, and `decompose` the
`decompose_digits` kernel (on CPU tensors, their plain versions), which
the JAX package's kernels make bit-identical to its XLA functions
(`tpu_msm/cuzk/kernels.py` encode_mont and decompose_digits).
`extract_windows` and `signed_digits` are the XLA functions themselves
in torch, kept for parity and tests.

The JAX functions compute in uint32; these compute in int32 (halfwords
< 2^16, a window of at most 16 bits and a carry), with the same values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import MSMConfig
from ..constants import CurveParams
from . import kernels

I32 = torch.int32
I64 = torch.int64


def points_to_mont(xs: torch.Tensor, ys: torch.Tensor, curve: CurveParams
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard-form planar affine coordinates, (L, n) int32 canonical
    limbs -> Montgomery form (canonical limbs, value < 2p)."""
    return (kernels.encode_mont(xs.to(I32).contiguous(), curve),
            kernels.encode_mont(ys.to(I32).contiguous(), curve))


def extract_windows(halfwords: torch.Tensor, window_size: int,
                    num_windows: int) -> torch.Tensor:
    """(H, n) 16-bit halfwords -> (W, n) int32 raw unsigned windows.

    Window w covers scalar bits [w s, (w+1) s); with s <= 16 it spans at
    most two halfwords (the pad halfwords of `MSMPipeline.pack` cover the
    reads past the scalar's top bit)."""
    s = window_size
    mask = (1 << s) - 1
    hw = halfwords.to(I64)
    rows = []
    for w in range(num_windows):
        bit = w * s
        i, off = bit >> 4, bit & 15
        val = hw[i] >> off
        if off:
            val = val | (hw[i + 1] << (16 - off))
        rows.append(val & mask)
    return torch.stack(rows).to(I32)


def signed_digits(raw: torch.Tensor, window_size: int) -> torch.Tensor:
    """Raw windows -> int32 signed digits in [-2^(s-1), 2^(s-1)),
    carry-chained across windows: scalar == sum_w d_w 2^(s w)."""
    s = window_size
    half = 1 << (s - 1)
    out = []
    carry = torch.zeros(raw.shape[1:], dtype=I32, device=raw.device)
    for w in range(raw.shape[0]):
        val = raw[w].to(I32) + carry
        ge = val >= half
        out.append(val - ge.to(I32) * (1 << s))
        carry = ge.to(I32)
    return torch.stack(out)


def decompose(halfwords: torch.Tensor, cfg: MSMConfig) -> torch.Tensor:
    """(H, n) scalar halfwords -> (W, n) int16 signed digits, through the
    `decompose_digits` kernel: the values of
    signed_digits(extract_windows(...))."""
    return kernels.decompose_digits(halfwords.to(I32).contiguous(),
                                    cfg.window_size, cfg.num_windows)
