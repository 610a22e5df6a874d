"""Pipeline stage 2 of the XLA path: group point indices by bucket.

The port of `tpu_msm/cuzk/sort.py`: the signed-bucket fold of the
digits, a stable sort of each window's keys, and the CSC column pointers
(histogram and exclusive prefix sum) for parity and tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

I32 = torch.int32


def bucket_keys(digits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed digits -> (int32 bucket index |d|, negative-sign mask): a
    digit d adds P to bucket d, -d adds -P to bucket d, and 0 lands in the
    discard bucket 0."""
    d = digits.to(I32)
    return d.abs(), d < 0


def sort_by_bucket(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of (..., n) keys along the last axis: (sorted keys,
    int64 permutation). The JAX function's argsort is stable too, so the
    permutation is the same."""
    return torch.sort(keys, dim=-1, stable=True)


def csc_col_ptr(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(..., n) keys in [0, num_buckets) -> (..., num_buckets + 1) int32
    column pointers, ptr[..., b+1] - ptr[..., b] the count of b."""
    one_hot = (keys[..., None] == torch.arange(
        num_buckets, dtype=keys.dtype, device=keys.device)).to(I32)
    hist = one_hot.sum(dim=-2, dtype=I32)
    zeros = hist.new_zeros(hist.shape[:-1] + (1,))
    return torch.cat([zeros, torch.cumsum(hist, dim=-1, dtype=I32)], dim=-1)
