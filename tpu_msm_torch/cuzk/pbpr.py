"""The two-stage parallel bucket-points reduction (cuZK Alg. 4).

The port of `tpu_msm/cuzk/pbpr.py` `bucket_reduce`, a second form of
stage 4 beside `kernels.pbpr_full` (which `windows_device` goes on
calling): the same buckets in, the same window sums out. With bucket b
(0-based) holding multiplier b+1 and b = t*Bt + j:

    sum_b (b+1) * S_b  =  sum_t g_t  +  Bt * sum_{k=1}^{T-1} M_k

where g_t = sum_j (j+1) * S_{t,j}, m_t = sum_j S_{t,j} and
M_k = sum_{t>=k} m_t. Stage 1 (m and g of every slice) is
`kernels.pbpr_stage1`; the halving tree over the T slices for sum_t g_t
and the last add are `kernels.padd_batch`; the log2(Bt) doublings are
`kernels.pdbl_batch`. The operations run in the JAX function's order, so
the result is bit-identical to it.

Stage 2 is sequential by the algorithm: for k = T-1 .. 1,
macc += m_k; msum += macc, from infinity. That is stage 1's recurrence
(m += bucket; g += m, walked from the top down) on one slice of the T-1
buckets m_1 .. m_{T-1}, so it is one more `pbpr_stage1` launch with
threads = 1: Wp lanes, each a chain of T-1 steps, in place of 2 (T-1)
`padd_batch` launches.
"""

from __future__ import annotations

import torch

from ..config import MSMConfig
from . import kernels


def bucket_reduce(buckets: torch.Tensor, cfg: MSMConfig) -> torch.Tensor:
    """(3, L, Wp, B) int16 or int32 buckets, slot b = multiplier b+1 ->
    (3, L, Wp) int32 window sums G_w = sum_b (b+1) * bucket_{w,b}."""
    curve = cfg.curve
    _, _, Wp, B = buckets.shape
    T = min(cfg.pbpr_threads, B)
    Bt = B // T
    if T * Bt != B:
        raise ValueError("pbpr_threads must divide the bucket count")

    m, g = kernels.pbpr_stage1(buckets, curve, T)        # (3, L, Wp, T)

    # g_total = sum_t g_t: static halving tree over the T axis
    t = T
    while t > 1:
        g = kernels.padd_batch(g[..., :t // 2], g[..., t // 2:t], curve)
        t //= 2
    g_total = g[..., 0]

    # offset part: Bt * sum_{k=1}^{T-1} M_k, M_k the suffix sums of m:
    # (macc, msum) is stage 1 of the one slice m_1 .. m_{T-1}
    if T > 1:
        _, msum = kernels.pbpr_stage1(m[..., 1:].contiguous(), curve, 1)
        msum = msum[..., 0].contiguous()                 # (3, L, Wp)
    else:
        msum = kernels.inf_stacked(curve, (Wp,), buckets.device)

    for _ in range(Bt.bit_length() - 1):                 # log2(Bt) doublings
        msum = kernels.pdbl_batch(msum, curve)

    return kernels.padd_batch(g_total, msum, curve)
