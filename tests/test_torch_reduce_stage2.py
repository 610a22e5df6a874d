"""Stage 2 of the port's two-stage bucket reduction (`cuzk/pbpr.py`) as
one `kernels.pbpr_stage1` launch with threads = 1, on CPU tensors.

For k = T-1 .. 1, macc += m_k and msum += macc from infinity is stage
1's recurrence on the one slice m_1 .. m_{T-1}, walked from the top
down. Held bit for bit against the 2 (T-1) `padd_batch` launches that
`bucket_reduce` ran before (`padd_chain`), for T in {2, 4, 8, 64} at
TINY62 and BN254_S12 on int32 sums; `bucket_reduce` whole against the
function it was (`old_bucket_reduce`), T = 1 included (no stage-2 step,
msum infinity); the calls it makes; and `pbpr_stage1_geometry` at the
launch stage 2 gives it on the card (Wp lanes, B = T - 1 odd)."""

import numpy as np
import pytest
import torch

from tpu_msm_torch import constants as tc
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.cuzk import pbpr

from test_torch_kernels import lazy_points

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

NAMES = ["tiny62", "bn254_s12"]


def padd_chain(m, curve):
    """Stage 2 as `bucket_reduce` ran it before: 2 (T-1) dependent
    `padd_batch` launches on Wp lanes. Returns (macc, msum)."""
    T = m.shape[-1]
    mt = m.permute(3, 0, 1, 2).contiguous()              # (T, 3, L, Wp)
    macc = msum = kernels.inf_stacked(curve, (m.shape[2],), m.device)
    for k in range(T - 1, 0, -1):
        macc = kernels.padd_batch(macc, mt[k], curve)
        msum = kernels.padd_batch(msum, macc, curve)
    return macc, msum


def old_bucket_reduce(buckets, cfg):
    """`bucket_reduce` as it was, stage 2 on `padd_chain`."""
    curve = cfg.curve
    B = buckets.shape[-1]
    T = min(cfg.pbpr_threads, B)
    Bt = B // T
    m, g = kernels.pbpr_stage1(buckets, curve, T)
    t = T
    while t > 1:
        g = kernels.padd_batch(g[..., :t // 2], g[..., t // 2:t], curve)
        t //= 2
    _, msum = padd_chain(m, curve)
    for _ in range(Bt.bit_length() - 1):
        msum = kernels.pdbl_batch(msum, curve)
    return kernels.padd_batch(g[..., 0], msum, curve)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("T", [2, 4, 8, 64])
def test_stage2_is_one_stage1_launch(name, T):
    curve = tc.CURVES[name]
    Wp = 3
    m = torch.from_numpy(lazy_points(curve, np.random.default_rng(T),
                                     (Wp, T)))
    macc, msum = kernels.pbpr_stage1(m[..., 1:].contiguous(), curve, 1)
    assert macc.shape == msum.shape == (3, curve.num_limbs, Wp, 1)
    want_acc, want_sum = padd_chain(m, curve)
    assert torch.equal(macc[..., 0], want_acc)
    assert torch.equal(msum[..., 0], want_sum)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("B,T", [(8, 1), (8, 2), (16, 8), (128, 64)],
                         ids=["T1", "T2", "T8", "T64"])
def test_bucket_reduce_matches_the_old_function(name, B, T, monkeypatch):
    curve = tc.CURVES[name]
    Wp = 2
    cfg = MSMConfig(curve=curve, window_size=B.bit_length(), columns=16,
                    pbpr_threads=T, subtask_group=Wp)
    assert cfg.half_columns == B
    buckets = torch.from_numpy(lazy_points(
        curve, np.random.default_rng(B + T), (Wp, B), np.int16))
    want_sums = old_bucket_reduce(buckets, cfg)
    calls = []
    real = kernels.pbpr_stage1

    def spy(b, c, threads):
        calls.append((tuple(b.shape), threads))
        return real(b, c, threads)

    monkeypatch.setattr(kernels, "pbpr_stage1", spy)
    got = pbpr.bucket_reduce(buckets, cfg)
    assert got.dtype == torch.int32 and got.shape == (3, curve.num_limbs, Wp)
    assert torch.equal(got, want_sums)
    L = curve.num_limbs
    want = [((3, L, Wp, B), T)] + ([((3, L, Wp, T - 1), 1)] if T > 1 else [])
    assert calls == want


def test_t1_leaves_msum_at_infinity(monkeypatch):
    """T = 1: no stage-2 step; the doublings run on infinity and the last
    add takes g alone."""
    curve = tc.TINY62
    cfg = MSMConfig(curve=curve, window_size=4, columns=8, pbpr_threads=1,
                    subtask_group=2)
    buckets = torch.from_numpy(lazy_points(curve, np.random.default_rng(9),
                                           (2, 8)))
    doubled = []
    real = kernels.pdbl_batch
    monkeypatch.setattr(kernels, "pdbl_batch",
                        lambda p, c: doubled.append(p.clone()) or real(p, c))
    got = pbpr.bucket_reduce(buckets, cfg)
    inf = kernels.inf_stacked(curve, (2,))
    assert len(doubled) == 3 and torch.equal(doubled[0], inf)
    _, g = kernels.pbpr_stage1(buckets, curve, 1)
    msum = inf
    for _ in range(3):
        msum = kernels.pdbl_batch_plain(msum, curve)
    assert torch.equal(got, kernels.padd_batch(g[..., 0], msum, curve))


@pytest.mark.parametrize("Wp,T", [(16, 512), (20, 256), (9, 512), (1, 2)])
def test_stage2_geometry(Wp, T):
    """The stage-2 launch on the card: Wp lanes of one slice of T - 1
    buckets (511 at T = 512, odd), int32 sums; the geometry takes it and
    covers every lane once, in one wave."""
    geo = kernels.pbpr_stage1_geometry(Wp, T - 1, 1, 132, 22, 12)
    assert geo.blocks * geo.lanes_per_block >= Wp
    assert (geo.blocks - 1) * geo.lanes_per_block < Wp
    assert geo.waves == 1
    # the wrapper's own checks pass for B = T - 1, threads = 1
    assert kernels._pbpr_threads("pbpr_stage1", T - 1, 1) == 1
