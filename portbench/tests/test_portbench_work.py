"""The frozen work counts at both profiles."""

import pytest

import work


def test_mul_wide_mads():
    assert work.mul_wide_mads(22, 12) == 315     # BN254_S12, 9 words
    assert work.mul_wide_mads(32, 12) == 588     # BLS12_377_S12, 12 words
    assert work.mul_wide_mads(21, 13) == 315     # BN254_S13, 273 bits


@pytest.mark.parametrize("L, ms", [(22, 4.0228), (32, 7.5092)])
def test_bound_at_2p20(L, ms):
    # s = 16: W = 16 windows, B = 2^15 buckets, one pass
    adds = work.msm_adds(1 << 20, 16, 1 << 15, 1)
    assert adds == (1 << 20) * 16 + 2 * (1 << 15) * 16
    ops = work.msm_ops(1 << 20, 16, 1 << 15, 1, L, 12)
    nbytes = work.msm_bytes(1 << 20, L, 18, 16)
    bound, by = work.bound_ms(ops, nbytes)
    assert by == "operations"
    assert bound == pytest.approx(ms, rel=1e-4)


def test_bound_at_2p24_counts_every_pass():
    one = work.msm_adds(1 << 24, 16, 1 << 15, 1)
    four = work.msm_adds(1 << 24, 16, 1 << 15, 4)
    assert four - one == 3 * 2 * (1 << 15) * 16
    bound, _ = work.bound_ms(work.msm_ops(1 << 24, 16, 1 << 15, 4, 22, 12),
                             work.msm_bytes(1 << 24, 22, 18, 16))
    assert bound == pytest.approx(61.525, rel=1e-4)


def test_bytes_bound_when_work_is_small():
    bound, by = work.bound_ms(0, 3_350_000_000)
    assert by == "bytes" and bound == pytest.approx(1.0)
