"""The least time of one MSM call on an NVIDIA H100: the yardstick of
the `kernels_roofline` metric.

Frozen here so that no later change to the program can move it. The
work is the bucket method's, whatever kernels do it: in each pass, n
mixed adds a window to fill the buckets, and 2 B running-sum adds a
window to reduce them, 12 Montgomery multiplies each. A multiply is
counted as the int32 multiply and multiply-add instructions of a
word-wide Montgomery multiply at the curve's word count, 2 operations
each. The bytes are each input read once and the window sums written
once.

The peaks: NVIDIA publishes no int32 rate for the H100 SXM, so it is
derived as 64 int32 lanes x 132 SMs x 1.98 GHz x 2 operations a
multiply-add = 33.5 T op/s; HBM3 at 3.35 TB/s (NVIDIA's data sheet).
Both assume the card's full power limit of 700 W.
"""

from __future__ import annotations

INT32_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
MULS_PER_ADD = 12


def mul_wide_mads(num_limbs: int, limb_bits: int) -> int:
    """int32 multiply and multiply-add instructions of one word-wide
    Montgomery multiply, each .lo and .hi half counted: N = ceil(L w / 32)
    words, NF = floor(L w / 32); N^2 word products for a b, then NF
    whole-word reduction steps and, where L w is no multiple of 32, one
    for the last bits, each an m digit (one .lo) and NF word products of
    m p. 315 at BN254 (L = 22, w = 12), 588 at BLS12-377 (L = 32)."""
    bits = num_limbs * limb_bits
    n, nf = -(-bits // 32), bits // 32
    steps = nf + (1 if bits % 32 else 0)
    return 2 * n * n + steps * (1 + 2 * nf)


def msm_adds(n: int, windows: int, buckets: int, passes: int) -> int:
    """Point additions of the bucket method: n W mixed adds over all
    passes, and 2 B W running-sum adds in each pass."""
    return n * windows + passes * 2 * buckets * windows


def msm_ops(n: int, windows: int, buckets: int, passes: int,
            num_limbs: int, limb_bits: int) -> int:
    """int32 operations of one MSM call."""
    return (msm_adds(n, windows, buckets, passes) * MULS_PER_ADD
            * 2 * mul_wide_mads(num_limbs, limb_bits))


def msm_bytes(n: int, num_limbs: int, halfword_rows: int,
              windows: int) -> int:
    """Bytes of one MSM call: the int16 x and y limbs and the uint16
    scalar halfwords read once, the (3, L, W) int32 window sums written
    once."""
    return (n * (2 * num_limbs * 2 + halfword_rows * 2)
            + 3 * num_limbs * windows * 4)


def bound_ms(ops: int, nbytes: int) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")
