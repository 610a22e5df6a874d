"""The plain reference against known values, and the linearity of its
tiled sums."""

import json
import os
import random

import numpy as np
import pytest

import reference
from conftest import BENCH_DIR


def curve(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        return reference.Curve.from_config(json.load(f))


# 2G on BN254 (alt_bn128), as Ethereum's precompile tests give it
BN254_2G = (
    0x030644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD3,
    0x15ED738C0E0A7C92E7845F96B2AE9C0A68A6A449E3538FC7FF3EBF7A5A18A2C4)


def test_bn254_known_values():
    c = curve("bn254")
    assert c.gen == (1, 2) and c.on_curve(c.gen)
    assert c.add(c.gen, c.gen) == BN254_2G
    assert c.mul(c.gen, 2) == BN254_2G
    assert c.mul(c.gen, c.r - 1) == (1, c.p - 2)
    assert c.mul(c.gen, c.r) is None
    assert c.msm([c.gen, c.gen], [1, 1]) == BN254_2G
    assert c.msm([c.gen, BN254_2G], [2, c.r - 1]) is None


@pytest.mark.parametrize("name", ["bn254", "bls12_377"])
def test_group_order_and_inverse(name):
    c = curve(name)
    assert c.on_curve(c.gen)
    assert c.mul(c.gen, c.r) is None
    assert c.mul(c.gen, c.r - 1) == c.neg(c.gen)
    assert c.add(c.gen, c.neg(c.gen)) is None
    p3 = c.mul(c.gen, 3)
    assert c.on_curve(p3) and c.add(c.mul(c.gen, 2), c.gen) == p3


def halfwords(scalars, H):
    return np.array([[(k >> (16 * h)) & 0xFFFF for k in scalars]
                     for h in range(H)], dtype=np.uint16)


@pytest.mark.parametrize("name", ["bn254", "bls12_377"])
def test_tiled_sum_is_the_msm(name):
    c = curve(name)
    rng = random.Random(5)
    K, n = 5, 23
    bases = [c.mul(c.gen, rng.randrange(1, c.r)) for _ in range(K)]
    scalars = [rng.randrange(c.r) for _ in range(n)]
    direct = None
    for i, k in enumerate(scalars):
        direct = c.add(direct, c.mul(bases[i % K], k))
    hw = halfwords(scalars, 18)     # with the two zero pad rows
    assert reference.expected_msm(c, bases, hw) == direct
    assert reference.aggregate(hw, K, c.r) == [
        sum(scalars[j::K]) % c.r for j in range(K)]


@pytest.mark.parametrize("dropped", [1, 3, 15])
def test_dropped_bits_are_the_lower_precision(dropped):
    c = curve("bn254")
    rng = random.Random(6)
    scalars = [rng.randrange(c.r) for _ in range(8)]
    hw = halfwords(scalars, 16)
    assert reference.aggregate(hw, 2, c.r, dropped_bits=dropped) == [
        sum(k >> dropped << dropped for k in scalars[j::2]) % c.r
        for j in range(2)]


def test_aggregate_takes_a_partial_tile():
    c = curve("bn254")
    rng = random.Random(7)
    scalars = [rng.randrange(c.r) for _ in range(23)]
    hw = halfwords(scalars, 16)
    assert reference.aggregate(hw, 5, c.r) == [
        sum(scalars[j::5]) % c.r for j in range(5)]


def test_from_jacobian():
    c = curve("bn254")
    x, y = BN254_2G
    z = 12345
    assert c.from_jacobian(x * z * z % c.p, y * z ** 3 % c.p, z) == BN254_2G
    assert c.from_jacobian(1, 1, 0) is None
