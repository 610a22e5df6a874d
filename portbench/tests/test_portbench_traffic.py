"""The generator: the same seed gives the same inputs, every seed the
same sizes; scalars uniform below r in the layout of
`MSMPipeline.pack`; bases on the curve, tiled."""

import json
import os

import numpy as np
import pytest
import torch

import reference
import traffic
from conftest import BENCH_DIR


def load(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        cfg = json.load(f)
    return cfg, reference.Curve.from_config(cfg)


def ints(hw: torch.Tensor):
    a = hw.view(torch.int16).numpy().view("<u2").astype(object)
    return [sum(int(a[h, i]) << (16 * h) for h in range(a.shape[0]))
            for i in range(a.shape[1])]


def test_inputs_from_the_seed():
    cfg, curve = load("bn254")
    wl = {"name": "t", "n": 500, "k_base": 61, "scalar_sets": 2}
    seed = 2**31 + 11
    a = traffic.make_inputs(curve, cfg, wl, seed, torch.device("cpu"))
    b = traffic.make_inputs(curve, cfg, wl, seed, torch.device("cpu"))
    c = traffic.make_inputs(curve, cfg, wl, seed + 1, torch.device("cpu"))
    assert a.bases == b.bases and a.bases != c.bases
    assert all(torch.equal(x, y) for x, y in zip(a.scalar_sets,
                                                 b.scalar_sets))
    assert a.xs.shape == c.xs.shape == (22, 500) and a.xs.dtype == torch.int16
    assert a.xs.is_contiguous() and a.ys.is_contiguous()
    assert [s.shape for s in a.scalar_sets] == [(18, 500)] * 2
    assert a.scalar_sets[0].dtype == torch.uint16
    assert len(set(a.bases)) == 61 and all(map(curve.on_curve, a.bases))
    # tiled: column i holds base i mod 61, as 12-bit limbs, the last tile
    # cut short
    x = [sum(int(a.xs[k, i]) << (12 * k) for k in range(22))
         for i in range(500)]
    assert x == [a.bases[i % 61][0] for i in range(500)]
    hw = a.scalar_sets[0]
    assert not hw[16:].any()
    ks = ints(hw)
    assert all(0 <= k < curve.r for k in ks)
    assert not torch.equal(a.scalar_sets[0], a.scalar_sets[1])


def test_scalars_uniform_below_r():
    for name in ("bn254", "bls12_377"):
        _, curve = load(name)
        gen = torch.Generator().manual_seed(3)
        v = traffic.uniform_scalars(curve.r, 20000, gen, torch.device("cpu"))
        ks = [sum(int(v[h, i]) << (16 * h) for h in range(v.shape[0]))
              for i in range(v.shape[1])]
        assert max(ks) < curve.r
        # the top eighth of [0, r) gets about an eighth of the draws
        top = sum(k >= curve.r * 7 // 8 for k in ks) / len(ks)
        assert 0.11 < top < 0.14, (name, top)
        # and the top bit as often as it is set in [0, r)
        bits = curve.r.bit_length()
        assert abs(np.mean([k >> (bits - 1) for k in ks])
                   - (1 - 2 ** (bits - 1) / curve.r)) < 0.015, name


def test_every_cell_tiles_its_bases_with_an_odd_period():
    """An offset of a power of two (a tile, a block, a pass, an index cut
    to fewer bits) never keeps a point's base, so a call that reads its
    bases at such an offset computes another MSM."""
    folder = os.path.join(BENCH_DIR, "workloads")
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            k = json.load(f)["k_base"]
        assert k % 2 == 1, name
        assert all((1 << b) % k for b in range(25)), name


def test_an_even_period_is_refused():
    cfg, curve = load("bn254")
    wl = {"name": "t", "n": 128, "k_base": 64, "scalar_sets": 1}
    with pytest.raises(ValueError, match="even"):
        traffic.make_inputs(curve, cfg, wl, 1, torch.device("cpu"))
