"""The one generator of every cell's inputs, from its workload file and
its configuration file and the run's seed.

A cell's traffic is one prover calling MSMs back to back on bases it
keeps on the card (the proving key's points) with fresh scalars (the
witness) from host memory:

  * bases: `k_base` random affine points P_j = k_j G, k_j drawn from
    the seed in [1, r), point i taking base i mod k_base (the last tile
    cut short), held on the device as the (L, n) int16 wire limbs x and
    y (canonical, standard form, w-bit limbs). `k_base` is odd, so that
    no offset of a power of two (a tile, a block, a pass, an index cut
    to fewer bits) maps a point onto one with the same base: a call
    that reads its bases at such an offset gets another MSM;
  * scalars: `scalar_sets` sets of n scalars drawn uniformly below r on
    the device from the seed, each held in pinned host memory as
    (H + 2, n) uint16 halfwords, little-endian, the last two rows zero
    (the layout of `MSMPipeline.pack`); calls take the sets in turn.

Every seed gives the same sizes; only the values change.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Tuple

import torch

from reference import Affine, Curve

# Scalars are drawn this many at a time, so that drawing them takes less
# device memory than an MSM call.
SCALAR_CHUNK = 1 << 22


@dataclasses.dataclass
class Inputs:
    bases: List[Tuple[int, int]]     # the k_base distinct points
    xs: torch.Tensor                 # (L, n) int16 on the device
    ys: torch.Tensor
    scalar_sets: List[torch.Tensor]  # (H + 2, n) uint16, pinned on CUDA


def halfword_rows(r: int) -> int:
    """H: 16-bit halfwords of a scalar in whole 32-bit words."""
    return 2 * -(-r.bit_length() // 32)


def random_bases(curve: Curve, k: int, seed: int) -> List[Tuple[int, int]]:
    """k points k_j G, k_j uniform in [1, r) from `seed`; sums of a
    table of the generator's doublings."""
    rng = random.Random(seed)
    doublings: List[Affine] = [curve.gen]
    for _ in range(curve.r.bit_length()):
        doublings.append(curve.add(doublings[-1], doublings[-1]))
    out = []
    for _ in range(k):
        kj = rng.randrange(1, curve.r)
        acc = None
        for i in range(kj.bit_length()):
            if kj >> i & 1:
                acc = curve.add(acc, doublings[i])
        out.append(acc)
    return out


def limbs(values: List[int], num_limbs: int, limb_bits: int) -> torch.Tensor:
    """(L, len(values)) int16 w-bit limbs, little-endian (w <= 13)."""
    mask = (1 << limb_bits) - 1
    return torch.tensor([[(v >> (limb_bits * i)) & mask for v in values]
                         for i in range(num_limbs)], dtype=torch.int16)


def uniform_scalars(r: int, n: int, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """(H, n) int32 halfwords of n scalars uniform in [0, r): draws of
    r.bit_length() bits, each draw at or above r drawn again."""
    H, bits = halfword_rows(r), r.bit_length()
    top = (bits - 1) // 16
    r_hw = [(r >> (16 * h)) & 0xFFFF for h in range(H)]

    def draw(m: int) -> torch.Tensor:
        v = torch.randint(0, 1 << 16, (H, m), generator=gen, device=device,
                          dtype=torch.int32)
        v[top] &= (1 << (bits - 16 * top)) - 1
        v[top + 1:] = 0
        return v

    v = draw(n)
    while True:
        gt = torch.zeros(v.shape[1], dtype=torch.bool, device=device)
        eq = torch.ones_like(gt)
        for h in range(top, -1, -1):
            gt |= eq & (v[h] > r_hw[h])
            eq &= v[h] == r_hw[h]
        redo = (gt | eq).nonzero().squeeze(1)
        if redo.numel() == 0:
            return v
        v[:, redo] = draw(redo.numel())


def make_inputs(curve: Curve, cfg: dict, wl: dict, seed: int,
                device: torch.device) -> Inputs:
    n, k_base = wl["n"], wl["k_base"]
    if k_base % 2 == 0:
        raise ValueError(f"{wl['name']}: k_base={k_base} is even; an "
                         "offset of a power of two could keep a point's base")
    L, w = cfg["num_limbs"], cfg["limb_bits"]
    bases = random_bases(curve, k_base, seed)
    reps = -(-n // k_base)

    def tiled(values):
        return limbs(values, L, w).to(device).repeat(1, reps)[:, :n] \
            .contiguous()
    xs = tiled([b[0] for b in bases])
    ys = tiled([b[1] for b in bases])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    pinned = device.type == "cuda"
    H = halfword_rows(curve.r)
    sets = []
    for _ in range(wl["scalar_sets"]):
        host = torch.zeros((H + 2, n), dtype=torch.int16, pin_memory=pinned)
        for lo in range(0, n, SCALAR_CHUNK):
            v = uniform_scalars(curve.r, min(SCALAR_CHUNK, n - lo), gen,
                                device)
            # uint16 bit patterns through int16, whose casts are defined
            host[:-2, lo:lo + v.shape[1]].copy_(
                (v - (v >> 15) * (1 << 16)).to(torch.int16))
        sets.append(host.view(torch.uint16))
    return Inputs(bases, xs, ys, sets)
