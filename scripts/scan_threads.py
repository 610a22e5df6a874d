#!/usr/bin/env python3
"""Time `prefix_scan` for every number of threads per lane it is built
for, over lane counts about the edges of its launcher's rule, at four
profiles, on one card.

    python3 scripts/scan_threads.py

For each profile (BN254_S12 and BLS12_377_S12 at every shape of SHAPES,
BN254_S13 and BLS12_377_S13 at the default schedule's 8,192 lanes and
`SCHEDULE`'s 131,072) it first holds every G of
`kernels.SCAN_THREADS_PER_LANE` bit for bit against `prefix_scan_plain`
at (Wg, C, R) = (3, 37, 5), then, on inputs made from a fixed seed
(random 12- or 13-bit limbs, a permuted payload with random signs),
checks that every G gives the same output and times each G twice with
CUDA events around 5 back-to-back calls, in the order 2, ..., G_max and
back, printing the faster of the two beside both. The first line is the
card's name and power limit. What a G = 3 build gave (the kernel and
SCAN_THREADS_PER_LANE then included it) is in PERF.md.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tpu_msm_torch import _build  # noqa: E402
from tpu_msm_torch.constants import (BLS12_377_S12, BLS12_377_S13,  # noqa: E402
                                     BN254_S12, BN254_S13)
from tpu_msm_torch.cuzk import kernels  # noqa: E402

# (Wg, C, R): about the edges where a block of G = 6 (20 lanes) more
# comes to an SM of 132 (2,640, 5,280, 7,920, 10,560 lanes) and a second
# block of G = 2 (64 lanes) does (8,448), the default schedule's 8,192,
# and 2^20 elements over 2, 4 and 16 windows.
SHAPES = ((1, 2048, 128), (1, 4096, 128), (1, 5632, 128), (1, 7920, 128),
          (1, 7936, 128), (1, 8192, 128), (1, 8448, 128), (1, 8704, 128),
          (1, 10560, 128), (1, 12288, 128), (2, 8192, 64), (4, 8192, 32),
          (16, 8192, 16))
NARROW = ((1, 8192, 128), (16, 8192, 16))


def inputs(rng, curve, Wg, C, R):
    L, n = curve.num_limbs, C * R
    table = torch.from_numpy(rng.integers(
        0, 1 << curve.log_limb_size, (n, 2 * L)).astype(np.int16)).cuda()
    pay = torch.from_numpy(np.stack(
        [(rng.permutation(n) << 1) | rng.integers(0, 2, n)
         for _ in range(Wg)]).astype(np.int32)).cuda()
    return table, pay


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_threads: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    Gs = kernels.SCAN_THREADS_PER_LANE
    rng = np.random.default_rng(13)
    for curve in (BN254_S12, BLS12_377_S12, BN254_S13, BLS12_377_S13):
        table, pay = inputs(rng, curve, 3, 37, 5)
        want = kernels.prefix_scan_plain(table, pay, curve, 37)
        for G in Gs:
            got = kernels.prefix_scan(table, pay, curve, 37,
                                      _threads_per_lane=G)
            if not torch.equal(got, want):
                raise AssertionError(f"{curve.name} G={G}: differs from "
                                     "the plain version")
        print(f"[scan-threads] {curve.name}: every G of {Gs} bit-identical "
              "to the plain version at (3, 37, 5)", flush=True)
        shapes = SHAPES if curve in (BN254_S12, BLS12_377_S12) else NARROW
        for Wg, C, R in shapes:
            table, pay = inputs(rng, curve, Wg, C, R)
            call = lambda G: kernels.prefix_scan(table, pay, curve, C,
                                                 _threads_per_lane=G)
            ref = call(Gs[0])
            if not all(torch.equal(call(G), ref) for G in Gs[1:]):
                raise AssertionError(f"{curve.name} {(Wg, C, R)}: the "
                                     "numbers of threads per lane disagree")
            t = {G: [] for G in Gs}
            for order in (Gs, Gs[::-1]):
                for G in order:
                    t[G].append(chip_smoke.cuda_ms(lambda: call(G), 5))
            call(None)
            picked = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
            print(f"[scan-threads] {curve.name} lanes={Wg * C} R={R}: "
                  + ", ".join(f"G={G} {min(v):.4f} ({v[0]:.4f} {v[1]:.4f})"
                              for G, v in t.items())
                  + f"; the launcher picks {picked} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
