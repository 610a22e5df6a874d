#!/usr/bin/env python3
"""Time the PyTorch/CUDA port of several checkouts in turns on one card.

    git archive HEAD~1 | tar -x -C scratch_chip/parent    # a listed dir
    python3 scripts/torch_ab.py scratch_chip/parent . . scratch_chip/parent

Each checkout runs in a process of its own, in the order given (parent,
change, change, parent puts both on the card twice, so that a drift of
the host between the first and the last shows), and builds its kernels
into its own `build/`. Each prints `[ab]` lines, on inputs made from a
fixed seed (lazy 12-bit limbs, the shapes of BN254_S12 at 2^16 and 2^20
under the default schedule):
  - `pbpr_stage1` at (Wp, B, T) = (16, 32768, 512) and (20, 4096, 256)
    and `globalize` at (R, F) = (128, 8192) and (32, 8192): CUDA events
    around 5 back-to-back calls;
  - `padd_batch` and `pdbl_batch` on 32,769 and on 16 lanes, queued
    behind a sleep on the card, so that the wrapper's host cost is left
    out;
  - what ptxas said of `pdbl_batch`'s kernels at L = 22 (registers,
    stack frame, spill stores and loads) in the checkout's own build;
  - `bucket_reduce` at the 2^20 shapes: the wall time (median of 5),
    and the device time of its stage 2 (1,022 dependent `padd_batch`
    launches on 16 lanes) enqueued behind a sleep;
  - the MSM end to end at 2^16 and 2^20, as `chip_smoke.py` times it.
It needs one card, and the checkouts' own `chip_smoke.py`.
"""

import os
import statistics
import subprocess
import sys


def one(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_msm_torch import _build
    from tpu_msm_torch.constants import BN254_S12 as C
    from tpu_msm_torch.cuzk import kernels, pbpr

    L = C.num_limbs
    rng = np.random.default_rng(3)
    lazy = lambda shape: torch.from_numpy(rng.integers(
        0, 1 << C.log_limb_size, (3, L) + shape).astype(np.int16)).cuda()

    def behind_sleep(fn) -> float:
        """Device ms of fn's launches, enqueued while the card sleeps."""
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e8))            # longer than the enqueue
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    out = []
    for Wp, B, T in ((16, 32768, 512), (20, 4096, 256)):
        b = lazy((Wp, B))
        ms = cs.cuda_ms(lambda: kernels.pbpr_stage1(b, C, T), 5)
        out.append(f"pbpr_stage1 {(Wp, B, T)} {ms:.4f} ms")
    for R, F in ((128, 8192), (32, 8192)):
        t, s = lazy((R, F)), lazy((F,))
        ms = cs.cuda_ms(lambda: kernels.globalize(t, s, C), 5)
        out.append(f"globalize {(R, F)} {ms:.4f} ms")
    for F in (32769, 16):
        p, q = lazy((F,)), lazy((F,))
        reps = lambda: [kernels.padd_batch(p, q, C) for _ in range(50)]
        out.append(f"padd_batch F={F} {behind_sleep(reps) / 50:.4f} ms "
                   "a launch, queued")
    for F in (32769, 16):
        p = lazy((F,)).int()
        reps = lambda: [kernels.pdbl_batch(p, C) for _ in range(50)]
        out.append(f"pdbl_batch F={F} {behind_sleep(reps) / 50:.4f} ms "
                   "a launch, queued")
    for fn, regs, stack, st, ld in _build.resources("pdbl_batch"):
        if f"Li{L}E" in fn:
            out.append(f"ptxas pdbl_batch {fn}: {regs} registers, {stack} B "
                       f"stack frame, {st} B spill stores, {ld} B spill "
                       "loads")
    cfg = cs.config(20, False)
    b = lazy((cfg.num_windows, cfg.half_columns))
    pbpr.bucket_reduce(b, cfg)
    ts = [cs.timed_once(lambda: pbpr.bucket_reduce(b, cfg))[1]
          for _ in range(5)]
    T = cfg.pbpr_threads
    mt = lazy((cfg.num_windows, T)).int().permute(3, 0, 1, 2).contiguous()

    inf = kernels.inf_stacked(C, (cfg.num_windows,), "cuda")

    def stage2():          # no host-to-device copy: it would wait
        macc = msum = inf
        for k in range(T - 1, 0, -1):
            macc = kernels.padd_batch(macc, mt[k], C)
            msum = kernels.padd_batch(msum, macc, C)

    out.append(f"bucket_reduce {tuple(b.shape)} T={T} wall median "
               f"{statistics.median(ts):.2f} ms of "
               f"{[round(t, 2) for t in ts]}; its stage 2 "
               f"({2 * (T - 1)} launches) {behind_sleep(stage2):.2f} ms on "
               "the device")
    for logn in (16, 20):
        ms, _ = cs.timed_runs(cs.config(logn, False), logn, "msm", "")
        out.append(f"msm 2^{logn} {ms:.2f} ms")
    for line in out:
        print(f"[ab] {root} {line}", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
