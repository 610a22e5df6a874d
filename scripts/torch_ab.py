#!/usr/bin/env python3
"""Time the PyTorch/CUDA port of several checkouts in turns on one card.

    git archive HEAD~1 | tar -x -C scratch_chip/parent    # a listed dir
    python3 scripts/torch_ab.py scratch_chip/parent . . scratch_chip/parent

Each checkout runs in a process of its own, in the order given (parent,
change, change, parent puts both on the card twice, so that a drift of
the host between the first and the last shows), and builds its kernels
into its own `build/`. Each prints `[ab]` lines, on BN254_S12 with the
default schedule:
  - the eight kernels on the word-wide multiply at the shapes the 2^20
    MSM gives them: `encode_mont`, `prefix_scan`, `col_prefix`,
    `padd_batch` and `pbpr_full` on the inputs of their first call in
    the device program (captured by the checkout's `chip_smoke.py`;
    `padd_batch` where the checkout's capture runs it: on the main path
    until PR 14, on the stage-3 chain replayed after it since PR 15),
    and where the checkout has them, `bucket_sort` and
    `extract_buckets` the same way,
    `pbpr_stage1` on the buckets `pbpr_full` received, `pdbl_batch` on
    (3, L, 32,769) and `globalize` at (R, F) = (128, 8192) on lazy limbs
    from a fixed seed; CUDA events around back-to-back calls, and a
    kernel under 1 ms again queued behind a busy call (`chip_smoke.py`
    `queued_ms`), which leaves out the wrapper's host cost;
  - `apply_glv` on the inputs the 2^20 GLV device program gives it, and
    `to_affine` on the window sums of the 2^16 MSM (the median of 5 warm
    calls on the host clock between synchronizes, and of the time each
    call takes to return, its host cost; and timed as the kernels
    above);
  - `to_affine` on K = 2^20 - 3 projective points and
    `tpu_msm_torch.batch_inverse` on their Z plane, lazy limbs below p
    from a fixed seed, as the checkout runs them: timed like the kernels
    above where the checkout has a kernel, else (its `batch_inverse` the
    plain torch version on the card) one warm call on the host clock;
  - what ptxas said of every kernel at L = 22 and of any kernel with a
    stack frame or spills;
  - the MSM end to end at 2^16 and 2^20, without GLV and with it, as
    `chip_smoke.py` times it, and the same for the XLA path
    (`backend="xla"`, the twin of `chip_smoke.py`'s `[twin]`) where the
    checkout's `chip_smoke.py` has it.
Then, once each checkout has run, the multiply's instructions by kind in
each checkout's own build (`cuobjdump -sass`, counted by this
checkout's `chip_smoke.py`): the `encode_mont` kernel, which inlines it,
and `msm::mul_wide` alone in prefix_scan's object, at L = 22.
It needs one card, and the checkouts' own `chip_smoke.py`.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# to_affine and batch_inverse at full width: K points (not a power of two)
AFFINE_K = (1 << 20) - 3


def host_ms(fn, runs: int, wait: bool = True) -> float:
    """Median host-clock ms of `runs` calls of fn, each after a
    synchronize and, with `wait`, up to the next one (without it, up to
    fn's return: the call's host cost), after one warm-up call."""
    import statistics
    import torch
    times = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if wait:
            torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def affine_inputs(curve, K: int):
    """(3, L, K) int32 lazy limbs of projective points from a fixed seed:
    each coordinate below p, a unit of the next limb borrowed into a
    random half of the limbs below the top."""
    import numpy as np
    L, w = curve.num_limbs, curve.log_limb_size
    rng = np.random.default_rng(7)
    t = rng.integers(0, 1 << w, (3, L, K)).astype(np.int32)
    t[:, -1] = rng.integers(0, curve.p >> (w * (L - 1)), (3, K))
    move = (rng.random((3, L - 1, K)) < 0.5).astype(np.int32)
    t[:, :-1] += move << w
    t[:, 1:] -= move
    return t


def one(root: str) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import tpu_msm_torch
    from tpu_msm_torch import _build, to_affine
    from tpu_msm_torch.constants import BN254_S12 as C
    from tpu_msm_torch.cuzk import glv as glv_dev
    from tpu_msm_torch.cuzk import kernels

    L = C.num_limbs
    rng = np.random.default_rng(3)
    lazy = lambda shape: torch.from_numpy(rng.integers(
        0, 1 << C.log_limb_size, (3, L) + shape).astype(np.int16)).cuda()

    def timed(label, fn) -> str:
        ms = cs.cuda_ms(fn, 5)
        line = f"{label} {ms:.4f} ms back to back"
        if ms < cs.QUEUE_BELOW_MS:
            q = cs.queued_ms(fn, cs.QUEUE_REPS, lambda: cs.busy(C))
            line += f", {q:.4f} ms queued"
        return line

    out = []
    seen = cs.capture_inputs(C, 20, False)
    calls = {}
    for key, (name, args, kw, _) in seen.items():
        calls.setdefault(name, (key, args, kw))
    for name in ("encode_mont", "prefix_scan", "col_prefix", "padd_batch",
                 "pbpr_full", "bucket_sort", "extract_buckets"):
        if name not in calls:
            continue
        key, args, kw = calls[name]
        fn = getattr(kernels, name)
        shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        out.append(timed(f"{key} {shape}", lambda: fn(*args, **kw)))
    _, (buckets, _, T), _ = calls["pbpr_full"]
    out.append(timed(f"pbpr_stage1 {tuple(buckets.shape)} T={T}",
                     lambda: kernels.pbpr_stage1(buckets, C, T)))
    p = lazy((32769,)).int()
    out.append(timed("pdbl_batch (3, 22, 32769)",
                     lambda: kernels.pdbl_batch(p, C)))
    t, s = lazy((128, 8192)), lazy((8192,))
    out.append(timed("globalize (128, 8192)",
                     lambda: kernels.globalize(t, s, C)))
    del seen, calls, buckets, p, t, s
    _, args, kw, _ = cs.capture_inputs(C, 20, True)["apply_glv"]
    out.append(timed(f"apply_glv n=2^20 {tuple(args[0].shape)}",
                     lambda: glv_dev.apply_glv(*args, **kw)))
    del args, kw
    g = cs.capture_inputs(C, 16, False)["pbpr_full"][3][0]
    out.append(f"to_affine n=2^16 window sums {tuple(g.shape)} "
               f"{host_ms(lambda: to_affine(g, C), 5):.4f} ms (median of 5 "
               "warm calls, host clock), of which the call's host cost "
               f"{host_ms(lambda: to_affine(g, C), 5, wait=False):.4f} ms")
    out.append(timed(f"to_affine n=2^16 window sums {tuple(g.shape)}",
                     lambda: to_affine(g, C)))
    del g
    K = AFFINE_K
    pts = torch.from_numpy(affine_inputs(C, K)).cuda()
    z = pts[2].contiguous()
    out.append(timed(f"to_affine K={K}", lambda: to_affine(pts, C)))
    if hasattr(kernels, "batch_inverse"):
        out.append(timed(f"batch_inverse K={K}",
                         lambda: tpu_msm_torch.batch_inverse(z, C)))
    else:
        ms = host_ms(lambda: tpu_msm_torch.batch_inverse(z, C), 1)
        out.append(f"batch_inverse K={K} {ms:.1f} ms (no kernel: the plain "
                   "version, one warm call, host clock)")
    del pts, z
    for stem in ("encode_mont", "prefix_scan", "col_prefix", "padd_batch",
                 "pdbl_batch", "pbpr_stage1", "globalize", "pbpr_full",
                 "bucket_sort", "extract_buckets"):
        if not (_build.CSRC / f"{stem}.cu").exists():
            continue
        for fn, regs, stack, st, ld in _build.resources(stem):
            if "Li22ELi12E" in fn or stack or st or ld:
                out.append(f"ptxas {stem} {fn}: {regs} registers, {stack} B "
                           f"stack frame, {st} B spill stores, {ld} B spill "
                           "loads")
    for glv in (False, True):
        for logn in (16, 20):
            label = "msm-glv" if glv else "msm"
            ms, _ = cs.timed_runs(cs.config(C, logn, glv), logn, label, "")
            out.append(f"{label} 2^{logn} {ms:.2f} ms")
    if hasattr(cs, "twin_config"):
        for logn in (16, 20):
            ms, _ = cs.timed_runs(cs.twin_config(C, logn, False), logn,
                                  "twin", "")
            out.append(f"twin 2^{logn} {ms:.2f} ms")
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
    # the multiply's instructions in each checkout's own build, counted by
    # this checkout's chip_smoke.py
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    for root in dict.fromkeys(sys.argv[1:]):
        build = Path(root).resolve() / "build" / "tpu_msm_torch"
        for what, counts in (("encode_mont kernel", cs.sass_counts(
                "encode_mont", build)), ("prefix_scan's msm::mul_wide",
                                         cs.callee_counts("prefix_scan",
                                                          build))):
            for k, v in counts.items():
                if k.startswith(("encode<22,", "scan<22,")):
                    print(f"[ab] {os.path.abspath(root)} sass {what} {k}: "
                          + ", ".join(f"{n} {c}" for n, c in v.items() if c),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
