#!/usr/bin/env python3
"""Time the PyTorch/CUDA port of several checkouts in turns on one card.

    git archive HEAD~1 | tar -x -C scratch_chip/parent    # a listed dir
    python3 scripts/torch_ab.py scratch_chip/parent . . scratch_chip/parent

Each checkout runs in a process of its own, in the order given (parent,
change, change, parent puts both on the card twice, so that a drift of
the host between the first and the last shows), and builds its kernels
into its own `build/`. Each prints `[ab]` lines, on BN254_S12 with the
default schedule:
  - the eight kernels on the word-wide multiply, and `decompose_digits`,
    at the shapes the 2^20 MSM gives them: `encode_mont`, `prefix_scan`,
    `col_prefix`,
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
  - where the checkout has it, `encode_rows` (stage 1's row table) on
    the inputs of its first call in the device program;
  - `apply_glv` on the inputs the 2^20 GLV device program gives it
    (where the checkout has it, stage 1 under GLV, `glv.glv_rows`: the
    rows form of the GLV kernel and its `decompose_digits`), and
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
  - one window_sums at 2^16 and 2^20, without GLV and with it, on the
    wire dtypes under torch.profiler (`device_work`): the device's
    kernels and copies a call, and the device time of the PyTorch ops
    among them;
  - the MSM end to end at 2^16 and 2^20, without GLV and with it, as
    `chip_smoke.py` times it, and the same for the XLA path
    (`backend="xla"`, the twin of `chip_smoke.py`'s `[twin]`) where the
    checkout's `chip_smoke.py` has it, and before it `smvp_stitch` on the
    first window group of the XLA path's 2^16 and 2^20 calls (captured by
    the checkout's `twin_user_call`) and at (Wg, n, C) = (3, 1001, 1001)
    with every key equal (every scan level adds), timed as the kernels
    above.
Then, once each checkout has run, the multiply's instructions by kind in
each checkout's own build (`cuobjdump -sass`, counted by this
checkout's `chip_smoke.py`): the `encode_mont` kernel, which inlines it,
and `msm::mul_wide` alone in prefix_scan's object, at L = 22; and every
form of the `decompose_digits` kernel.
It needs one card, and the checkouts' own `chip_smoke.py`.

    python3 scripts/torch_ab.py --small parent . . parent . parent parent .

runs only the 2^16 part, in turns as above (`small`), on BN254_S12:
  - each main-path wrapper's host cost a call: `HOST_REPS` calls enqueued
    behind a busy call (`chip_smoke.py` `busy`), so the card never holds
    the host back, on the inputs of its first call in the 2^16 device
    program, without GLV and with it;
  - the device program (`pipeline_cuda.windows_device`) on the wire
    dtypes, without GLV, with it, and as the last of the fewest window
    shards above one (w_shards = 5: 2^16 has 5 window groups): its host
    cost (the median time to return) and its
    time to a synchronize (median), `SMALL_REPS` calls each;
  - where the checkout's `chip_smoke.py` has the XLA path, the host cost
    of its `decompose_digits` and `smvp_stitch` calls as above (the first
    window group's, captured by its `twin_user_call`) and its MSM end to
    end, the median of `SMALL_REPS` runs;
  - the MSM end to end without GLV and with it, as `chip_smoke.py` times
    it, the median of `SMALL_REPS` runs, and again cut into its parts
    (`msm_parts`).

    python3 scripts/torch_ab.py --rows parent . . parent

runs only, in turns as above (`rows`): `smvp_rows` on the first window
group of the XLA path's BN254_S12 2^16 and 2^20 calls and its
BLS12_377_S12 2^14 call (captured by the checkout's `twin_user_call`);
at BN254_S12 and BLS12_377_S12, `batch_inverse` on K = 2^20 - 3 points'
Z plane, then the first one, two and three launches of its plan alone
(the differences are each launch's time), and on one element (the
root's chain); `to_affine` on the 2^16 window sums; all timed as the
kernels above; the XLA path end to end at BN254_S12 2^16 and 2^20, as
`chip_smoke.py` times it.
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


# Calls a median or a mean of the --small mode is taken over.
SMALL_REPS = 21
HOST_REPS = 50


def small(root: str) -> None:
    """The --small mode for one checkout (see the module docstring)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import statistics

    import numpy as np
    import torch

    import chip_smoke as cs
    from tpu_msm_torch.constants import BN254_S12 as C
    from tpu_msm_torch.cuzk import kernels, pipeline_cuda

    logn, n = 16, 1 << 16
    out = []
    for glv in (False, True):
        seen = cs.capture_inputs(C, logn, glv)
        for key, (name, args, kw, _) in seen.items():
            if name not in ("encode_rows", "decompose_digits", "prefix_scan",
                            "col_prefix", "bucket_sort", "extract_buckets",
                            "pbpr_full", "glv_rows", "glv_apply",
                            "encode_mont"):
                continue
            fn = getattr(kernels, name)
            call = lambda: fn(*args, **kw)
            call()
            torch.cuda.synchronize()
            cs.busy(C)
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                call()
            us = (time.perf_counter() - t0) * 1e6 / HOST_REPS
            torch.cuda.synchronize()
            out.append(f"host {'glv ' if glv else ''}{name} {us:.1f} us a "
                       f"call (mean of {HOST_REPS}, queued)")
        del seen
    xs, ys, hw, _, _ = cs.inputs(C, logn)
    wire = [torch.from_numpy(a).cuda() for a in (
        xs.astype(np.int16), ys.astype(np.int16),
        np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.uint16))]
    G = cs.config(C, logn, False).num_groups
    w = next(d for d in range(2, G + 1) if G % d == 0)
    for label, glv, shards in (("main", False, 1), ("glv", True, 1),
                               (f"shard {w}/{w}", False, w)):
        cfg = cs.config(C, logn, glv)
        call = lambda: pipeline_cuda.windows_device(
            *wire, cfg, w_shards=shards, w_index=shards - 1)
        ret, done = [], []
        for i in range(SMALL_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i:
                ret.append((t1 - t0) * 1e3)
                done.append((t2 - t0) * 1e3)
        out.append(f"windows_device 2^{logn} {label}: returns in "
                   f"{statistics.median(ret):.3f} ms, done in "
                   f"{statistics.median(done):.3f} ms (medians of "
                   f"{SMALL_REPS})")
    if hasattr(cs, "twin_config"):
        # the XLA path: its stitch's and digits' host cost, as above, on
        # the first window group, and its MSM end to end
        seen = cs.twin_user_call(C, logn, False, "", capture=True)["seen"]
        for key, (name, args, kw, _) in seen.items():
            if name not in ("decompose_digits", "smvp_stitch"):
                continue
            fn = getattr(kernels, name)
            call = lambda: fn(*args, **kw)
            call()
            torch.cuda.synchronize()
            cs.busy(C)
            t0 = time.perf_counter()
            for _ in range(HOST_REPS):
                call()
            us = (time.perf_counter() - t0) * 1e6 / HOST_REPS
            torch.cuda.synchronize()
            out.append(f"host twin {name} {us:.1f} us a call (mean of "
                       f"{HOST_REPS}, queued)")
        del seen
        ms, _ = cs.timed_runs(cs.twin_config(C, logn, False), logn, "twin",
                              "", runs=SMALL_REPS)
        out.append(f"twin 2^{logn} {ms:.3f} ms (median of {SMALL_REPS})")
    for glv in (False, True):
        label = "msm-glv" if glv else "msm"
        ms, _ = cs.timed_runs(cs.config(C, logn, glv), logn, label, "",
                              runs=SMALL_REPS)
        out.append(f"{label} 2^{logn} {ms:.3f} ms (median of {SMALL_REPS})")
        out.append(f"{label} 2^{logn} parts: " + msm_parts(
            cs, cs.config(C, logn, glv), logn, wire, C))
    for line in out:
        print(f"[ab-small] {root} {line}", flush=True)


def msm_parts(cs, cfg, logn: int, wire, curve) -> str:
    """The MSM of `chip_smoke.timed_runs` on the staged wire tensors, cut
    into its parts on the host clock: staging and the device program
    until it returns, until a synchronize, the decode of the window sums
    (their d2h included), Horner; medians of SMALL_REPS runs, each
    EXACT."""
    import statistics

    import torch
    pipe = cs.get_pipeline(cfg, "cuda")
    want = cs.inputs(curve, logn)[4]
    parts = {k: [] for k in ("returned", "done", "decode", "horner",
                             "total")}
    for i in range(SMALL_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = pipe._run(pipe._stage(wire))
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sums = pipe._decode_windows(g)
        t3 = time.perf_counter()
        acc = pipe.horner(sums)
        t4 = time.perf_counter()
        if not cs.ref.jac_eq(curve, acc, want):
            raise AssertionError("msm_parts: the MSM differs from the oracle")
        if i:
            for k, v in zip(parts, (t1 - t0, t2 - t0, t3 - t2, t4 - t3,
                                    t4 - t0)):
                parts[k].append(v * 1e3)
    return ", ".join(f"{k} {statistics.median(v):.3f}"
                     for k, v in parts.items()) + " ms (medians)"


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


def device_work(cs, C, logn: int, glv: bool) -> str:
    """Device activities (kernels, copies, fills) of one warm window_sums
    on the wire dtypes, and the device ms of the PyTorch ops among them,
    from torch.profiler."""
    import numpy as np
    import torch
    n = 1 << logn
    pipe = cs.get_pipeline(cs.config(C, logn, glv), "cuda")
    xs, ys, hw, _, _ = cs.inputs(C, logn)
    dev_in = [torch.from_numpy(a).cuda() for a in (
        xs.astype(np.int16), ys.astype(np.int16),
        np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.uint16))]
    pipe.window_sums(*dev_in)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pipe.window_sums(*dev_in)
        torch.cuda.synchronize()
    events, ops_ms = 0, 0.0
    for row in prof.key_averages():
        if row.device_type == torch.autograd.DeviceType.CPU:
            ops_ms += cs.device_us(row) / 1e3
        else:
            events += row.count
    return (f"window_sums 2^{logn}{' glv' if glv else ''}: {events} device "
            f"activities a call, PyTorch ops {ops_ms:.4f} ms of device time")


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
    for name in ("encode_mont", "encode_rows", "decompose_digits",
                 "prefix_scan", "col_prefix", "padd_batch", "pbpr_full",
                 "bucket_sort", "extract_buckets"):
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
    seen = cs.capture_inputs(C, 20, True)
    if "apply_glv" in seen:
        _, args, kw, _ = seen["apply_glv"]
        out.append(timed(f"apply_glv n=2^20 {tuple(args[0].shape)}",
                         lambda: glv_dev.apply_glv(*args, **kw)))
    else:
        _, args, _, _ = seen["glv_rows"]
        gcfg = cs.config(C, 20, True)
        out.append(timed(f"glv_rows + decompose_digits (stage 1 under GLV) "
                         f"n=2^20 {tuple(args[0].shape)}",
                         lambda: glv_dev.glv_rows(*args[:3], gcfg)))
    del seen, args
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
            out.append(device_work(cs, C, logn, glv))
    for glv in (False, True):
        for logn in (16, 20):
            label = "msm-glv" if glv else "msm"
            ms, _ = cs.timed_runs(cs.config(C, logn, glv), logn, label, "")
            out.append(f"{label} 2^{logn} {ms:.2f} ms")
    if hasattr(kernels, "smvp_stitch"):
        # the stitch at an edge shape where every level adds: C = 1001,
        # every key equal, made as chip_smoke.py stitch_edges makes it
        xs, ys, _, _, _ = cs.inputs(C, 16)
        n = 1001
        xm, ym = (kernels.encode_mont(torch.from_numpy(a[:, :n].astype(
            np.int32)).cuda(), C) for a in (xs, ys))
        rows_ = torch.cat([xm, ym]).to(torch.int16).T.contiguous()
        dg = torch.full((3, n), -9, dtype=torch.int32, device="cuda")
        pay, _ = kernels.bucket_sort(dg.to(torch.int16), 4096)
        skeys = torch.gather(dg.abs(), 1, (pay >> 1).long())
        bucket, trailing = kernels.smvp_rows(rows_, pay, skeys, C, n, 4096)
        out.append(timed("smvp_stitch (Wg, n, C) = (3, 1001, 1001) every "
                         "key equal", lambda: kernels.smvp_stitch(
                             bucket, trailing, skeys, C, n)))
        del bucket, trailing
        # the stitch on the XLA path's first window group, in place
        for logn in (16, 20):
            seen = cs.twin_user_call(C, logn, False, "", capture=True)[
                "seen"]
            _, args, kw, _ = next(v for v in seen.values()
                                  if v[0] == "smvp_stitch")
            out.append(timed(f"smvp_stitch twin 2^{logn} "
                             f"{tuple(args[0].shape)}",
                             lambda: kernels.smvp_stitch(*args, **kw)))
            del seen, args
    if hasattr(cs, "twin_config"):
        for logn in (16, 20):
            ms, _ = cs.timed_runs(cs.twin_config(C, logn, False), logn,
                                  "twin", "")
            out.append(f"twin 2^{logn} {ms:.2f} ms")
    for line in out:
        print(f"[ab] {root} {line}", flush=True)


def rows(root: str) -> None:
    """The --rows part: the XLA path's row walk and the product tree, and
    the XLA path end to end, as the checkout runs them."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import ctypes

    import torch

    import chip_smoke as cs
    import tpu_msm_torch
    from tpu_msm_torch import _build, to_affine
    from tpu_msm_torch.constants import BLS12_377_S12, BN254_S12
    from tpu_msm_torch.cuzk import kernels

    def timed(label, curve, fn) -> str:
        ms = cs.cuda_ms(fn, 5)
        line = f"{label} {ms:.4f} ms back to back"
        if ms < cs.QUEUE_BELOW_MS:
            q = cs.queued_ms(fn, cs.QUEUE_REPS, lambda: cs.busy(curve))
            line += f", {q:.4f} ms queued"
        return line

    out = []
    # the row walk on the XLA path's first window group, in place
    for curve, logn in ((BN254_S12, 16), (BN254_S12, 20),
                        (BLS12_377_S12, 14)):
        seen = cs.twin_user_call(curve, logn, False, "",
                                 capture=True)["seen"]
        _, args, kw, _ = next(v for v in seen.values()
                              if v[0] == "smvp_rows")
        out.append(timed(f"smvp_rows twin {curve.name} 2^{logn} "
                         f"{tuple(args[1].shape)} C={args[4]}", curve,
                         lambda: kernels.smvp_rows(*args, **kw)))
        del seen, args
    # the tree: batch_inverse on the Z plane of K points, its launches one
    # at a time, and on one element (the root's chain and little else)
    K = AFFINE_K
    for curve in (BN254_S12, BLS12_377_S12):
        name = curve.name
        pts = torch.from_numpy(affine_inputs(curve, K)).cuda()
        z = pts[2].contiguous()
        out.append(timed(f"batch_inverse {name} K={K}", curve,
                         lambda: tpu_msm_torch.batch_inverse(z, curve)))
        L, w = curve.num_limbs, curve.log_limb_size
        geo = kernels.batch_inverse_geometry(K)
        flat, res = z.reshape(L, -1).contiguous(), torch.empty_like(z)
        zero = torch.empty(K, dtype=torch.uint8, device="cuda")
        scratch = torch.empty((-(-L * w // 32), geo.scratch_nodes),
                              dtype=torch.int32, device="cuda")
        consts = kernels._affine_consts(curve)
        lib = _build.library()
        stream = torch.cuda.current_stream().cuda_stream
        for i, ln in enumerate(geo.launches):
            def launch(upto=i):
                for ln_ in geo.launches[:upto + 1]:
                    lib.msm_batch_inverse(
                        L, w, flat.data_ptr(), K, res.data_ptr(),
                        zero.data_ptr(), scratch.data_ptr(), geo.Kp, ln_.lo,
                        ln_.n, ln_.d, ln_.roles, ln_.blocks,
                        ctypes.addressof(consts), len(consts), stream)
            out.append(timed(f"batch_inverse {name} K={K} launches 1 to "
                             f"{i + 1} (roles {ln.roles})", curve, launch))
        one = z[:, :1].contiguous()
        out.append(timed(f"batch_inverse {name} K=1", curve,
                         lambda: tpu_msm_torch.batch_inverse(one, curve)))
        del pts, z, flat, res, scratch
        g = cs.capture_inputs(curve, 16, False)["pbpr_full"][3][0]
        out.append(timed(f"to_affine {name} n=2^16 window sums "
                         f"{tuple(g.shape)}", curve,
                         lambda: to_affine(g, curve)))
        del g
    for logn in (16, 20):
        ms, _ = cs.timed_runs(cs.twin_config(BN254_S12, logn, False), logn,
                              "twin", "")
        out.append(f"twin 2^{logn} {ms:.2f} ms")
    for line in out:
        print(f"[ab] {root} {line}", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] in ("--one", "--one-small",
                                             "--one-rows"):
        {"--one": one, "--one-small": small,
         "--one-rows": rows}[sys.argv[1]](sys.argv[2])
        return 0
    mode = "--one"
    if len(sys.argv) > 1 and sys.argv[1] in ("--small", "--rows"):
        mode = "--one-" + sys.argv[1][2:]
        del sys.argv[1]
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                        root], check=True)
    if mode != "--one":
        return 0
    # the multiply's instructions in each checkout's own build, counted by
    # this checkout's chip_smoke.py
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    for root in dict.fromkeys(sys.argv[1:]):
        build = Path(root).resolve() / "build" / "tpu_msm_torch"
        for what, counts in (("encode_mont kernel", cs.sass_counts(
                "encode_mont", build)), ("prefix_scan's msm::mul_wide",
                                         cs.callee_counts("prefix_scan",
                                                          build)),
                             ("decompose_digits kernel", cs.sass_counts(
                                 "decompose_digits", build))):
            for k, v in counts.items():
                if k.startswith(("encode<22,", "scan<22,", "digits<")):
                    print(f"[ab] {os.path.abspath(root)} sass {what} {k}: "
                          + ", ".join(f"{n} {c}" for n, c in v.items() if c),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
