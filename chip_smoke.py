#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card's name and power limit; require CUDA;
  2. build the kernels of tpu_msm_torch/csrc (timed as set-up); print
     what ptxas said of the redesigned kernels at BN254_S12 and at every
     profile of PROFILES (`[ptxas]`: registers, stack frame, spills)
     and, for the five on the word-wide multiply, their instructions by
     kind from cuobjdump -sass (`[sass]`);
  3. per kernel, at the shapes its path gives it for BN254_S12 at 2^16
     and 2^20 (captured from a warm-up run of the device program, without
     GLV and with it): the CUDA kernel against its plain PyTorch version
     on the same CUDA inputs, bit-identical, with times from CUDA events
     (a kernel under QUEUE_BELOW_MS back to back is timed again queued
     behind a busy call, which leaves out its wrapper's host cost; both
     times are printed; the five kernels on the word-wide multiply,
     `encode_mont`, `padd_batch`, `pdbl_batch`, `pbpr_stage1` and
     `globalize`, also print their bound by the 12-bit multiply's count,
     mont_mul_ops, beside their own).
     The six kernels of the main path at both configurations, and
     `psub_batch` (the padd kernel negating q on load) against its own
     plain version, `padd_batch` of `pneg_stacked`;
     `pbpr_stage1` on the buckets `pbpr_full` received; `pdbl_batch` on
     one (3, L, Wg, B+1) batch and on the (3, L, Wp) sum that
     `bucket_reduce` doubles; `globalize` on the first window group's
     scan output and column prefix; `prefix_scan` once more for every
     number of threads per lane its launcher can pick, bit-identical to
     the first and timed (`[scan-G]`); and, at 2^16, both redesigned
     kernels at shapes the two sizes do not reach (`[edge]`): `col_prefix`
     at (Wg, C) = (1, 1), (3, 32), (4, 2048) with half the columns at
     infinity, equal neighbours and a column followed by its negative,
     and (16, 8192), more columns than resident threads; `prefix_scan` at
     R = 1 and at 111 lanes with a point twice in a row and a point
     followed by its negative, for every number of threads per lane;
     `padd_batch` and `psub_batch` at F = 1, 37 and 333 with infinity on
     either side, P + P, P + (-P) and int16 limbs at the ends of the
     ledger, and `encode_mont` on 0, 1 and p - 1; `pbpr_stage1` at
     (Wp, B, T) = STAGE1_EDGES (T = 1 with an odd lane count, T = B, a
     slice of 3 buckets) with infinity and P + P in the chains, int16 and
     int32 buckets; `globalize` at (R, F) = GLOBALIZE_EDGES (F = 1, R = 1,
     F no multiple of a block's lanes) with S = T (P + P), S = -T
     (P + (-P)) and S at infinity, every dtype pair; `pdbl_batch` at
     F = 1, 7, 8, 9 (about the 8 lanes of a warp) and 16, on all-infinity
     lanes and on limbs at the ends of the ledger;
     at 2^20, `pbpr_full` at PBPR_EDGES (T = 1, T = B, T = 1024 and 2048,
     one window, B = 2^15 with T = 32), with the geometry it launched
     (the narrow ones are held against plain versions run on the CPU
     after every timed phase, so that they share the host with no timing);
  4. the two-stage reduction path: `pbpr.bucket_reduce` on the same
     buckets, equal in the group to `pbpr_full` window by window, its
     launch counts reset before and read after;
  5. the globalisation check: `globalize(T, S)` at the bucket-region ends
     of the first window group, bit-identical to the main path's G;
  6. the main path, `tpu_variable_base_msm` on the card, at 2^16 and 2^20
     with inputs from gen_planar_inputs(seed=99, k_base=64): EXACT against
     the O(k_base) linearity oracle, every kernel's launch count reset
     before and read after; then the median of 3 timed runs of
     window_sums + host Horner on staged inputs, h2d timed apart;
  7. the GLV path: the same call with the default schedule and glv=True,
     on the same inputs, EXACT against the same oracle, counted and timed
     the same way, and `apply_glv` timed alone; then (`[schedule]`) the
     largest size once more under SCHEDULE, a window group of 16 that
     gives the scan 131,072 lanes and `col_prefix` several columns a
     thread, EXACT, recorded and not made the default; and (`[latency]`)
     one `padd_batch` on 32 lanes, one `pdbl_batch` on 16 lanes, and one
     `col_prefix` level, one scan step, one `pbpr_full` stage-1 step, one
     `pbpr_stage1` step and one doubling on a single warp, from which the
     depth floors of `col_prefix`, `prefix_scan`, `pbpr_full`,
     `pbpr_stage1` and `pdbl_batch` on 16 lanes follow;
     and (`[scan-lanes]`) `prefix_scan` alone at 2,048 to 131,072 lanes,
     with four lane counts about the two edges of the launcher's rule,
     for every number of threads per lane;
  8. affine output: `to_affine` on the window sums of the 2^16 runs
     (without GLV, and with it, where two pad windows are at infinity)
     against the host decode; then (`[rest]`) one real window_sums +
     host Horner at 2^16 and 2^20 under torch.profiler: the device time
     of the PyTorch ops outside the port's kernels, op by op, beside the
     kernels' own, and the d2h, decode and Horner on the host clock;
  9. every profile of PROFILES (`run_profile`: BLS12_377_S12 at 2^16
     and 2^20, BN254_S13 and BLS12_377_S13 at 2^16, each with its own
     inputs from gen_planar_inputs(seed=99, k_base=64)): at each size
     the nine kernels against their plain versions on the shapes its run
     gives them, timed against their bounds, the scan for both numbers
     of threads per lane, the reduction and globalisation checks; the
     MSM EXACT at each size, counted and timed; for BLS12_377_S12 also
     the GLV MSM, to_affine and the [latency] line; a [where] line for
     each size;
 10. `[sharded]`, the multi-device MSM (`tpu_msm_torch/parallel/sharded.py`)
     on BN254_S12 at 2^20, the same inputs, EXACT against the same
     oracle: (1) `windows_device` at w = 2 and 4 window shards, every
     w_index, in one process: the shards concatenated decode to the
     unsharded window sums; `pbpr_full` launched at Wp_l = 8 and 4 as
     `pbpr_full_geometry` says; on the first shard at w = 4, `pbpr_full`
     and the first group's `prefix_scan`, `col_prefix`, `padd_batch` and
     `psub_batch` against their plain versions, timed; each shard timed;
     before the spawns, the kernels of the gloo ranks' paths, each call
     of rank 0's span (n / x points, the 2^20 schedule) at its first
     window shard against its plain version; `_reduce_gathered` on the
     window sums of two and of four spans, bit-identical to the tree of
     plain adds, each level's `padd_batch` against its plain version;
     (2) `sharded_msm` on a mesh (1,) of one NCCL rank, counted, then
     `sharded.exchange` timed on its own; (3) meshes x = 2 and
     (x = 2, w = 2) of 2 and 4 ranks spawned on this one card over gloo
     (`parallel.spawn.run_ranks`), the inputs handed over in .npy
     files: every rank EXACT and counted, its window_sums and, on its
     own after a barrier, its exchange + tree timed (ranks sharing one
     card: no multi-GPU scaling); a rank that fails or misses its
     deadline fails the run;
 11. the `pbpr_full` edges whose plain versions ran on the CPU;
 12. `[where]` and `[rest]` lines, then one JSON line {"kernels": [...]}
    with all nine kernels (pbpr_full with the geometry the user call
    launched, from kernels.LAUNCHED; under "profiles" each kernel's
    time, bound, launches and error at each profile of PROFILES; the six
    of the main path with their launches on the sharded path and their
    largest error against the plain version there, padd_batch also its
    halving tree's launches) and the `[sharded]` numbers under
    "sharded";
 13. last line {"ok": true, "device": {...}}.
"""

import concurrent.futures
import contextlib
import dataclasses
import datetime
import json
import math
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpu_msm_torch import _build, to_affine  # noqa: E402
from tpu_msm_torch.config import MSMConfig, default_config  # noqa: E402
from tpu_msm_torch.constants import (BLS12_377_S12,  # noqa: E402
                                     BLS12_377_S13, BN254_S12, BN254_S13,
                                     int_to_limbs)
from tpu_msm_torch.cuzk import glv as glv_dev  # noqa: E402
from tpu_msm_torch.cuzk import kernels  # noqa: E402
from tpu_msm_torch.cuzk import pbpr  # noqa: E402
from tpu_msm_torch.cuzk import pipeline_cuda  # noqa: E402
from tpu_msm_torch.cuzk.pipeline import (get_pipeline,  # noqa: E402
                                         tpu_variable_base_msm)
from tpu_msm_torch.parallel import sharded, spawn  # noqa: E402
from tpu_msm_torch.reference import curve as ref  # noqa: E402
from tpu_msm_torch.utils import preprocess  # noqa: E402

CURVE = BN254_S12   # the profile of phases 3 to 8
SIZES = (16, 20)
# The profiles beyond BN254_S12 that the script drives through the main
# path (`run_profile`), each at its sizes: at every size each kernel is
# held against its plain version and timed, and the reduction and
# globalisation paths run. PROFILE_FULL also runs GLV and to_affine.
PROFILES = ((BLS12_377_S12, (16, 20)), (BN254_S13, (16,)),
            (BLS12_377_S13, (16,)))
PROFILE_FULL = BLS12_377_S12
DEVICE = "cuda"   # a rehearsal without a card sets "cpu" and tiny SIZES
MAIN = ("encode_mont", "decompose_digits", "prefix_scan", "col_prefix",
        "padd_batch", "pbpr_full")
KERNELS = MAIN + ("pdbl_batch", "pbpr_stage1", "globalize")
# (Wg, C, R) of the scan's lane sweep. On 132 SMs the launcher's rule
# changes at 5,280 and 8,448 lanes: two lane counts about each edge and
# two between them.
LANE_SHAPES = ((1, 2048, 128), (1, 4096, 128), (1, 5120, 128),
               (1, 5632, 128), (1, 6656, 128), (1, 7424, 128),
               (1, 8192, 128), (1, 8448, 128), (1, 8704, 128),
               (2, 8192, 64), (16, 8192, 16))
# A schedule for the largest size that the card's memory allows and the
# default schedule does not use: all 16 windows in one group.
SCHEDULE = dict(window_size=16, columns=8192, pbpr_threads=512,
                subtask_group=16, max_points_per_pass=1 << 22)
# name: (source, the TPU kernel it replaces, the path that launches it)
SOURCES = {
    "encode_mont": ("tpu_msm_torch/csrc/encode_mont.cu",
                    "tpu_msm/cuzk/kernels.py:94", "main, glv"),
    "decompose_digits": ("tpu_msm_torch/csrc/decompose_digits.cu",
                         "tpu_msm/cuzk/kernels.py:439", "main, glv"),
    "prefix_scan": ("tpu_msm_torch/csrc/prefix_scan.cu",
                    "tpu_msm/cuzk/kernels.py:131", "main, glv"),
    "col_prefix": ("tpu_msm_torch/csrc/col_prefix.cu",
                   "tpu_msm/cuzk/kernels.py:538", "main, glv"),
    "padd_batch": ("tpu_msm_torch/csrc/padd_batch.cu",
                   "tpu_msm/cuzk/kernels.py:309", "main, glv, reduce"),
    "pbpr_full": ("tpu_msm_torch/csrc/pbpr_full.cu",
                  "tpu_msm/cuzk/kernels.py:656", "main, glv"),
    "pdbl_batch": ("tpu_msm_torch/csrc/pdbl_batch.cu",
                   "tpu_msm/cuzk/kernels.py:386", "reduce"),
    "pbpr_stage1": ("tpu_msm_torch/csrc/pbpr_stage1.cu",
                    "tpu_msm/cuzk/kernels.py:615", "reduce"),
    "globalize": ("tpu_msm_torch/csrc/globalize.cu",
                  "tpu_msm/cuzk/kernels.py:261", "globalise"),
}

# Bound model (H100 SXM, published peaks at 700 W): HBM at 3.35 TB/s;
# int32 multiply-add at 64 INT32 lanes x 132 SMs x 1.98 GHz = 16.7 T/s,
# counted as 2 operations each = 33.5 T int32 op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# Montgomery multiplies per point formula (ops/rows.py).
MULS = {"padd": 12, "pmadd": 12, "pdbl": 9}


def mont_mul_ops(L: int) -> int:
    """int32 operations of one Montgomery multiply: L iterations of L
    a*b multiply-adds, L+1 m*p multiply-adds and one m digit, 2 op each."""
    return 2 * L * (2 * L + 2)


def mul_wide_mads(L: int, w: int) -> int:
    """int32 multiply and multiply-add instructions of one word-wide
    Montgomery multiply (csrc/mul_wide.cuh), each .lo and .hi half
    counted: N = ceil(L w / 32) words, NF = NP = floor(L w / 32); N^2
    word products for a b, then NF whole-word reductions and, where L w
    is no multiple of 32, one of the last bits, each an m digit (one .lo)
    and NP word products of m p. 315 at L = 22 (1,012 multiply-adds in
    Field::mul), 588 at BLS12_377_S12 (2,112)."""
    n, nf = -(-L * w // 32), L * w // 32
    steps = nf + (1 if L * w % 32 else 0)
    return 2 * n * n + steps * (1 + 2 * nf)


# The kernels whose Montgomery multiply is the word-wide one: their
# operations bound counts mul_wide_mads, and mont_mul_ops beside it.
WIDE = ("encode_mont", "padd_batch", "pdbl_batch", "pbpr_stage1",
        "globalize")


def bound_ms(nbytes: int, ops: int):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / INT32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def work(curve, name: str, args, out, wide: bool = True) -> tuple:
    """(bytes moved, int32 operations) of one call: each input read once,
    each output written once; operations from the shapes. A kernel of
    WIDE counts its own multiply's mul_wide_mads (2 operations each, as
    a multiply-add counts); with wide=False, the 12-bit multiply's
    mont_mul_ops."""
    L = curve.num_limbs
    mm = mont_mul_ops(L)
    if wide and name in WIDE:
        mm = 2 * mul_wide_mads(L, curve.log_limb_size)
    nbytes = sum(a.numel() * a.element_size() for a in args + as_tuple(out)
                 if isinstance(a, torch.Tensor))
    if name == "encode_mont":
        ops = args[0].shape[1] * mm
    elif name == "decompose_digits":
        ops = out.numel() * 8          # shifts, masks, compare, select
    elif name == "prefix_scan":
        ops = args[1].numel() * MULS["pmadd"] * mm
    elif name == "col_prefix":
        _, _, Wg, C = args[0].shape
        ops = Wg * C * max(C.bit_length() - 1, 1) * MULS["padd"] * mm
    elif name == "padd_batch":
        ops = args[0][0, 0].numel() * MULS["padd"] * mm
    elif name == "pbpr_full":
        # the adds whose sums the output reads: 2 B in stage 1,
        # T log2 T + 3 (T - 1) in the scans (kernels.pbpr_scan_levels),
        # one in the tail, and log2(B / T) doublings, each window
        _, _, Wp, B = args[0].shape
        T = min(args[2], B)
        scan = sum(T // sm + T // sg for _, sm, sg in
                   kernels.pbpr_scan_levels(T))
        dbl = max((B // T).bit_length() - 1, 0)
        ops = Wp * ((2 * B + scan + 1) * MULS["padd"]
                    + dbl * MULS["pdbl"]) * mm
    elif name == "pdbl_batch":
        ops = args[0][0, 0].numel() * MULS["pdbl"] * mm
    elif name == "pbpr_stage1":
        _, _, Wp, B = args[0].shape
        ops = Wp * B * 2 * MULS["padd"] * mm
    elif name == "globalize":
        _, _, R, F = args[0].shape
        ops = R * F * MULS["padd"] * mm
    else:
        raise KeyError(name)
    return nbytes, ops


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def queued_ms(fn, reps: int, blocker) -> float:
    """Mean device time of fn over reps launches that wait in the queue
    behind `blocker`, a call that keeps the card busy for longer than the
    host needs to enqueue them: for a kernel shorter than its launch."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    blocker()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


_BUSY = {}


def busy(curve) -> None:
    """Some 18 ms (BN254_S12) of one warp on the card (a scan lane of
    2,048 steps): the call that keeps the card busy while the launches of
    a `queued_ms` measurement are enqueued behind it, made once a
    profile."""
    if curve.name not in _BUSY:
        L, R = curve.num_limbs, 2048
        rng = np.random.default_rng(11)
        table = torch.from_numpy(rng.integers(
            0, 1 << curve.log_limb_size, (32 * R, 2 * L)).astype(np.int16)
            ).to(DEVICE)
        pay = torch.from_numpy((rng.permutation(32 * R) << 1).astype(
            np.int32)).to(DEVICE)[None]
        _BUSY[curve.name] = lambda: kernels.prefix_scan(
            table, pay, curve, 32, _threads_per_lane=2)
    _BUSY[curve.name]()


# A kernel faster than this (CUDA events around back-to-back calls) is
# timed again with queued_ms: its wrapper's host cost, not the kernel,
# sets the pace of back-to-back calls.
QUEUE_BELOW_MS = 1.0
QUEUE_REPS = 50
# A plain version whose first call takes longer is timed by that call.
PLAIN_COLD_MS = 1000.0


def timed_once(fn):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


@contextlib.contextmanager
def spy(seen: dict, targets):
    """While active, keep (name, args, kwargs, output) of the first call of
    every (module, name) in `targets`, tensors cloned; padd_batch and
    psub_batch are kept once per dtype form."""
    orig = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def call(*args, **kw):
            key = name
            if name in ("padd_batch", "psub_batch"):
                od = kw.get("out_dtype", args[3] if len(args) > 3 else
                            torch.int32)
                key = f"{name}[{args[0].dtype}->{od}]"
            out = fn(*args, **kw)
            if key not in seen:
                keep = lambda a: a.clone() if isinstance(a, torch.Tensor) \
                    else a
                seen[key] = (name, tuple(map(keep, args)), dict(kw),
                             tuple(map(keep, as_tuple(out))))
            return out
        return call

    for mod, name, fn in orig:
        setattr(mod, name, wrap(name, fn))
    try:
        yield seen
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


_INPUTS = {}


def inputs(curve, logn: int):
    """(xs, ys, hw, base, oracle result) of one size of a profile, made
    once."""
    key = (curve.name, logn)
    if key not in _INPUTS:
        xs, ys, hw, base = preprocess.gen_planar_inputs(
            curve, 1 << logn, seed=99, k_base=64)
        _INPUTS[key] = (xs, ys, hw, base,
                        preprocess.expected_msm(base, hw, curve))
    return _INPUTS[key]


def config(curve, logn: int, glv: bool):
    return dataclasses.replace(default_config(1 << logn, curve), glv=glv)


def capture_inputs(curve, logn: int, glv: bool) -> dict:
    """Run the device program once and keep the first call of every
    kernel wrapper of the main path, of `boundary_positions` and, under
    GLV, of `apply_glv`."""
    n = 1 << logn
    xs, ys, hw, _, _ = inputs(curve, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    dev = torch.device(DEVICE)
    targets = [(kernels, k) for k in MAIN + ("psub_batch",)]
    targets += [(pipeline_cuda, "boundary_positions"), (glv_dev, "apply_glv")]
    with spy({}, targets) as seen:
        pipeline_cuda.windows_device(
            torch.from_numpy(xs.astype(np.int32)).to(dev),
            torch.from_numpy(ys.astype(np.int32)).to(dev),
            torch.from_numpy(hw.astype(np.int32)).to(dev),
            config(curve, logn, glv))
        torch.cuda.synchronize()
    return seen


# A wrapper that launches another wrapper's kernel.
KERNEL_OF = {"psub_batch": "padd_batch"}


def compare(curve, key: str, fn: str, args, kw, tag: str, card: str,
            reps: int) -> dict:
    """One kernel, through wrapper `fn`, against the wrapper's plain
    version on the same CUDA inputs, then timed."""
    name = KERNEL_OF.get(fn, fn)
    kern = getattr(kernels, fn)
    plain = getattr(kernels, fn + "_plain")
    got = kern(*args, **kw)
    want, plain_ms = timed_once(lambda: plain(*args, **kw))
    if plain_ms < PLAIN_COLD_MS:
        # fast enough that filling the cached constants on a first call
        # would show: time a second, warm call
        want, plain_ms = timed_once(lambda: plain(*args, **kw))
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(as_tuple(got), as_tuple(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{key}: shape/dtype {g.shape} {g.dtype} "
                                 f"vs plain {w.shape} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)
                            ).abs().max()))
    if err:
        raise AssertionError(f"{key} at {tag}: kernel differs from its "
                             f"plain version (max abs err {err})")
    call = lambda: kern(*args, **kw)
    t_cuda = cuda_ms(call, reps)
    queued = t_cuda < QUEUE_BELOW_MS
    t = (queued_ms(call, QUEUE_REPS, lambda: busy(curve)) if queued
         else t_cuda)
    nbytes, ops = work(curve, name, args, got)
    b_ms, b_by = bound_ms(nbytes, ops)
    extra, note = {}, ""
    if name in WIDE:
        b_old, by_old = bound_ms(nbytes, work(curve, name, args, got,
                                            False)[1])
        extra = dict(bound_ms_mont_mul_ops=b_old, bound_by_mont_mul_ops=by_old)
        note = f" bound_ms by mont_mul_ops={b_old:.4f} ({by_old})"
    if name in ("padd_batch", "pdbl_batch", "pbpr_stage1", "globalize"):
        extra["launched"] = dict(kernels.LAUNCHED[name])
        note += f" launched={extra['launched']}"
    shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    how = "queued behind a busy call" if queued else "back to back"
    print(f"[kernel] {curve.name} {key} {tag} in={shape} "
          f"out={[tuple(o.shape) for o in as_tuple(got)]} "
          f"ms={t:.4f} ({how}) cuda_ms={t_cuda:.4f} (back to back, the "
          f"wrapper's host cost included) plain_ms={plain_ms:.1f} "
          f"bound_ms={b_ms:.4f} ({b_by}){note} x{t / b_ms:.2f} bound; "
          f"bit-identical max_abs_err={err} [{card}]", flush=True)
    return dict(name=name, ms=t, ms_cuda=t_cuda, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, **extra)


def check_main_kernels(curve, seen: dict, tag: str, card: str,
                       reps: int) -> dict:
    """Phase 3 for the six kernels of the main path."""
    results = {key: compare(curve, key, name, args, kw, tag, card, reps)
               for key, (name, args, kw, _) in seen.items()
               if KERNEL_OF.get(name, name) in MAIN}
    missing = set(MAIN) - {r["name"] for r in results.values()}
    if missing:
        raise AssertionError(f"kernels never called at {tag}: {missing}")
    return results


def scan_sweep(curve, seen: dict, tag: str, card: str, reps: int) -> dict:
    """`prefix_scan` on the captured inputs for every number of threads
    per lane: bit-identical to the captured output, and timed."""
    _, args, kw, (want,) = seen["prefix_scan"]
    kernels.prefix_scan(*args, **kw)
    picked = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
    times = {}
    for G in kernels.SCAN_THREADS_PER_LANE:
        call = lambda: kernels.prefix_scan(*args, **kw, _threads_per_lane=G)
        if not torch.equal(call(), want):
            raise AssertionError(f"prefix_scan at {tag}: {G} threads per "
                                 "lane differ from the main path's output")
        times[G] = cuda_ms(call, reps)
    print(f"[scan-G] {curve.name} {tag} R={want.shape[2]} "
          f"lanes={want.shape[3]}: ms by "
          "threads per lane "
          + ", ".join(f"{G}: {t:.4f}" for G, t in times.items())
          + f"; the wrapper launched {picked}; all bit-identical [{card}]",
          flush=True)
    return dict(picked=picked, ms=times)


def same_as_plain(label: str, name: str, args, kw=None) -> None:
    kw = kw or {}
    got = as_tuple(getattr(kernels, name)(*args, **kw))
    want = as_tuple(getattr(kernels, name + "_plain")(*args))
    torch.cuda.synchronize()
    if any(g.dtype != w.dtype or not torch.equal(g, w)
           for g, w in zip(got, want, strict=True)):
        raise AssertionError(f"[edge] {label}: kernel differs from its "
                             "plain version")


def wide_edges(seen: dict, card: str) -> None:
    """`padd_batch`, the in-kernel `psub_batch` and `encode_mont` against
    their plain versions at shapes and values the main path may not
    reach: F = 1; F = 37 and 333, no multiple of the 5 lanes of a warp;
    infinity on either side, P + P and P + (-P); int16 limbs at both ends
    of the (-2^12, 2^13) ledger; every dtype form. encode_mont on the
    limbs of 0, 1 and p - 1."""
    L, w = CURVE.num_limbs, CURVE.log_limb_size
    pts = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    pts = pts.reshape(3, L, -1)                       # real G points, int32
    rng = np.random.default_rng(5)
    inf = kernels.inf_stacked(CURVE, (), DEVICE)
    pick = lambda F: torch.from_numpy(rng.integers(0, pts.shape[2], F)).to(
        DEVICE)
    cases = {"F=1": (pts[..., :1], pts[..., 1:2])}
    p, q = pts[..., pick(37)], pts[..., pick(37)]
    p[..., 0], q[..., 1], p[..., 2], q[..., 2] = inf, inf, inf, inf
    q[..., 3] = p[..., 3]                             # P + P
    q[..., 4] = kernels.pneg_stacked(p[..., 4], CURVE)  # P + (-P)
    cases["F=37 infinity, P+P, P+(-P)"] = (p, q)
    ends = torch.tensor([-(1 << w) + 1, (1 << (w + 1)) - 1],
                        dtype=torch.int32, device=DEVICE)
    p, q = pts[..., pick(333)].clone(), pts[..., pick(333)].clone()
    for t in (p, q):
        at = torch.from_numpy(rng.random(t.shape) < 0.3).to(DEVICE)
        at[:, L - 1] = False                          # top limbs stay small
        t[at] = ends[torch.from_numpy(rng.integers(0, 2, int(at.sum()))
                                      ).to(DEVICE)]
    cases["F=333 limbs at the ledger's ends"] = (p, q)
    n = 0
    for label, (p, q) in cases.items():
        for dt_in in (torch.int16, torch.int32):
            a, b = p.to(dt_in).contiguous(), q.to(dt_in).contiguous()
            for dt_out in (torch.int16, torch.int32):
                for fn in ("padd_batch", "psub_batch"):
                    same_as_plain(f"{fn} {label} {dt_in}->{dt_out}", fn,
                                  (a, b, CURVE, dt_out))
                    n += 1
    print(f"[edge] padd_batch and psub_batch bit-identical to their plain "
          f"versions in {n} launches: {', '.join(cases)}; int16 and int32 in "
          f"and out [{card}]", flush=True)
    xs = torch.tensor([int_to_limbs(v, L, w) for v in (0, 1, CURVE.p - 1)],
                      dtype=torch.int32).T.contiguous().to(DEVICE)
    same_as_plain("encode_mont of 0, 1, p - 1", "encode_mont", (xs, CURVE))
    print(f"[edge] encode_mont bit-identical to its plain version on the "
          f"limbs of 0, 1 and p - 1 [{card}]", flush=True)


def edge_shapes(seen: dict, card: str) -> None:
    """Both redesigned kernels against their plain versions at shapes the
    two sizes do not reach, on the real points of the captured run."""
    L = CURVE.num_limbs
    coltot = seen["col_prefix"][1][0]                  # (3, L, Wg, C)
    rng = np.random.default_rng(7)
    inf = kernels.inf_stacked(CURVE, (), DEVICE).to(torch.int16)
    done = []
    for Wg, C in ((1, 1), (3, 32), (4, 2048), (16, 8192)):
        reps = (1, 1, -(-Wg // coltot.shape[2]), -(-C // coltot.shape[3]))
        ct = coltot.repeat(*reps)[:, :, :Wg, :C].contiguous()
        if C >= 8:
            at_inf = torch.from_numpy(rng.random((Wg, C)) < 0.5).to(DEVICE)
            ct = torch.where(at_inf, inf[:, :, None, None], ct)
            ct[..., 3] = ct[..., 2]                    # the add is a doubling
            ct[..., 5] = kernels.pneg_stacked(ct[..., 4], CURVE)  # sum: inf
        same_as_plain(f"col_prefix {(Wg, C)}", "col_prefix", (ct, CURVE))
        blocks, per = kernels.LAUNCHED["col_prefix"].values()
        ms = cuda_ms(lambda: kernels.col_prefix(ct, CURVE), 3)
        done.append(f"{(Wg, C)} {blocks} blocks x {per} columns a thread "
                    f"{ms:.4f} ms")
    if per < 2:
        raise AssertionError("[edge] col_prefix: no shape with more columns "
                             "than resident threads")
    print("[edge] col_prefix bit-identical to its plain version at "
          + "; ".join(done) + f" [{card}]", flush=True)

    table = seen["prefix_scan"][1][0]                  # (n, 2L)
    done = []
    for Wg, C, R in ((1, 32, 1), (3, 37, 5)):
        n = C * R
        pay = np.stack([(rng.integers(0, table.shape[0], n) << 1)
                        | rng.integers(0, 2, n) for _ in range(Wg)])
        if R >= 4:
            a = pay[:, 0] & ~1
            pay[:, 1], pay[:, 2], pay[:, 3] = a, a | 1, a | 1  # 2a, a, inf
        pay = torch.from_numpy(pay.astype(np.int32)).to(DEVICE)
        for G in (None,) + kernels.SCAN_THREADS_PER_LANE:
            same_as_plain(f"prefix_scan {(Wg, C, R)} G={G}", "prefix_scan",
                          (table, pay, CURVE, C), dict(_threads_per_lane=G))
        done.append(f"(Wg, C, R) = {(Wg, C, R)}")
    print("[edge] prefix_scan bit-identical to its plain version at "
          + ", ".join(done) + ", each with "
          f"{kernels.SCAN_THREADS_PER_LANE} threads per lane and with the "
          f"launcher's pick [{card}]", flush=True)


# Lane counts of pdbl_batch's [edge] launches: one lane, the 8 lanes of
# a warp at 4 threads a doubling and one either side, the reduction
# path's 16.
PDBL_EDGES = (1, 7, 8, 9, 16)


def pdbl_edges(seen: dict, card: str) -> None:
    """`pdbl_batch` against its plain version at PDBL_EDGES lanes of real
    points of the captured run (the stage-3 sums G), on all-infinity
    lanes, and on 333 lanes whose limbs lie, three in ten, at the ends of
    the (-2^12, 2^13) ledger."""
    L, w = CURVE.num_limbs, CURVE.log_limb_size
    pts = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    pts = pts.reshape(3, L, -1)
    rng = np.random.default_rng(9)
    cases = {f"F={F}": pts[..., :F].contiguous() for F in PDBL_EDGES}
    cases["F=16 all at infinity"] = kernels.inf_stacked(CURVE, (16,),
                                                        DEVICE)
    ends = torch.tensor([-(1 << w) + 1, (1 << (w + 1)) - 1],
                        dtype=torch.int32, device=DEVICE)
    p = pts[..., torch.from_numpy(rng.integers(0, pts.shape[2], 333)).to(
        DEVICE)].clone()
    at = torch.from_numpy(rng.random(p.shape) < 0.3).to(DEVICE)
    at[:, L - 1] = False                              # top limbs stay small
    p[at] = ends[torch.from_numpy(rng.integers(0, 2, int(at.sum()))).to(
        DEVICE)]
    cases["F=333 limbs at the ledger's ends"] = p
    geos = []
    for label, p in cases.items():
        same_as_plain(f"pdbl_batch {label}", "pdbl_batch", (p, CURVE))
        geos.append(f"{label} {dict(kernels.LAUNCHED['pdbl_batch'])}")
    print(f"[edge] pdbl_batch bit-identical to its plain version in "
          f"{len(cases)} launches: {'; '.join(geos)} [{card}]", flush=True)


# (Wp, B, T) of pbpr_stage1's [edge] shapes, cut from the buckets of the
# smallest size: T = 1 (one lane a window, a chain of B + 1 steps, and 3
# lanes, no multiple of the 2 lanes a warp), T = B (one bucket a slice),
# and slices of 3 buckets over 224 lanes.
STAGE1_EDGES = ((3, 64, 1), (16, 512, 512), (7, 96, 32))
# (R, F) of globalize's [edge] shapes: F = 1, R = 1, and F no multiple of
# the 20 lanes of a block.
GLOBALIZE_EDGES = ((3, 1), (1, 37), (5, 333))


def stage1_globalize_edges(seen: dict, card: str) -> None:
    """`pbpr_stage1` and `globalize` against their plain versions at shapes
    and values the two sizes may not reach, on the real points of the
    captured run. In each slice of 3 or more buckets the second from the
    top is infinity and the third equals the top one, so m adds P + P and
    g adds P + P a step before; S of `globalize` is T's first row (P + P),
    its negative (P + (-P)) and infinity at its first three lanes."""
    L = CURVE.num_limbs
    buckets = seen["pbpr_full"][1][0]                   # (3, L, Wp, B)
    inf = kernels.inf_stacked(CURVE, (), DEVICE).to(torch.int16)
    n, done = 0, []
    for Wp, B, T in STAGE1_EDGES:
        b = buckets[:, :, :Wp, :B].clone()
        Bt = B // T
        if Bt >= 3:
            top = torch.arange(T, device=DEVICE) * Bt + Bt - 1
            b[..., top - 1] = inf[:, :, None, None]
            b[..., top - 2] = b[..., top]
        for dt in (torch.int16, torch.int32):
            label = f"pbpr_stage1 (Wp, B, T) = {(Wp, B, T)} {dt}"
            same_as_plain(label, "pbpr_stage1", (b.to(dt).contiguous(), CURVE,
                                                 T))
            n += 1
        done.append(f"{(Wp, B, T)} launched "
                    f"{dict(kernels.LAUNCHED['pbpr_stage1'])}")
    print(f"[edge] pbpr_stage1 bit-identical to its plain version in {n} "
          f"launches, int16 and int32 buckets, infinity and P + P in the "
          f"chains: {'; '.join(done)} [{card}]", flush=True)
    tbuf, S = first_group(CURVE, seen)
    n = 0
    for R, F in GLOBALIZE_EDGES:
        t = tbuf[:, :, :R, :F].contiguous()
        sp = S[..., :F].clone()
        sp[..., 0] = t[:, :, 0, 0]                                 # P + P
        if F > 2:
            sp[..., 1] = kernels.pneg_stacked(t[:, :, 0, 1], CURVE)  # P + (-P)
            sp[..., 2] = inf
        for dt_in in (torch.int16, torch.int32):
            for dt_out in (torch.int16, torch.int32):
                same_as_plain(f"globalize (R, F) = {(R, F)} {dt_in}->{dt_out}",
                              "globalize", (t.to(dt_in), sp.to(dt_in), CURVE,
                                            dt_out))
                n += 1
    print(f"[edge] globalize bit-identical to its plain version in {n} "
          f"launches at (R, F) = {', '.join(map(str, GLOBALIZE_EDGES))}, "
          f"S = T, -T and infinity, every dtype pair; launched "
          f"{dict(kernels.LAUNCHED['globalize'])} [{card}]", flush=True)


# (Wp, B, T) of pbpr_full's [edge] shapes, cut from the buckets of the
# largest size: T = 1 (no scan level), T = B (one bucket a slice, no
# doubling; at the 2^20 MSM's Wp and T, so its time is that of the
# scans, the tail and a stage 1 of one step), T = 1024 and 2048 (above
# the one block of threads a window of the kernel's first form; 2048
# gives the scans more adds than resident chains), one window, and
# B = 2^15 with T = 32 (a stage-1 chain of 1,024 steps, ten doublings).
PBPR_EDGES = ((2, 64, 1), (16, 512, 512), (16, 4096, 1024),
              (16, 4096, 2048), (1, 32768, 512), (1, 32768, 32))


# A pbpr_full edge of at most this many lanes (Wp * T) is held against
# its plain version run on the CPU, in child processes, after the last
# timed phase: its chains of thousands of small launch-bound adds would
# take minutes of the run on the card.
CPU_PLAIN_LANES = 64


def plain_on_cpu(name: str, args: tuple):
    """The plain version of kernel `name` on CPU copies of `args`; runs in
    a child process."""
    torch.set_num_threads(1)
    cpu = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
    return getattr(kernels, name + "_plain")(*map(cpu, args))


def pbpr_edges(seen: dict, card: str) -> list:
    """`pbpr_full` against its plain version at PBPR_EDGES, on the real
    buckets of the captured run. The narrow shapes keep their buckets and
    the kernel's output for `cpu_checks`."""
    buckets = seen["pbpr_full"][1][0]
    done = []
    for Wp, B, T in PBPR_EDGES:
        b = buckets[:, :, :Wp, :B].contiguous()
        label = f"pbpr_full (Wp, B, T) = {(Wp, B, T)}"
        cpu = {}
        if Wp * T <= CPU_PLAIN_LANES:
            cpu = dict(got=kernels.pbpr_full(b, CURVE, T).cpu(),
                       buckets=b.cpu())
            where = "(its plain version on the CPU: compared at the end)"
        else:
            same_as_plain(label, "pbpr_full", (b, CURVE, T))
            where = "bit-identical to its plain version"
        geo = dict(kernels.LAUNCHED["pbpr_full"])
        ms = cuda_ms(lambda: kernels.pbpr_full(b, CURVE, T), 3)
        done.append(dict(shape=(Wp, B, T), ms=ms, launched=geo, **cpu))
        print(f"[edge] {label}: {where}; launched {geo}; {ms:.4f} ms "
              f"[{card}]", flush=True)
    if max(d["launched"]["adds_per_chain"] for d in done) < 2:
        raise AssertionError("[edge] pbpr_full: no shape with more adds a "
                             "level than resident chains")
    return done


def cpu_checks(edges: list, card: str) -> None:
    """The pbpr_full edges kept for the CPU: their plain versions in
    spawned processes (the parent holds a CUDA context), all at once."""
    edges = [e for e in edges if "buckets" in e]
    if not edges:
        return
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(edges),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        wants = [pool.submit(plain_on_cpu, "pbpr_full",
                             (e.pop("buckets"), CURVE, e["shape"][2]))
                 for e in edges]
        for e, want in zip(edges, wants):
            got, want = e.pop("got"), want.result()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"[edge] pbpr_full {e['shape']}: kernel "
                                     "differs from its plain version")
            print(f"[edge] pbpr_full (Wp, B, T) = {e['shape']}: bit-identical "
                  f"to its plain version (run on the CPU) [{card}]",
                  flush=True)


# The kernels of csrc/ in a profiler trace: `<name>_kernel<...>` in the
# anonymous namespace of their sources.
PORT_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::\w+_kernel<")


def device_us(row) -> float:
    """Self device time of a profiler row in microseconds (the attribute
    is named after CUDA in older PyTorch)."""
    us = getattr(row, "self_device_time_total", None)
    return us if us is not None else row.self_cuda_time_total


def rest_split(logn: int) -> dict:
    """What the MSM does outside the port's kernels, from one real call:
    window_sums + host Horner on staged inputs, as `timed_runs` runs it,
    under torch.profiler after a warm-up call. Each kernel's device time
    goes to the PyTorch op that launched it (the op's self device time);
    the kernels of csrc/, launched through ctypes, have no such op and are
    summed apart. Then, on the host clock (median of 5), the d2h of the
    window sums, their decode and the host Horner, on the device output
    of the same program."""
    cfg = config(CURVE, logn, False)
    pipe = get_pipeline(cfg, DEVICE)
    n = 1 << logn
    xs, ys, hw, _, want = inputs(CURVE, logn)
    dev_in = [torch.from_numpy(a).to(DEVICE) for a in (
        xs.astype(np.int16), ys.astype(np.int16),
        np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.uint16))]
    call = lambda: pipe.horner(pipe.window_sums(*dev_in))
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(DEVICE).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        acc = call()
        wall = (time.perf_counter() - t0) * 1e3
    if not ref.jac_eq(CURVE, acc, want):
        raise AssertionError(f"2^{logn} [rest]: the profiled call differs "
                             "from the oracle")
    ops, port, device = {}, 0.0, 0.0
    for row in prof.key_averages():
        us = device_us(row)
        if us <= 0:
            continue
        if row.device_type == torch.autograd.DeviceType.CPU:
            ops[row.key] = us / 1e3
        else:
            device += us / 1e3
            if PORT_KERNEL.match(row.key):
                port += us / 1e3
    out = dict(wall_ms=wall, device_ms=device, kernels_ms=port,
               ops_ms=dict(sorted(ops.items(), key=lambda kv: -kv[1])))

    def host(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    g = pipe._run(pipe._stage(dev_in))
    windows = pipe._decode_windows(g)
    out["d2h"] = host(lambda: g.cpu())
    out["decode"] = host(lambda: pipe._decode_windows(g)) - out["d2h"]
    out["horner"] = host(lambda: pipe.horner(windows))
    return out


# How many PyTorch ops the [rest] line names; the others are summed.
REST_OPS = 8


def rest_line(logn: int, rest: dict, outside: float, card: str) -> None:
    ops = list(rest["ops_ms"].items())
    named = ", ".join(f"{k} {v:.3f}" for k, v in ops[:REST_OPS])
    others = [v for _, v in ops[REST_OPS:]]
    op_sum = sum(rest["ops_ms"].values())
    device = (f"device busy {rest['device_ms']:.2f} ms of the call's "
              f"{rest['wall_ms']:.2f} ms: the port's kernels "
              f"{rest['kernels_ms']:.2f} ms, PyTorch ops {op_sum:.2f} ms "
              f"({named}, {len(others)} other ops {sum(others):.3f})"
              if rest["device_ms"] else
              "device time not measured (the profiler saw no device "
              "activity)")
    host = rest["d2h"] + rest["decode"] + rest["horner"]
    print(f"[rest] n=2^{logn}, one window_sums + Horner under torch.profiler:"
          f" {device}; host d2h {rest['d2h']:.3f}, decode "
          f"{rest['decode']:.3f}, Horner {rest['horner']:.3f} ms; ops and "
          f"host together {op_sum + host:.2f} ms against the {outside:.2f} ms"
          f" of the end-to-end median outside the kernels [{card}]",
          flush=True)


def lane_sweep(card: str) -> dict:
    """`prefix_scan` over 2^18 to 2^21 stream elements at lane counts from
    a quarter of the default schedule's to sixteen times it, for every
    number of threads per lane: what the launcher's rule rests on."""
    L = CURVE.num_limbs
    rng = np.random.default_rng(13)
    out = {}
    for Wg, C, R in LANE_SHAPES:
        n = C * R
        table = torch.from_numpy(rng.integers(
            0, 1 << CURVE.log_limb_size, (n, 2 * L)).astype(np.int16)
            ).to(DEVICE)
        pay = torch.from_numpy(np.stack(
            [rng.permutation(n) << 1 for _ in range(Wg)]).astype(np.int32)
            ).to(DEVICE)
        kernels.prefix_scan(table, pay, CURVE, C)
        picked = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
        ms = {G: cuda_ms(lambda: kernels.prefix_scan(
            table, pay, CURVE, C, _threads_per_lane=G), 5)
            for G in kernels.SCAN_THREADS_PER_LANE}
        out[Wg * C] = dict(R=R, ms=ms, picked=picked)
        print(f"[scan-lanes] lanes={Wg * C} R={R}: ms by threads per lane "
              + ", ".join(f"{G}: {t:.4f}" for G, t in ms.items())
              + f"; the wrapper launched {picked} [{card}]", flush=True)
    return out


# Slice lengths Bt of the two pbpr_full calls on one warp (T = 8 lanes of
# four threads) whose difference gives the time of one stage-1 step.
PBPR_STEP_BT = (32, 256)


# Column counts of the two col_prefix calls on one warp (one window,
# log2 C levels) whose difference gives the time of one level.
COL_LEVEL_C = (2, 32)


def latency(curve, card: str, scan_G: int) -> dict:
    """One `padd_batch` launch on 32 lanes and one `pdbl_batch` launch on
    16; one col_prefix level, one scan step, one pbpr_full stage-1 step,
    one pbpr_stage1 step and one doubling on a single warp (32 lanes; 8
    for pbpr_full, four threads each, and for pbpr_stage1, twelve threads
    each, two a warp; one lane for pdbl_batch)."""
    L, R = curve.num_limbs, 128
    rng = np.random.default_rng(11)
    lazy = lambda shape: torch.from_numpy(rng.integers(
        0, 1 << curve.log_limb_size, (3, L) + shape).astype(np.int16)
        ).to(DEVICE)
    p, q = lazy((32,)), lazy((32,))
    table = torch.from_numpy(rng.integers(
        0, 1 << curve.log_limb_size, (32 * R, 2 * L)).astype(np.int16)
        ).to(DEVICE)
    pay = torch.from_numpy((rng.permutation(32 * R) << 1).astype(np.int32)
                           ).to(DEVICE)[None]
    blocker = lambda: busy(curve)
    padd_ms = queued_ms(lambda: kernels.padd_batch(p, q, curve), 50,
                        blocker)
    padd_geo = dict(kernels.LAUNCHED["padd_batch"])
    dbl = {F: lazy((F,)).to(torch.int32) for F in (16, 1)}
    dbl_ms = {F: queued_ms(lambda: kernels.pdbl_batch(d, curve), 50,
                           blocker)
              for F, d in dbl.items()}
    dbl_geo = dict(kernels.LAUNCHED["pdbl_batch"])
    # col_prefix on one window: one block, C threads of one warp,
    # max(log2 C, 1) levels a launch; the two calls differ by 4 levels
    cols = {C: lazy((1, C)) for C in COL_LEVEL_C}
    col = {C: queued_ms(lambda: kernels.col_prefix(cols[C], curve), 50,
                        blocker)
           for C in COL_LEVEL_C}
    lv = [max(C.bit_length() - 1, 1) for C in COL_LEVEL_C]
    col_level = (col[COL_LEVEL_C[1]] - col[COL_LEVEL_C[0]]) / (lv[1] - lv[0])
    step = {G: cuda_ms(lambda: kernels.prefix_scan(
        table, pay, curve, 32, _threads_per_lane=G), 20) / R
        for G in kernels.SCAN_THREADS_PER_LANE}
    # pbpr_full on one window of 8 lanes: the two calls differ by
    # Bt1 - Bt0 stage-1 steps and log2(Bt1 / Bt0) doublings, each about
    # as deep as a step
    lo, hi = PBPR_STEP_BT
    pb = {Bt: cuda_ms(lambda: kernels.pbpr_full(b, curve, 8), 10)
          for Bt, b in ((Bt, lazy((1, 8 * Bt))) for Bt in (lo, hi))}
    extra = (hi // lo).bit_length() - 1
    pbpr_step = (pb[hi] - pb[lo]) / (hi - lo + extra)
    # pbpr_stage1 on the same shapes: the two calls differ by Bt1 - Bt0
    # steps, each one add of each chain at once
    s1 = {Bt: cuda_ms(lambda: kernels.pbpr_stage1(b, curve, 8), 10)
          for Bt, b in ((Bt, lazy((1, 8 * Bt))) for Bt in (lo, hi))}
    s1_geo = dict(kernels.LAUNCHED["pbpr_stage1"])
    stage1_step = (s1[hi] - s1[lo]) / (hi - lo)
    print(f"[latency] {curve.name}: padd_batch on 32 lanes {padd_ms:.4f} "
          f"ms a launch "
          f"(launched {padd_geo}); pdbl_batch on 16 lanes {dbl_ms[16]:.4f} "
          f"ms a launch, one doubling on a lone warp {dbl_ms[1]:.4f} ms "
          f"(launched {dbl_geo}); one warp of lanes: col_prefix "
          f"{col_level:.5f} ms a level, from one window of C columns (C = "
          + ", ".join(f"{C} {t:.4f} ms" for C, t in col.items())
          + f"); prefix_scan (R={R}) ms a step by threads per lane "
          + ", ".join(f"{G}: {t:.5f}" for G, t in step.items())
          + f" (the 2^{max(SIZES)} shape runs {scan_G}); pbpr_full stage-1 "
          f"step (two adds at once) {pbpr_step:.5f} ms, from (1, 8 * Bt) "
          f"buckets at T = 8: Bt = {lo} {pb[lo]:.4f} ms, Bt = {hi} "
          f"{pb[hi]:.4f} ms; pbpr_stage1 step (two adds at once) "
          f"{stage1_step:.5f} ms, from the same buckets: Bt = {lo} "
          f"{s1[lo]:.4f} ms, Bt = {hi} {s1[hi]:.4f} ms, launched {s1_geo} "
          f"[{card}]", flush=True)
    return dict(padd_ms=padd_ms, padd_launched=padd_geo,
                pdbl_16_lanes_ms=dbl_ms[16], pdbl_one_warp_ms=dbl_ms[1],
                pdbl_one_warp_launched=dbl_geo,
                col_prefix_level_ms=col_level, col_prefix_one_warp_ms=col,
                scan_step_ms=step, pbpr_step_ms=pbpr_step,
                pbpr_one_warp_ms=pb, pbpr_stage1_step_ms=stage1_step,
                pbpr_stage1_one_warp_ms=s1, pbpr_stage1_launched=s1_geo)


def first_group(curve, seen: dict):
    """(T, S) of the first window group: the scan output (3, L, R, F) and
    the column prefix flattened to (3, L, F)."""
    tbuf = seen["prefix_scan"][3][0]
    S = seen["col_prefix"][3][0]
    return tbuf, S.reshape(3, curve.num_limbs, tbuf.shape[3])


def reduction_path(curve, seen: dict, logn: int, card: str,
                   full_ms: float):
    """Phase 4 at one size. Returns the launch counts of the path and the
    (3, L, Wp) sum that the path hands to `pdbl_batch`."""
    cfg = config(curve, logn, False)
    pipe = get_pipeline(cfg, DEVICE)
    buckets = seen["pbpr_full"][1][0]
    want = pipe._decode_windows(seen["pbpr_full"][3][0])

    kernels.reset_launches()
    with spy({}, [(kernels, "pdbl_batch")]) as dbl:
        got = pbpr.bucket_reduce(buckets, cfg)
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    got = pipe._decode_windows(got)
    for w, (a, b) in enumerate(zip(got, want, strict=True)):
        if not ref.jac_eq(curve, a, b):
            raise AssertionError(f"2^{logn}: bucket_reduce differs from "
                                 f"pbpr_full in window {w}")
    idle = [k for k in ("pbpr_stage1", "pdbl_batch", "padd_batch")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"2^{logn}: reduction path did not launch {idle}")
    times = [timed_once(lambda: pbpr.bucket_reduce(buckets, cfg))[1]
             for _ in range(3)]
    ms = statistics.median(times)
    used = {k: v for k, v in launches.items() if v}
    print(f"[reduce] {curve.name} n=2^{logn} bucket_reduce (3, L, "
          f"{buckets.shape[2]}, "
          f"{buckets.shape[3]}) T={cfg.pbpr_threads}: equal in the group to "
          f"pbpr_full in all {len(want)} windows; median {ms:.2f} ms of "
          f"{[round(t, 2) for t in times]} against pbpr_full {full_ms:.2f} ms;"
          f" launches={used} [{card}]", flush=True)
    return launches, ms, dbl["pdbl_batch"][1][0]


def globalise_check(curve, seen: dict, logn: int, card: str) -> int:
    """Phase 5 at one size. Returns the launches it made (one)."""
    cfg = config(curve, logn, False)
    tbuf, S = first_group(curve, seen)
    L, Wg = curve.num_limbs, cfg.subtask_group
    jt = seen["boundary_positions"][3][2][:Wg].long()
    want = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    kernels.reset_launches()
    G = kernels.globalize(tbuf, S, curve)
    got = G.reshape(3, L, -1)[:, :, jt]
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["globalize"]
    if launches == 0:
        raise AssertionError(f"2^{logn}: globalize was not launched")
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"2^{logn}: globalize(T, S) at the region ends "
                             "differs from the main path's G")
    print(f"[globalise] {curve.name} n=2^{logn} globalize(T "
          f"{tuple(tbuf.shape)}, "
          f"S {tuple(S.shape)}) at the {tuple(jt.shape)} region ends: "
          f"bit-identical to the main path's G [{card}]", flush=True)
    return launches


def check_nine(curve, seen: dict, logn: int, card: str, reps: int,
               full_ms: float) -> dict:
    """Phase 3 for `pbpr_stage1`, `globalize` and `pdbl_batch`
    (`off_path`), and phases 4 and 5 (`full_ms`: pbpr_full's time,
    beside the reduction path's)."""
    results = off_path(curve, seen, logn, card, reps)
    red = reduction_path(curve, seen, logn, card, full_ms)
    results["pdbl_batch[Wp]"] = compare(
        curve, "pdbl_batch[Wp]", "pdbl_batch", (red[2], curve), {},
        f"n=2^{logn}", card, reps)
    glob = globalise_check(curve, seen, logn, card)
    return dict(results=results, reduce_launches=red[0], reduce_ms=red[1],
                globalize_launches=glob)


def off_path(curve, seen: dict, logn: int, card: str, reps: int) -> dict:
    """`pbpr_stage1`, `globalize` and `pdbl_batch` against their plain
    versions on the captured run's buckets,
    the first window group's scan output and column prefix, and the
    stage-3 sums G."""
    cfg = config(curve, logn, False)
    tbuf, S = first_group(curve, seen)
    buckets = seen["pbpr_full"][1][0]
    gall = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    T = min(cfg.pbpr_threads, cfg.half_columns)
    calls = {"pbpr_stage1": ("pbpr_stage1", (buckets, curve, T)),
             "globalize": ("globalize", (tbuf, S, curve)),
             "pdbl_batch[Wg,B+1]": ("pdbl_batch", (gall, curve))}
    return {key: compare(curve, key, fn, args, {}, f"n=2^{logn}", card, reps)
            for key, (fn, args) in calls.items()}


def check_size(logn: int, card: str):
    """Phases 3 to 5 at one size."""
    reps = 5 if logn < 20 else 3
    seen = capture_inputs(CURVE, logn, False)
    tag = f"n=2^{logn}"
    results = check_main_kernels(CURVE, seen, tag, card, reps)
    sweep = scan_sweep(CURVE, seen, tag, card, reps)
    if logn == min(SIZES):
        edge_shapes(seen, card)
        wide_edges(seen, card)
        stage1_globalize_edges(seen, card)
        pdbl_edges(seen, card)
    pbpr_edge = pbpr_edges(seen, card) if logn == max(SIZES) else None
    nine = check_nine(CURVE, seen, logn, card, reps,
                      results["pbpr_full"]["ms"])
    results.update(nine["results"])
    red = (nine["reduce_launches"], nine["reduce_ms"])
    glob = nine["globalize_launches"]

    del seen
    torch.cuda.empty_cache()
    seen = capture_inputs(CURVE, logn, True)
    results_glv = check_main_kernels(CURVE, seen, f"n=2^{logn} glv", card,
                                     reps)
    sweep_glv = scan_sweep(CURVE, seen, f"n=2^{logn} glv", card, reps)
    _, args, kw, _ = seen["apply_glv"]
    glv_ms = cuda_ms(lambda: glv_dev.apply_glv(*args, **kw), reps)
    print(f"[apply_glv] n=2^{logn}: {glv_ms:.2f} ms for "
          f"{args[0].shape[1]} points (torch ops and 2 decompose_digits "
          f"launches) [{card}]", flush=True)
    del seen
    torch.cuda.empty_cache()
    return dict(main=results, glv=results_glv, reduce_launches=red[0],
                reduce_ms=red[1], globalize_launches=glob, apply_glv_ms=glv_ms,
                scan_sweep=sweep, scan_sweep_glv=sweep_glv,
                pbpr_edges=pbpr_edge)


def main_path(curve, logn: int, card: str, glv: bool = False):
    """Phase 6 (or, with glv, phase 7) at one size. Returns the launch
    counts of the user call, the timings, the threads per lane that the
    user call's scans were launched with, and the geometry its pbpr_full
    and its last padd_batch were launched with."""
    n = 1 << logn
    cfg = config(curve, logn, glv)
    _, _, hw, base, want = inputs(curve, logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    label = "msm-glv" if glv else "msm"

    kernels.reset_launches()
    kernels.LAUNCHED.clear()
    t0 = time.perf_counter()
    got = tpu_variable_base_msm(points, scalars, curve=curve, device=DEVICE,
                                config=cfg if glv else None)
    t_user = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    scan_G = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
    pbpr_geo = dict(kernels.LAUNCHED["pbpr_full"])
    padd_geo = dict(kernels.LAUNCHED["padd_batch"])
    if not ref.jac_eq(curve, got, want):
        raise AssertionError(f"2^{logn} {label}: MSM result differs from "
                             "the oracle")
    idle = [k for k in MAIN if launches[k] == 0]
    if idle:
        raise AssertionError(f"2^{logn} {label}: kernels not launched: {idle}")
    used = {k: v for k, v in launches.items() if v}
    print(f"[{label}] {curve.name} n=2^{logn} tpu_variable_base_msm EXACT "
          f"in {t_user:.2f} s"
          f" (host pack included) launches={used}, the scan with {scan_G} "
          f"threads a lane, pbpr_full launched {pbpr_geo}, the last "
          f"padd_batch launched {padd_geo} [{card}]", flush=True)

    return (launches, *timed_runs(cfg, logn, label, card), scan_G, pbpr_geo,
            padd_geo)


def timed_runs(cfg: MSMConfig, logn: int, label: str, card: str):
    """Bench-style timing: int16/uint16 wire inputs, staged h2d timed
    apart, then window_sums + host Horner; median of 3, each EXACT."""
    n = 1 << logn
    pipe = get_pipeline(cfg, DEVICE)
    xs, ys, hw, _, want = inputs(cfg.curve, logn)
    wire = (xs.astype(np.int16), ys.astype(np.int16),
            np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.uint16))
    times, h2ds = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_in = [torch.from_numpy(a).to(DEVICE) for a in wire]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc = pipe.horner(pipe.window_sums(*dev_in))
        t2 = time.perf_counter()
        if not ref.jac_eq(cfg.curve, acc, want):
            raise AssertionError(f"2^{logn} {label}: timed run differs from "
                                 "the oracle")
        h2ds.append((t1 - t0) * 1e3)
        times.append((t2 - t1) * 1e3)
    ms, h2d = statistics.median(times), statistics.median(h2ds)
    lanes = (2 if cfg.glv else 1) * n
    print(f"[{label}] {cfg.curve.name} n=2^{logn} s={cfg.window_size} "
          f"W={cfg.num_windows} "
          f"groups={cfg.num_groups} stream={lanes} lanes C={cfg.columns} "
          f"T={cfg.pbpr_threads} Wg={cfg.subtask_group}: device+decode+"
          f"horner median {ms:.2f} ms of {[round(t, 2) for t in times]}, "
          f"h2d {h2d:.2f} ms, EXACT [{card}]", flush=True)
    return ms, h2d


def schedule_run(card: str):
    """The largest size under SCHEDULE: launch counts of one run, then
    the timed runs. Recorded beside the default schedule, not the default."""
    logn = max(SIZES)
    cfg = MSMConfig(curve=CURVE, **SCHEDULE)
    lanes = cfg.subtask_group * cfg.columns
    kernels.reset_launches()
    kernels.LAUNCHED.clear()
    ms, h2d = timed_runs(cfg, logn, "schedule", card)
    G = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
    blocks, per = kernels.LAUNCHED["col_prefix"].values()
    used = {k: v // 3 for k, v in kernels.LAUNCHES.items() if v}
    idle = [k for k in MAIN if k not in used]
    if idle:
        raise AssertionError(f"schedule: kernels not launched: {idle}")
    print(f"[schedule] n=2^{logn} {SCHEDULE}: {lanes} scan lanes with {G} "
          f"thread(s) a lane, col_prefix {blocks} blocks x {per} columns a "
          f"thread; median {ms:.2f} ms; launches a run={used} [{card}]",
          flush=True)
    return ms, used


def where_line(label: str, logn: int, launches: dict, results: dict,
               total_ms: float, card: str, extra: str = "") -> None:
    """launches x kernel time (padd_batch: mean of its two dtype forms);
    returns the kernels' sum."""
    per = {name: launches[name] * statistics.mean(
        r["ms"] for r in results.values() if r["name"] == name)
        for name in MAIN}
    print(f"[{label}] n=2^{logn}: " + ", ".join(
        f"{k} {v:.2f}" for k, v in per.items()) + f" ms; kernels "
        f"{sum(per.values()):.2f} of {total_ms:.2f} ms end to end{extra} "
        f"[{card}]", flush=True)
    return sum(per.values())


def affine_check(curve, logn: int, card: str, glv: bool) -> float:
    """Phase 8: `to_affine` on the card against the host decode."""
    n = 1 << logn
    cfg = config(curve, logn, glv)
    pipe = get_pipeline(cfg, DEVICE)
    xs, ys, hw, _, _ = inputs(curve, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    g = pipeline_cuda.windows_device(
        *(torch.from_numpy(a.astype(np.int32)).to(DEVICE)
          for a in (xs, ys, hw)), cfg)
    want = pipe._decode_windows(g)
    (ax, ay, inf), ms = timed_once(lambda: to_affine(g, curve))
    if ax.device != g.device or ax.shape != g.shape[1:]:
        raise AssertionError("to_affine: wrong device or shape")
    w = curve.log_limb_size
    vals = lambda t: [curve.from_mont(sum(int(v) << (w * i) for i, v in
                                          enumerate(col)))
                      for col in t.cpu().numpy().T.tolist()]
    got = list(zip(vals(ax), vals(ay), inf.cpu().tolist()))
    for k, ((x, y, is_inf), ref_pt) in enumerate(zip(got, want)):
        host = (0, 0, True) if ref.is_inf(ref_pt) else (*ref_pt[:2], False)
        if (x, y, is_inf) != host:
            raise AssertionError(f"to_affine: window {k} differs from the "
                                 "host decode")
    if not all(is_inf for _, _, is_inf in got[len(want):]):
        raise AssertionError("to_affine: a pad window is not at infinity")
    print(f"[affine] {curve.name} n=2^{logn}{' glv' if glv else ''} "
          f"to_affine on the "
          f"(3, L, {g.shape[2]}) window sums ({g.shape[2] - len(want)} pad "
          f"windows at infinity): equal to the host decode in all {len(want)} windows, "
          f"infinity masks agree; {ms:.1f} ms [{card}]", flush=True)
    return ms


def run_profile(curve, sizes, card: str) -> dict:
    """A profile beyond BN254_S12 through the main path. At each size:
    the six kernels of the main path, `pbpr_stage1`, `globalize` and
    `pdbl_batch` against their plain versions on the shapes the run gives
    them, the scan for every number of threads per lane, the reduction
    and globalisation paths (phases 3 to 5). Then the MSM at every size,
    EXACT, counted and timed (phase 6); for PROFILE_FULL the GLV MSM and
    the [latency] line (phase 7) and to_affine (phase 8) at the smallest
    size; a [where] line for each size."""
    t0 = time.perf_counter()
    warm_plain(curve)
    checked, nine = {}, {}
    for logn in sizes:
        reps = 5 if logn < 20 else 3
        tag = f"n=2^{logn}"
        seen = capture_inputs(curve, logn, False)
        checked[logn] = check_main_kernels(curve, seen, tag, card, reps)
        scan_sweep(curve, seen, tag, card, reps)
        nine[logn] = check_nine(curve, seen, logn, card, reps,
                                checked[logn]["pbpr_full"]["ms"])
        del seen
        torch.cuda.empty_cache()
    runs = {logn: main_path(curve, logn, card) for logn in sizes}
    out = dict(checked=checked, nine=nine, runs=runs)
    if curve is PROFILE_FULL:
        small = min(sizes)
        out["glv"] = main_path(curve, small, card, glv=True)
        out["affine_ms"] = affine_check(curve, small, card, glv=False)
        out["latency"] = latency(curve, card, runs[max(sizes)][3])
    for logn in sizes:
        where_line("where", logn, runs[logn][0], checked[logn],
                   runs[logn][1], card, f" ({curve.name})")
    out["seconds"] = time.perf_counter() - t0
    print(f"[profile] {curve.name}: every phase passed in "
          f"{out['seconds']:.1f} s [{card}]", flush=True)
    return out


def profile_entry(name: str, prof: dict) -> dict:
    """What the JSON line keeps of one kernel at one profile of PROFILES:
    the time, bound, launches, error and plain time at each size of its
    MSM."""
    out = {}
    sizes = sorted(prof["runs"])
    for logn in sizes:
        sfx = "" if logn == max(sizes) else f"_2p{logn}"
        nine = prof["nine"][logn]
        r = next(v for v in (*prof["checked"][logn].values(),
                             *nine["results"].values()) if v["name"] == name)
        if name in MAIN:
            launches = prof["runs"][logn][0][name]
        elif name == "globalize":
            launches = nine["globalize_launches"]
        else:
            launches = nine["reduce_launches"][name]
        out.update({f"launches{sfx}": launches, f"ms{sfx}": r["ms"],
                    f"bound_ms{sfx}": r["bound_ms"],
                    f"bound_by{sfx}": r["bound_by"],
                    f"x_bound{sfx}": r["ms"] / r["bound_ms"],
                    f"max_abs_err{sfx}": r["max_abs_err"],
                    f"plain_ms{sfx}": r["plain_ms"],
                    f"library_ms{sfx}": None})
        if name in WIDE:
            out[f"bound_ms_mont_mul_ops{sfx}"] = r["bound_ms_mont_mul_ops"]
    return out


# ---------------------------------------------------------------------------
# [sharded]: the multi-device MSM (tpu_msm_torch/parallel/sharded.py)
# ---------------------------------------------------------------------------

SHARDED_LOGN = 20
# window shards of one process: 16 windows in 16 groups at 2^20
SHARDED_W = (2, 4)
# (x, w) meshes of the ranks that share the card over gloo
SHARDED_MESHES = ({"x": 2}, {"x": 2, "w": 2})
# A rank's collectives fail after RANK_GROUP_TIMEOUT_S; a world whose
# ranks have not all reported by RANK_DEADLINE_S fails the phase.
RANK_GROUP_TIMEOUT_S = 120
RANK_DEADLINE_S = 240.0
SHARED = "ranks sharing one card; not multi-GPU scaling"


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_label(shape: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in shape.items())


def sharded_inputs(logn: int):
    """The planar inputs of the 2^logn MSM as int32 device tensors, with
    the two pad rows of the halfwords."""
    n = 1 << logn
    xs, ys, hw, _, _ = inputs(CURVE, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    return [torch.from_numpy(a.astype(np.int32)).to(DEVICE)
            for a in (xs, ys, hw)]


def window_shards(card: str) -> dict:
    """Phase [sharded] 1: `windows_device` at every w of SHARDED_W and
    every w_index in one process. The shards concatenated decode to the
    unsharded window sums and their Horner sum to the oracle's; pbpr_full's
    launch at Wp_l = Wp / w is the one `pbpr_full_geometry` gives; on the
    first shard at the largest w, pbpr_full and the first group's scan,
    column prefix and extraction adds are held against their plain
    versions and timed."""
    logn = SHARDED_LOGN
    cfg = config(CURVE, logn, False)
    want = inputs(CURVE, logn)[4]
    pipe = get_pipeline(cfg, DEVICE)
    dev_in = sharded_inputs(logn)
    run = lambda **kw: pipeline_cuda.windows_device(*dev_in, cfg, **kw)
    full = pipe._decode_windows(run())
    full_ms = statistics.median(timed_once(run)[1] for _ in range(3))
    B, T = cfg.half_columns, min(cfg.pbpr_threads, cfg.half_columns)
    limits = kernels._pbpr_full_limits(CURVE, dev_in[0].device)
    out = dict(full_ms=full_ms, shards={})
    seen = {}
    for w in SHARDED_W:
        Wl = cfg.padded_windows // w
        shards = []
        for i in range(w):
            targets = [(kernels, k) for k in ("prefix_scan", "col_prefix",
                                              "padd_batch", "psub_batch",
                                              "pbpr_full")]
            with spy(seen if (w, i) == (max(SHARDED_W), 0) else {},
                     targets):
                shards.append(run(w_shards=w, w_index=i))
            sync(DEVICE)
        launched = dict(kernels.LAUNCHED["pbpr_full"])
        stage1, scan, per_chain = kernels.pbpr_full_geometry(Wl, B, T,
                                                             *limits)
        if (launched["stage1_blocks"], launched["scan_blocks"],
                launched["adds_per_chain"]) != (stage1, scan, per_chain):
            raise AssertionError(f"[sharded] w={w}: pbpr_full launched "
                                 f"{launched}, its geometry says "
                                 f"{(stage1, scan, per_chain)}")
        got = pipe._decode_windows(torch.cat(shards, dim=2))
        for j, (a, b) in enumerate(zip(got, full, strict=True)):
            if not ref.jac_eq(CURVE, a, b):
                raise AssertionError(f"[sharded] w={w}: window {j} differs "
                                     "from the unsharded window sums")
        if not ref.jac_eq(CURVE, pipe.horner(got), want):
            raise AssertionError(f"[sharded] w={w}: MSM differs from the "
                                 "oracle")
        ms = [statistics.median(timed_once(
            lambda: run(w_shards=w, w_index=i))[1] for _ in range(3))
            for i in range(w)]
        out["shards"][w] = dict(Wp_l=Wl, ms=ms, pbpr_full_launched=launched)
        print(f"[sharded] {CURVE.name} n=2^{logn} window shards w={w} "
              f"(Wp_l={Wl}, {cfg.num_groups // w} groups a shard): "
              f"concatenated equal to the unsharded window sums, EXACT; "
              f"each shard median of 3 "
              f"{[round(t, 2) for t in ms]} ms against {full_ms:.2f} ms "
              f"unsharded; pbpr_full launched {launched} [{card}]",
              flush=True)
    tag = f"n=2^{logn} w={max(SHARDED_W)} shard 0"
    out["kernels"] = {key: compare(CURVE, key, name, args, kw, tag, card, 3)
                      for key, (name, args, kw, _) in seen.items()}
    return out


def rank_spans(card: str) -> dict:
    """The kernels of the gloo ranks' paths, in one process before the
    spawns: for each mesh of SHARDED_MESHES, `windows_device` on rank 0's
    span of the 2^20 points (n / x of them, under the 2^20 schedule, as
    `ShardedMSMPipeline.window_sums` slices it) at its first window shard
    (w_index 0 of w; at w = 2, pbpr_full at Wp_l = 8). Every kernel call
    of the main path is kept by `spy` and held against its plain version
    on the same inputs, then timed."""
    logn = SHARDED_LOGN
    cfg = config(CURVE, logn, False)
    dev_in = sharded_inputs(logn)
    targets = [(kernels, k) for k in MAIN + ("psub_batch",)]
    out = {}
    for shape in SHARDED_MESHES:
        x, w = shape["x"], shape.get("w", 1)
        span = [a[:, :a.shape[1] // x] for a in dev_in]
        with spy({}, targets) as seen:
            pipeline_cuda.windows_device(*span, cfg, w_shards=w, w_index=0)
            sync(DEVICE)
        tag = (f"n=2^{logn} span 0 of x={x}"
               + (f", w-shard 0 of {w}" if w > 1 else ""))
        out[mesh_label(shape)] = check_main_kernels(CURVE, seen, tag, card,
                                                    3)
    return out


def reduce_tree_check(card: str) -> dict:
    """`_reduce_gathered` on the (3, L, ndev, Wp) window sums of the ndev
    spans of the 2^20 points, as ndev ranks on "x" gather them, at
    ndev = 2 (the gloo meshes' x) and 4: bit-identical to the same tree
    of plain adds, each level's `padd_batch` against its plain version,
    and the sums equal to the unsharded window sums."""
    logn = SHARDED_LOGN
    cfg = config(CURVE, logn, False)
    pipe = get_pipeline(cfg, DEVICE)
    dev_in = sharded_inputs(logn)
    full = pipe._decode_windows(pipeline_cuda.windows_device(*dev_in, cfg))
    out = {}
    for ndev in (2, 4):
        q = dev_in[0].shape[1] // ndev
        stack = torch.stack([pipeline_cuda.windows_device(
            *(a[:, k * q:(k + 1) * q] for a in dev_in), cfg)
            for k in range(ndev)], dim=2)
        kernels.reset_launches()
        got = sharded._reduce_gathered(stack, CURVE, ndev)
        sync(DEVICE)
        launches = kernels.LAUNCHES["padd_batch"]
        g, d, levels = stack, ndev, {}
        while d > 1:
            h = d // 2
            key = f"padd_batch[reduce {d}->{h}]"
            levels[key] = compare(CURVE, key, "padd_batch",
                                  (g[:, :, :h], g[:, :, h:d], CURVE), {},
                                  f"n=2^{logn} tree of {ndev}", card, 5)
            g, d = kernels.padd_batch_plain(g[:, :, :h], g[:, :, h:d],
                                            CURVE), h
        if not torch.equal(got, g[:, :, 0]):
            raise AssertionError(f"[sharded] _reduce_gathered of {ndev} "
                                 "differs from the tree of plain adds")
        for j, (a, b) in enumerate(zip(pipe._decode_windows(got), full,
                                       strict=True)):
            if not ref.jac_eq(CURVE, a, b):
                raise AssertionError(f"[sharded] tree of {ndev} spans: "
                                     f"window {j} differs from the "
                                     "unsharded window sums")
        if launches != ndev.bit_length() - 1:
            raise AssertionError(f"[sharded] tree of {ndev} launched "
                                 f"padd_batch {launches} times")
        print(f"[sharded] _reduce_gathered on {tuple(stack.shape)}: "
              f"{launches} padd_batch launches, bit-identical to the tree "
              f"of plain adds, equal to the unsharded window sums [{card}]",
              flush=True)
        out[ndev] = dict(launches=launches, levels=levels)
    return out


def exchange_timed(g: torch.Tensor, mesh, device: str, reps: int = 3):
    """`sharded.exchange` of this rank's window sums `g`, called on its
    own after a barrier: (its result, the median of `reps` host times
    between synchronizes in ms, the padd_batch launches of one call)."""
    times = []
    for _ in range(reps):
        dist.barrier()
        sync(device)
        t0 = time.perf_counter()
        kernels.reset_launches()
        out = sharded.exchange(g, mesh, CURVE)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times), kernels.LAUNCHES["padd_batch"]


def sharded_nccl(card: str) -> dict:
    """Phase [sharded] 2: `sharded_msm` on a mesh (1,) of one NCCL rank,
    the user's entry point on the 2^20 points, EXACT, every kernel of
    the path counted (reset before, read after); then the exchange on
    its own."""
    logn = SHARDED_LOGN
    n = 1 << logn
    _, _, hw, base, want = inputs(CURVE, logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if DEVICE == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S))
        try:
            mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("x",))
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = sharded.sharded_msm(points, scalars, mesh, curve=CURVE,
                                      device=DEVICE)
            t_user = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            g = pipeline_cuda.windows_device(*sharded_inputs(logn),
                                             config(CURVE, logn, False))
            reduced, exchange_ms, tree = exchange_timed(g, mesh, DEVICE)
        finally:
            dist.destroy_process_group()
    if not ref.jac_eq(CURVE, got, want):
        raise AssertionError("[sharded] one NCCL rank: MSM differs from the "
                             "oracle")
    if not torch.equal(reduced, g):
        raise AssertionError("[sharded] one NCCL rank: the exchange changed "
                             "the window sums")
    idle = [k for k in MAIN if launches[k] == 0]
    if idle:
        raise AssertionError(f"[sharded] one NCCL rank: kernels not "
                             f"launched: {idle}")
    used = {k: v for k, v in launches.items() if v}
    print(f"[sharded] {CURVE.name} n=2^{logn} sharded_msm on a mesh (1,) of "
          f"one {backend} rank EXACT in {t_user:.2f} s (host pack "
          f"included); the exchange on its own, median of 3, "
          f"{exchange_ms:.3f} ms; launches={used} [{card}]", flush=True)
    return dict(backend=backend, seconds=t_user, launches=used,
                exchange_tree_ms=exchange_ms, tree_launches=tree)


def sharded_rank(rank: int, world: int, shape: dict, workdir: str, want,
                 device: str) -> dict:
    """One rank of a gloo world on `device` (spawned; the library is
    already built): the sharded pipeline's window sums of the 2^20
    points handed over in workdir, once counted and EXACT, then the
    median of 3, each EXACT; then the exchange on its own, its result
    equal to the pipeline's window sums."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous-"
        f"{mesh_label(shape)}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S))
    try:
        mesh = init_device_mesh(device, tuple(shape.values()),
                                mesh_dim_names=tuple(shape))
        dev_in = [torch.from_numpy(np.load(os.path.join(
            workdir, f"{k}.npy"))).to(device) for k in ("xs", "ys", "hw")]
        cfg = default_config(dev_in[0].shape[1], CURVE)
        pipe = sharded.get_sharded_pipeline(cfg, mesh, device)
        kernels.reset_launches()
        windows = pipe.window_sums(*dev_in)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        exact = ref.jac_eq(CURVE, pipe.horner(windows), want)
        times = []
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            windows = pipe.window_sums(*dev_in)
            times.append((time.perf_counter() - t0) * 1e3)
            exact = exact and ref.jac_eq(CURVE, pipe.horner(windows), want)
        # this rank's own sums, as window_sums computes them, exchanged
        x, w = shape["x"], shape.get("w", 1)
        span = dev_in[0].shape[1] // x
        lo = mesh.get_local_rank("x") * span
        g = pipeline_cuda.windows_device(
            *(a[:, lo:lo + span] for a in dev_in), cfg, w_shards=w,
            w_index=mesh.get_local_rank("w") if w > 1 else 0)
        reduced, exchange_ms, tree = exchange_timed(g, mesh, device)
        exact = exact and pipe._decode_windows(reduced) == windows
        return dict(rank=dist.get_rank(), exact=exact, launches=launches,
                    tree_launches=tree, window_sums_ms=times,
                    exchange_tree_ms=exchange_ms)
    finally:
        dist.destroy_process_group()


def sharded_gloo(card: str) -> dict:
    """Phase [sharded] 3: the meshes of SHARDED_MESHES, their ranks
    spawned on this one card over gloo (`parallel.spawn.run_ranks`), the
    2^20 inputs handed over in .npy files. Every rank EXACT and every
    kernel of the path launched on it; each rank's window_sums time and
    its exchange + tree time."""
    logn = SHARDED_LOGN
    n = 1 << logn
    xs, ys, hw, _, want = inputs(CURVE, logn)
    wire = dict(xs=xs.astype(np.int16), ys=ys.astype(np.int16),
                hw=np.concatenate([hw, np.zeros((2, n), np.uint32)]
                                  ).astype(np.uint16))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, a in wire.items():
            np.save(os.path.join(tmp, f"{k}.npy"), a)
        for shape in SHARDED_MESHES:
            label = mesh_label(shape)
            t0 = time.perf_counter()
            ranks = spawn.run_ranks(sharded_rank, math.prod(shape.values()),
                                    (shape, tmp, want, DEVICE),
                                    RANK_DEADLINE_S)
            seconds = time.perf_counter() - t0
            x = shape["x"]
            for res in ranks:
                idle = [k for k in MAIN if k not in res["launches"]]
                if not res["exact"] or idle:
                    raise AssertionError(f"[sharded] {label} rank "
                                         f"{res['rank']}: exact="
                                         f"{res['exact']}, not launched "
                                         f"{idle}")
                if res["tree_launches"] != x.bit_length() - 1:
                    raise AssertionError(f"[sharded] {label}: the tree "
                                         f"launched {res['tree_launches']}"
                                         " times")
            out[label] = dict(seconds=seconds, ranks=ranks)
            print(f"[sharded] {CURVE.name} n=2^{logn} mesh {label}, "
                  f"{len(ranks)} gloo {SHARED}: every rank EXACT; "
                  + "; ".join(
                      f"rank {r['rank']} window_sums median "
                      f"{statistics.median(r['window_sums_ms']):.2f} ms of "
                      f"{[round(t, 2) for t in r['window_sums_ms']]}, "
                      f"exchange + tree on its own, median of 3, "
                      f"{r['exchange_tree_ms']:.3f} ms, "
                      f"launches={r['launches']}" for r in ranks)
                  + f"; {seconds:.1f} s from spawn to exit [{card}]",
                  flush=True)
    return out


def sharded_compares(run: dict) -> list:
    """Every `compare` result of the [sharded] phases."""
    return (list(run["window_shards"]["kernels"].values())
            + [r for span in run["rank_spans"].values()
               for r in span.values()]
            + [r for tree in run["reduce_tree"].values()
               for r in tree["levels"].values()])


def sharded_phase(card: str) -> dict:
    """The [sharded] phases, timed as a whole."""
    t0 = time.perf_counter()
    # one host: the ranks meet on the loopback interface
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    out = dict(label=SHARED, logn=SHARDED_LOGN,
               window_shards=window_shards(card),
               rank_spans=rank_spans(card),
               reduce_tree=reduce_tree_check(card),
               nccl=sharded_nccl(card), gloo=sharded_gloo(card))
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[sharded] every phase passed in {out['seconds']:.1f} s "
          f"[{card}]", flush=True)
    return out


# The limb counts whose kernels the [ptxas] and [sass] lines report:
# BN254_S12's and those of PROFILES (TINY62's L = 6 is left out).
PTXAS_LIMBS = (CURVE.num_limbs,) + tuple(c.num_limbs for c, _ in PROFILES)


# Element types as the mangled template arguments name them.
MANGLED_TYPES = {"s": "int16", "i": "int32"}


def template_args(fn: str, name: str) -> list:
    """The template arguments of the mangled `<name><...>` in `fn`: each
    int (Li<n>E) as a string, each element type by name."""
    out = []
    for m in re.finditer(r"Li(\d+)E|([a-z])|(E)", fn.split(name + "I", 1)[1]):
        if m[3]:
            break
        out.append(m[1] or MANGLED_TYPES.get(m[2], m[2]))
    return out


# What the [sass] lines count, by opcode (IMAD.WIDE and IMAD.HI apart
# from the other IMAD forms): the multiply-adds, the loads and stores by
# state space (LD and ST without a suffix are generic), calls.
SASS_KINDS = ("IMAD.WIDE", "IMAD.HI", "IMAD", "IADD3", "LD", "LDS", "LDG",
              "LDL", "LDC", "ST", "STS", "STG", "STL", "CALL")


def sass_counts(stem: str) -> dict:
    """Instruction counts of every kernel of csrc/<stem>.cu at the limb
    counts PTXAS_LIMBS, read
    from its object file with cuobjdump -sass. A kernel's listing holds
    the out-of-line functions it calls (padd_batch's msm::mul_wide)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build.BUILD_DIR / f"{stem}.o")],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            targs = (template_args(m[1], "_kernel") if "_kernelI" in m[1]
                     else [None])
            cur = None
            if targs[0] in map(str, PTXAS_LIMBS):
                cur = f"{kernel_name(m[1])}<{', '.join(targs)}>"
                out[cur] = dict.fromkeys(("total",) + SASS_KINDS, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if cur and m:
            op = m[2]
            kind = next((k for k in ("IMAD.WIDE", "IMAD.HI") if
                         op.startswith(k)), op.split(".")[0])
            out[cur]["total"] += 1
            if kind in out[cur]:
                out[cur][kind] += 1
    return out


def kernel_name(fn: str) -> str:
    """`name` of a mangled `<name>_kernel<...>` symbol: the identifier
    that its length, in decimal, precedes."""
    head = fn.split("_kernelI")[0]
    for i in range(len(head) - 1, 0, -1):
        if (head[i].isalpha() and head[i - 1].isdigit()
                and head[:i].endswith(str(len(head) - i + 7))):
            return head[i:]
    raise ValueError(f"no kernel name in {fn}")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {_build.build_seconds})", flush=True)
    resources = {}
    for stem in ("col_prefix", "prefix_scan", "pbpr_full", "encode_mont",
                 "padd_batch", "pdbl_batch", "pbpr_stage1", "globalize"):
        for fn, regs, stack, st, ld in _build.resources(stem):
            # kernel name and template arguments <L, W[, G, types]> from
            # the mangled name
            targs = template_args(fn, "_kernel")
            if int(targs[0]) not in PTXAS_LIMBS:
                continue
            resources[f"{stem}.{kernel_name(fn)}<{', '.join(targs)}>"] = dict(
                registers=regs, stack_bytes=stack, spill_store_bytes=st,
                spill_load_bytes=ld)
    for k, v in resources.items():
        print(f"[ptxas] {k}: {v} [{card}]", flush=True)
    sass = {}
    for stem in WIDE:
        for fn, counts in sass_counts(stem).items():
            sass[f"{stem}.{fn}"] = counts
            print(f"[sass] {stem}.{fn}: " + ", ".join(
                f"{k} {v}" for k, v in counts.items() if v or k == "LD")
                + f" [{card}]", flush=True)

    return run_all(card, t_start, resources, sass)


def warm_plain(curve) -> None:
    """The plain point formulas once on two lanes, so that no compared
    plain version is timed with PyTorch's first-use set-up on the card,
    which can take seconds."""
    z = kernels.inf_stacked(curve, (2,), DEVICE)
    kernels.padd_batch_plain(z, z, curve)
    kernels.psub_batch_plain(z, z, curve)
    kernels.pdbl_batch_plain(z, curve)
    kernels.encode_mont_plain(z[0], curve)
    kernels.decompose_digits_plain(
        torch.zeros((18, 2), dtype=torch.int32, device=DEVICE), 13, 20)
    torch.cuda.synchronize()


def run_all(card: str, t_start: float, resources: dict, sass: dict) -> int:
    """Phases 3 to 13."""
    warm_plain(CURVE)
    checks = {logn: check_size(logn, card) for logn in SIZES}
    runs = {logn: main_path(CURVE, logn, card) for logn in SIZES}
    runs_glv = {logn: main_path(CURVE, logn, card, glv=True)
                for logn in SIZES}
    sched_ms, sched_launches = schedule_run(card)
    lat = latency(CURVE, card, runs[max(SIZES)][3])
    lanes_ms = lane_sweep(card)
    affine_ms = affine_check(CURVE, min(SIZES), card, glv=False)
    affine_check(CURVE, min(SIZES), card, glv=True)
    rests = {logn: rest_split(logn) for logn in SIZES}
    profiles = {c.name: run_profile(c, sizes, card) for c, sizes in PROFILES}
    shard_run = sharded_phase(card)
    cpu_checks(checks[max(SIZES)]["pbpr_edges"], card)

    for logn in SIZES:
        kern_ms = where_line("where", logn, runs[logn][0],
                             checks[logn]["main"], runs[logn][1], card)
        where_line("where-glv", logn, runs_glv[logn][0], checks[logn]["glv"],
                   runs_glv[logn][1], card,
                   f"; apply_glv {checks[logn]['apply_glv_ms']:.2f} ms")
        rest_line(logn, rests[logn], runs[logn][1] - kern_ms, card)

    entries = []
    for name in KERNELS:
        src, replaces, path = SOURCES[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "path": path}
        for logn in sorted(SIZES, reverse=True):
            # the first compared call of the kernel (padd_batch: i16 -> i32;
            # pdbl_batch: the (Wg, B+1) batch)
            c = checks[logn]
            first = lambda res: next(v for v in res.values()
                                     if v["name"] == name)
            r = first(c["main"])
            sfx = "" if logn == max(SIZES) else f"_2p{logn}"
            if name in MAIN:
                launches = runs[logn][0][name]
            elif name == "globalize":
                launches = c["globalize_launches"]
            else:
                launches = c["reduce_launches"][name]
            entry.update({
                f"launches{sfx}": launches,
                f"max_abs_err{sfx}": r["max_abs_err"],
                f"ms{sfx}": r["ms"], f"ms_back_to_back{sfx}": r["ms_cuda"],
                f"plain_ms{sfx}": r["plain_ms"],
                f"bound_ms{sfx}": r["bound_ms"],
                f"bound_by{sfx}": r["bound_by"],
                f"library_ms{sfx}": None})
            if name in MAIN:
                rg = first(c["glv"])
                entry.update({
                    f"launches_glv{sfx}": runs_glv[logn][0][name],
                    f"ms_glv{sfx}": rg["ms"],
                    f"plain_ms_glv{sfx}": rg["plain_ms"],
                    f"bound_ms_glv{sfx}": rg["bound_ms"],
                    f"max_abs_err_glv{sfx}": rg["max_abs_err"]})
            if name in WIDE:
                entry[f"bound_ms_mont_mul_ops{sfx}"] = r[
                    "bound_ms_mont_mul_ops"]
            if name in ("pdbl_batch", "pbpr_stage1", "globalize"):
                entry[f"launched{sfx}"] = r["launched"]
            if name == "pdbl_batch":
                # the (3, L, Wp) sum that bucket_reduce doubles
                rw = c["main"]["pdbl_batch[Wp]"]
                entry.update({f"ms_Wp{sfx}": rw["ms"],
                              f"bound_ms_Wp{sfx}": rw["bound_ms"],
                              f"launched_Wp{sfx}": rw["launched"]})
            if name == "padd_batch":
                entry[f"launches_reduce{sfx}"] = c["reduce_launches"][name]
                entry[f"launched{sfx}"] = runs[logn][5]
                entry[f"ms_psub{sfx}"] = c["main"][
                    f"psub_batch[{torch.int32}->{torch.int16}]"]["ms"]
            if name == "pbpr_full":
                # as the user call launched it (kernels.LAUNCHED)
                entry[f"launched{sfx}"] = runs[logn][4]
                entry[f"launched_glv{sfx}"] = runs_glv[logn][4]
            if name == "prefix_scan":
                for key, sw, run in (
                        ("", c["scan_sweep"], runs[logn]),
                        ("_glv", c["scan_sweep_glv"], runs_glv[logn])):
                    entry[f"threads_per_lane{key}{sfx}"] = run[3]
                    entry[f"ms_by_threads_per_lane{key}{sfx}"] = sw["ms"]
        if name in MAIN:
            # the sharded path's launches at 2^SHARDED_LOGN: the one NCCL
            # rank's and each gloo rank's
            nccl, gloo = shard_run["nccl"], shard_run["gloo"]
            entry["launches_sharded"] = {
                f"x=1 {nccl['backend']}": nccl["launches"].get(name, 0),
                **{f"{k} gloo": [r["launches"].get(name, 0)
                                 for r in v["ranks"]]
                   for k, v in gloo.items()}}
            # against its plain version at every shape of the sharded
            # path: the shards, the ranks' spans and the trees
            entry["max_abs_err_sharded"] = max(
                r["max_abs_err"] for r in sharded_compares(shard_run)
                if r["name"] == name)
        if name == "padd_batch":
            # of which the halving tree's
            entry["launches_sharded_tree"] = {
                f"x=1 {nccl['backend']}": nccl["tree_launches"],
                **{f"ndev={d} check": t["launches"]
                   for d, t in shard_run["reduce_tree"].items()},
                **{f"{k} gloo": [r["tree_launches"] for r in v["ranks"]]
                   for k, v in gloo.items()}}
        # depth floors at the largest size: the least time of the chain of
        # dependent point operations, each on a warp with nothing to wait for
        if name == "col_prefix":
            levels = max(default_config(1 << max(SIZES), CURVE
                                        ).columns.bit_length() - 1, 1)
            entry["depth_floor_ms"] = levels * lat["col_prefix_level_ms"]
        if name == "pbpr_full":
            # (Bt + 1) stage-1 steps, 2 log2 T scan levels, log2 Bt
            # doublings and one add, each taken as one stage-1 step
            cfg = default_config(1 << max(SIZES), CURVE)
            T = cfg.pbpr_threads
            Bt = cfg.half_columns // T
            depth = (Bt + 1 + 2 * (T.bit_length() - 1)
                     + Bt.bit_length() - 1 + 1)
            entry["depth_floor_ms"] = depth * lat["pbpr_step_ms"]
        if name == "pbpr_stage1":
            # Bt + 1 steps, the m and g chains one step apart
            cfg = default_config(1 << max(SIZES), CURVE)
            Bt = cfg.half_columns // min(cfg.pbpr_threads, cfg.half_columns)
            entry["depth_floor_ms"] = (Bt + 1) * lat["pbpr_stage1_step_ms"]
        if name == "pdbl_batch":
            # the (3, L, Wp) shape: one doubling, on a lone warp
            entry["depth_floor_ms_Wp"] = lat["pdbl_one_warp_ms"]
        if name == "prefix_scan":
            for key, run in (("", runs), ("_glv", runs_glv)):
                R = (2 if key else 1) * (1 << max(SIZES)) // default_config(
                    1 << max(SIZES), CURVE).columns
                entry[f"depth_floor_ms{key}"] = (
                    R * lat["scan_step_ms"][run[max(SIZES)][3]])
        entry["bit_exact"] = True
        entry["at"] = f"n=2^{max(SIZES)} (suffix _2p16: n=2^16)"
        entry["profiles"] = {c: profile_entry(name, prof)
                             for c, prof in profiles.items()}
        entries.append(entry)
    pick = lambda d, i: {f"2^{k}": v[i] for k, v in d.items()}
    print(f"[total] chip_smoke wall time {time.perf_counter() - t_start:.1f} s"
          f" [{card}]", flush=True)
    print(json.dumps({
        "kernels": entries,
        "msm_ms": pick(runs, 1), "h2d_ms": pick(runs, 2),
        "msm_glv_ms": pick(runs_glv, 1), "h2d_glv_ms": pick(runs_glv, 2),
        "bucket_reduce_ms": {f"2^{k}": v["reduce_ms"]
                             for k, v in checks.items()},
        "apply_glv_ms": {f"2^{k}": v["apply_glv_ms"]
                         for k, v in checks.items()},
        "to_affine_ms": {f"2^{min(SIZES)}": affine_ms},
        "schedule": {**SCHEDULE, "msm_ms": sched_ms,
                     "launches": sched_launches},
        "latency_32_lanes": lat, "scan_by_lanes": lanes_ms,
        "pbpr_full_edges": checks[max(SIZES)]["pbpr_edges"],
        "rest_ms": {f"2^{k}": v for k, v in rests.items()},
        "ptxas": resources, "sass": sass,
        "sharded": shard_run,
        "profiles": {c: dict(
            msm_ms={f"2^{k}": v[1] for k, v in prof["runs"].items()},
            h2d_ms={f"2^{k}": v[2] for k, v in prof["runs"].items()},
            msm_glv_ms=prof["glv"][1] if "glv" in prof else None,
            to_affine_ms=prof.get("affine_ms"),
            bucket_reduce_ms={f"2^{k}": v["reduce_ms"]
                              for k, v in prof["nine"].items()},
            seconds=prof["seconds"]) for c, prof in profiles.items()},
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
