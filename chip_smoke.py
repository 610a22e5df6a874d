#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card's name and power limit; require CUDA;
  2. build the kernels of tpu_msm_torch/csrc (timed as set-up);
  3. per kernel, at the shapes its path gives it for BN254_S12 at 2^16
     and 2^20 (captured from a warm-up run of the device program, without
     GLV and with it): the CUDA kernel against its plain PyTorch version
     on the same CUDA inputs, bit-identical, with times from CUDA events.
     The six kernels of the main path at both configurations;
     `pbpr_stage1` on the buckets `pbpr_full` received; `pdbl_batch` on
     one (3, L, Wg, B+1) batch and on the (3, L, Wp) sum that
     `bucket_reduce` doubles; `globalize` on the first window group's
     scan output and column prefix;
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
     the same way, and `apply_glv` timed alone;
  8. affine output: `to_affine` on the window sums of the 2^16 runs
     (without GLV, and with it, where two pad windows are at infinity)
     against the host decode;
  9. one JSON line {"kernels": [...]} with all nine kernels;
 10. last line {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpu_msm_torch import _build, to_affine  # noqa: E402
from tpu_msm_torch.config import default_config  # noqa: E402
from tpu_msm_torch.constants import BN254_S12  # noqa: E402
from tpu_msm_torch.cuzk import glv as glv_dev  # noqa: E402
from tpu_msm_torch.cuzk import kernels  # noqa: E402
from tpu_msm_torch.cuzk import pbpr  # noqa: E402
from tpu_msm_torch.cuzk import pipeline_cuda  # noqa: E402
from tpu_msm_torch.cuzk.pipeline import (get_pipeline,  # noqa: E402
                                         tpu_variable_base_msm)
from tpu_msm_torch.reference import curve as ref  # noqa: E402
from tpu_msm_torch.utils import preprocess  # noqa: E402

CURVE = BN254_S12
SIZES = (16, 20)
DEVICE = "cuda"   # a rehearsal without a card sets "cpu" and tiny SIZES
MAIN = ("encode_mont", "decompose_digits", "prefix_scan", "col_prefix",
        "padd_batch", "pbpr_full")
KERNELS = MAIN + ("pdbl_batch", "pbpr_stage1", "globalize")
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


def bound_ms(nbytes: int, ops: int):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / INT32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def work(name: str, args, out) -> tuple:
    """(bytes moved, int32 operations) of one call: each input read once,
    each output written once; operations from the shapes."""
    L = CURVE.num_limbs
    mm = mont_mul_ops(L)
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
        _, _, Wp, B = args[0].shape
        T = min(args[2], B)
        bits = max(T.bit_length() - 1, 0)
        dbl = max((B // T).bit_length() - 1, 0)
        ops = Wp * ((2 * B + 4 * T * bits + 1) * MULS["padd"]
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
    every (module, name) in `targets`, tensors cloned; padd_batch is kept
    once per dtype form."""
    orig = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def call(*args, **kw):
            key = name
            if name == "padd_batch":
                od = kw.get("out_dtype", args[3] if len(args) > 3 else
                            torch.int32)
                key = f"padd_batch[{args[0].dtype}->{od}]"
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


def inputs(logn: int):
    """(xs, ys, hw, base, oracle result) of one size, made once."""
    if logn not in _INPUTS:
        xs, ys, hw, base = preprocess.gen_planar_inputs(
            CURVE, 1 << logn, seed=99, k_base=64)
        _INPUTS[logn] = (xs, ys, hw, base,
                         preprocess.expected_msm(base, hw, CURVE))
    return _INPUTS[logn]


def config(logn: int, glv: bool):
    return dataclasses.replace(default_config(1 << logn, CURVE), glv=glv)


def capture_inputs(logn: int, glv: bool) -> dict:
    """Run the device program once and keep the first call of every
    kernel wrapper of the main path, of `boundary_positions` and, under
    GLV, of `apply_glv`."""
    n = 1 << logn
    xs, ys, hw, _, _ = inputs(logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    dev = torch.device(DEVICE)
    targets = [(kernels, k) for k in MAIN]
    targets += [(pipeline_cuda, "boundary_positions"), (glv_dev, "apply_glv")]
    with spy({}, targets) as seen:
        pipeline_cuda.windows_device(
            torch.from_numpy(xs.astype(np.int32)).to(dev),
            torch.from_numpy(ys.astype(np.int32)).to(dev),
            torch.from_numpy(hw.astype(np.int32)).to(dev), config(logn, glv))
        torch.cuda.synchronize()
    return seen


def compare(key: str, name: str, args, kw, tag: str, card: str, reps: int
            ) -> dict:
    """One kernel against its plain version on the same CUDA inputs."""
    kern = getattr(kernels, name)
    plain = getattr(kernels, name + "_plain")
    got = kern(*args, **kw)
    plain(*args, **kw)          # warm-up: fills the cached constant tensors
    want, plain_ms = timed_once(lambda: plain(*args, **kw))
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(as_tuple(got), as_tuple(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{key}: shape/dtype {g.shape} {g.dtype}"
                                 f" vs plain {w.shape} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)
                            ).abs().max()))
    if err:
        raise AssertionError(f"{key} at {tag}: kernel differs from its "
                             f"plain version (max abs err {err})")
    t = cuda_ms(lambda: kern(*args, **kw), reps)
    nbytes, ops = work(name, args, got)
    b_ms, b_by = bound_ms(nbytes, ops)
    shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    print(f"[kernel] {key} {tag} in={shape} "
          f"out={[tuple(o.shape) for o in as_tuple(got)]} "
          f"ms={t:.4f} plain_ms={plain_ms:.1f} bound_ms={b_ms:.4f} "
          f"({b_by}) bit-identical max_abs_err={err} [{card}]", flush=True)
    return dict(name=name, ms=t, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)


def check_main_kernels(seen: dict, tag: str, card: str, reps: int) -> dict:
    """Phase 3 for the six kernels of the main path."""
    results = {key: compare(key, name, args, kw, tag, card, reps)
               for key, (name, args, kw, _) in seen.items() if name in MAIN}
    missing = set(MAIN) - {r["name"] for r in results.values()}
    if missing:
        raise AssertionError(f"kernels never called at {tag}: {missing}")
    return results


def first_group(seen: dict):
    """(T, S) of the first window group: the scan output (3, L, R, F) and
    the column prefix flattened to (3, L, F)."""
    tbuf = seen["prefix_scan"][3][0]
    S = seen["col_prefix"][3][0]
    return tbuf, S.reshape(3, CURVE.num_limbs, tbuf.shape[3])


def reduction_path(seen: dict, logn: int, card: str, full_ms: float):
    """Phase 4 at one size. Returns the launch counts of the path and the
    (3, L, Wp) sum that the path hands to `pdbl_batch`."""
    cfg = config(logn, False)
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
        if not ref.jac_eq(CURVE, a, b):
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
    print(f"[reduce] n=2^{logn} bucket_reduce (3, L, {buckets.shape[2]}, "
          f"{buckets.shape[3]}) T={cfg.pbpr_threads}: equal in the group to "
          f"pbpr_full in all {len(want)} windows; median {ms:.2f} ms of "
          f"{[round(t, 2) for t in times]} against pbpr_full {full_ms:.2f} ms;"
          f" launches={used} [{card}]", flush=True)
    return launches, ms, dbl["pdbl_batch"][1][0]


def globalise_check(seen: dict, logn: int, card: str) -> int:
    """Phase 5 at one size. Returns the launches it made (one)."""
    cfg = config(logn, False)
    tbuf, S = first_group(seen)
    L, Wg = CURVE.num_limbs, cfg.subtask_group
    jt = seen["boundary_positions"][3][2][:Wg].long()
    want = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    kernels.reset_launches()
    G = kernels.globalize(tbuf, S, CURVE)
    got = G.reshape(3, L, -1)[:, :, jt]
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["globalize"]
    if launches == 0:
        raise AssertionError(f"2^{logn}: globalize was not launched")
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"2^{logn}: globalize(T, S) at the region ends "
                             "differs from the main path's G")
    print(f"[globalise] n=2^{logn} globalize(T {tuple(tbuf.shape)}, "
          f"S {tuple(S.shape)}) at the {tuple(jt.shape)} region ends: "
          f"bit-identical to the main path's G [{card}]", flush=True)
    return launches


def check_size(logn: int, card: str):
    """Phases 3 to 5 at one size."""
    reps = 5 if logn < 20 else 3
    cfg = config(logn, False)
    seen = capture_inputs(logn, False)
    tag = f"n=2^{logn}"
    results = check_main_kernels(seen, tag, card, reps)
    tbuf, S = first_group(seen)
    buckets = seen["pbpr_full"][1][0]
    gall = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    results["pbpr_stage1"] = compare(
        "pbpr_stage1", "pbpr_stage1",
        (buckets, CURVE, min(cfg.pbpr_threads, cfg.half_columns)), {}, tag,
        card, reps)
    results["globalize"] = compare("globalize", "globalize",
                                   (tbuf, S, CURVE), {}, tag, card, reps)
    results["pdbl_batch[Wg,B+1]"] = compare(
        "pdbl_batch[Wg,B+1]", "pdbl_batch", (gall, CURVE), {}, tag, card, reps)
    red = reduction_path(seen, logn, card, results["pbpr_full"]["ms"])
    results["pdbl_batch[Wp]"] = compare(
        "pdbl_batch[Wp]", "pdbl_batch", (red[2], CURVE), {}, tag, card, reps)
    glob = globalise_check(seen, logn, card)

    del seen, tbuf, S, buckets, gall
    torch.cuda.empty_cache()
    seen = capture_inputs(logn, True)
    results_glv = check_main_kernels(seen, f"n=2^{logn} glv", card, reps)
    _, args, kw, _ = seen["apply_glv"]
    glv_ms = cuda_ms(lambda: glv_dev.apply_glv(*args, **kw), reps)
    print(f"[apply_glv] n=2^{logn}: {glv_ms:.2f} ms for "
          f"{args[0].shape[1]} points (torch ops and 2 decompose_digits "
          f"launches) [{card}]", flush=True)
    del seen
    torch.cuda.empty_cache()
    return dict(main=results, glv=results_glv, reduce_launches=red[0],
                reduce_ms=red[1], globalize_launches=glob, apply_glv_ms=glv_ms)


def main_path(logn: int, card: str, glv: bool = False):
    """Phase 6 (or, with glv, phase 7) at one size. Returns the launch
    counts of the user call and the timings."""
    n = 1 << logn
    cfg = config(logn, glv)
    pipe = get_pipeline(cfg, DEVICE)
    xs, ys, hw, base, want = inputs(logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    label = "msm-glv" if glv else "msm"

    kernels.reset_launches()
    t0 = time.perf_counter()
    got = tpu_variable_base_msm(points, scalars, curve=CURVE, device=DEVICE,
                                config=cfg if glv else None)
    t_user = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not ref.jac_eq(CURVE, got, want):
        raise AssertionError(f"2^{logn} {label}: MSM result differs from "
                             "the oracle")
    idle = [k for k in MAIN if launches[k] == 0]
    if idle:
        raise AssertionError(f"2^{logn} {label}: kernels not launched: {idle}")
    used = {k: v for k, v in launches.items() if v}
    print(f"[{label}] n=2^{logn} tpu_variable_base_msm EXACT in {t_user:.2f} s"
          f" (host pack included) launches={used} [{card}]", flush=True)

    # bench-style timing: int16/uint16 wire inputs, staged h2d timed apart
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
        if not ref.jac_eq(CURVE, acc, want):
            raise AssertionError(f"2^{logn} {label}: timed run differs from "
                                 "the oracle")
        h2ds.append((t1 - t0) * 1e3)
        times.append((t2 - t1) * 1e3)
    ms, h2d = statistics.median(times), statistics.median(h2ds)
    lanes = (2 if glv else 1) * n
    print(f"[{label}] n=2^{logn} s={cfg.window_size} W={cfg.num_windows} "
          f"groups={cfg.num_groups} stream={lanes} lanes C={cfg.columns} "
          f"T={cfg.pbpr_threads} Wg={cfg.subtask_group}: device+decode+"
          f"horner median {ms:.2f} ms of {[round(t, 2) for t in times]}, "
          f"h2d {h2d:.2f} ms, EXACT [{card}]", flush=True)
    return launches, ms, h2d


def where_line(label: str, logn: int, launches: dict, results: dict,
               total_ms: float, card: str, extra: str = "") -> None:
    """launches x kernel time (padd_batch: mean of its two dtype forms)."""
    per = {name: launches[name] * statistics.mean(
        r["ms"] for r in results.values() if r["name"] == name)
        for name in MAIN}
    print(f"[{label}] n=2^{logn}: " + ", ".join(
        f"{k} {v:.2f}" for k, v in per.items()) + f" ms; kernels "
        f"{sum(per.values()):.2f} of {total_ms:.2f} ms end to end{extra} "
        f"[{card}]", flush=True)


def affine_check(logn: int, card: str, glv: bool) -> float:
    """Phase 8: `to_affine` on the card against the host decode."""
    n = 1 << logn
    cfg = config(logn, glv)
    pipe = get_pipeline(cfg, DEVICE)
    xs, ys, hw, _, _ = inputs(logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    g = pipeline_cuda.windows_device(
        *(torch.from_numpy(a.astype(np.int32)).to(DEVICE)
          for a in (xs, ys, hw)), cfg)
    want = pipe._decode_windows(g)
    (ax, ay, inf), ms = timed_once(lambda: to_affine(g, CURVE))
    if ax.device != g.device or ax.shape != g.shape[1:]:
        raise AssertionError("to_affine: wrong device or shape")
    w = CURVE.log_limb_size
    vals = lambda t: [CURVE.from_mont(sum(int(v) << (w * i) for i, v in
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
    print(f"[affine] n=2^{logn}{' glv' if glv else ''} to_affine on the "
          f"(3, L, {g.shape[2]}) window sums ({g.shape[2] - len(want)} pad "
          f"windows at infinity): equal to the host decode in all {len(want)} windows, "
          f"infinity masks agree; {ms:.1f} ms [{card}]", flush=True)
    return ms


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

    checks = {logn: check_size(logn, card) for logn in SIZES}
    runs = {logn: main_path(logn, card) for logn in SIZES}
    runs_glv = {logn: main_path(logn, card, glv=True) for logn in SIZES}
    affine_ms = affine_check(min(SIZES), card, glv=False)
    affine_check(min(SIZES), card, glv=True)

    for logn in SIZES:
        where_line("where", logn, runs[logn][0], checks[logn]["main"],
                   runs[logn][1], card)
        where_line("where-glv", logn, runs_glv[logn][0], checks[logn]["glv"],
                   runs_glv[logn][1], card,
                   f"; apply_glv {checks[logn]['apply_glv_ms']:.2f} ms")

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
                f"ms{sfx}": r["ms"], f"plain_ms{sfx}": r["plain_ms"],
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
            if name == "padd_batch":
                entry[f"launches_reduce{sfx}"] = c["reduce_launches"][name]
        entry["bit_exact"] = True
        entry["at"] = f"n=2^{max(SIZES)} (suffix _2p16: n=2^16)"
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
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
