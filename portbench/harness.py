"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the metrics that `BENCHMARK.json` names for the cell.

Everything that belongs to one configuration, cell or metric is a file
found by its name under the benchmark's folder: `configs/<config>.json`,
`workloads/<cell>.json` and `metrics/<metric>.py` (a `read(run)`
function that returns a number, or None where it finds nothing to
read). A new cell or metric is a new file and an entry in
`BENCHMARK.json`.

The timed path is the port's user call on resident bases and host
scalars, `pipe.horner(pipe.window_sums(xs, ys, halfwords))`, one caller
in a closed loop. Every call of the window is compared with the
reference's MSM of its scalar set once the window has closed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

import reference
import tracefile
import traffic
import work

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# A traced run profiles the window's first calls: at least this many, for
# at least TRACE_SECONDS, then runs the rest of the window untraced.
TRACE_SECONDS = 2.0
TRACE_MIN_CALLS = 8
# The log gives the mean call of each stretch of this many seconds of the
# window, so that drift inside a run shows beside the spread across runs.
BLOCK_SECONDS = 5.0


@dataclasses.dataclass
class Run:
    """What a metric reader gets."""

    workload: dict
    config: dict
    setup_s: float
    call_s: List[float]                # each call of the window, seconds
    window_s: float                    # first call's start to last's end
    launches: int                      # kernel launches over the window
    peak_window_bytes: int             # device peak within the window
    bound_ms: float                    # least time of one call (work.py)
    trace: Optional[tracefile.Trace]   # the traced stretch, --trace 1


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics of `cell` in a run: per-layer with --trace 1,
    end-to-end without; those that list cells only where they list it."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(bench_dir: str, name: str, run: Run):
    path = os.path.join(bench_dir, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(run)


def msm_call(pipe, inputs: traffic.Inputs) -> Callable:
    """The timed path: one MSM on the resident bases and the scalar set
    `hw`, its result an (x, y, z) Jacobian int tuple on the host."""
    rf = torch.profiler.record_function

    def call(hw):
        with rf("bench.msm"):
            with rf("bench.window_sums"):
                sums = pipe.window_sums(inputs.xs, inputs.ys, hw)
            with rf("bench.horner"):
                return pipe.horner(sums)
    return call


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", bench_dir: str = BENCH_DIR,
        spec: Optional[dict] = None, t0: Optional[float] = None,
        make_call: Callable = msm_call, log=print) -> dict:
    """Run `cell` once; returns the result line as a dict. `make_call`
    builds the timed call from the pipeline and the inputs (the
    control and the faults of `control.py` put theirs in its place)."""
    import tpu_msm_torch
    from tpu_msm_torch.config import static_config
    from tpu_msm_torch.cuzk import kernels

    t0 = time.perf_counter() if t0 is None else t0
    spec = spec or load_json(os.path.join(os.path.dirname(bench_dir),
                                          "BENCHMARK.json"))
    wl = load_json(os.path.join(bench_dir, "workloads", cell + ".json"))
    cfg = load_json(os.path.join(bench_dir, "configs",
                                 wl["config"] + ".json"))
    if (wl.get("callers"), wl.get("loop")) != (1, "closed"):
        raise ValueError(f"{cell}: the harness drives one caller in a "
                         "closed loop")
    if cfg.get("n") not in (None, wl["n"]):
        raise ValueError(f"{cell}: n={wl['n']} is not its configuration's "
                         f"n={cfg['n']}")
    curve = reference.Curve.from_config(cfg)
    profile = getattr(tpu_msm_torch.constants, cfg["profile"])
    if (profile.p, profile.scalar_modulus) != (curve.p, curve.r) or (
            profile.num_limbs, profile.log_limb_size) != (
            cfg["num_limbs"], cfg["limb_bits"]):
        raise ValueError(f"{cfg['name']}: profile {cfg['profile']} is not "
                         "the configuration's curve and limbs")
    dev = torch.device(device)
    n = wl["n"]

    # ---- set-up: the pipeline, the inputs, every shape warmed ----
    msm_cfg = tpu_msm_torch.default_config(n, profile)
    if msm_cfg != static_config(n, profile):
        raise RuntimeError(f"{cell}: default_config is not the static "
                           f"schedule ({msm_cfg}); an autotune cache was read")
    marks = [("imports", time.perf_counter())]
    pipe = tpu_msm_torch.get_pipeline(msm_cfg, dev)
    marks.append(("pipeline", time.perf_counter()))
    inputs = traffic.make_inputs(curve, cfg, wl, seed, dev)
    _sync(dev)
    marks.append(("inputs", time.perf_counter()))
    call = make_call(pipe, inputs)
    for hw in inputs.scalar_sets:
        call(hw)
    _sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    phases = ", ".join(f"{name} {t - prev:.3f}" for (name, t), prev in
                       zip(marks, [t0] + [t for _, t in marks]))
    log(f"[set-up] {setup_s:.3f} s ({phases}): {cell} n={n} "
        f"{msm_cfg.curve.name} s={msm_cfg.window_size} C={msm_cfg.columns} "
        f"T={msm_cfg.pbpr_threads} Wg={msm_cfg.subtask_group} "
        f"pass={msm_cfg.max_points_per_pass}")

    # ---- the window ----
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    prof, stopped, trace_path, traced_calls = None, None, None, 0
    if traced:
        trace_dir = os.path.join(tempfile.gettempdir(), "portbench")
        os.makedirs(trace_dir, exist_ok=True)
        trace_path = os.path.join(trace_dir, f"{cell}.trace.json")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    sets = len(inputs.scalar_sets)
    launches0 = sum(kernels.LAUNCHES.values())
    records = []           # (set, start, end, result or None, error or None)
    if prof is not None:
        prof.start()
    t_start = time.perf_counter()
    while True:
        k = len(records) % sets
        t1 = time.perf_counter()
        try:
            res, err = call(inputs.scalar_sets[k]), None
        except Exception:  # a call that raises is a failed call
            res, err = None, traceback.format_exc()
        t2 = time.perf_counter()
        records.append((k, t1, t2, res, err))
        if prof is not None and (t2 - t_start >= TRACE_SECONDS
                                 and len(records) >= TRACE_MIN_CALLS
                                 or t2 - t_start >= seconds):
            _sync(dev)
            prof.stop()
            prof, stopped, traced_calls = None, prof, len(records)
        if t2 - t_start >= seconds:
            break
    window_s = records[-1][2] - t_start
    call_ms = [(t2 - t1) * 1e3 for _, t1, t2, _, _ in records]
    ms = sorted(call_ms)
    log(f"[window] {window_s:.3f} s, {len(records)} calls; ms a call: "
        f"min {ms[0]:.3f}, median {ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f}; "
        f"first four {[round(t, 3) for t in call_ms[:4]]}")
    blocks: Dict[int, List[float]] = {}
    for (_, _, t2, _, _), t in zip(records, call_ms):
        blocks.setdefault(int((t2 - t_start) // BLOCK_SECONDS), []).append(t)
    log(f"[blocks] mean ms a call by {BLOCK_SECONDS:g} s: "
        f"{[round(sum(v) / len(v), 3) for _, v in sorted(blocks.items())]}")
    launches = sum(kernels.LAUNCHES.values()) - launches0
    peak_window = 0
    if dev.type == "cuda":
        peak_window = torch.cuda.max_memory_allocated(dev)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")

    # ---- free the program's state, then the reference ----
    base_points = inputs.bases
    scalar_sets = inputs.scalar_sets
    del call, inputs, pipe
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    expected = [reference.expected_msm(
        curve, base_points, hs.view(torch.int16).numpy().view("<u2"))
        for hs in scalar_sets]
    mismatched = raised = 0
    first_error = None
    for k, _, _, res, err in records:
        if err is not None:
            raised += 1
            first_error = first_error or err
        elif curve.from_jacobian(*res) != expected[k]:
            mismatched += 1
    log(f"[reference] {time.perf_counter() - t_ref:.3f} s for {sets} sets")
    if first_error:
        log(f"[raised] first of {raised}:\n{first_error}")

    # ---- metrics ----
    passes = -(-n // msm_cfg.max_points_per_pass)
    H = traffic.halfword_rows(curve.r) + 2
    ops = work.msm_ops(n, msm_cfg.num_windows, msm_cfg.half_columns, passes,
                       cfg["num_limbs"], cfg["limb_bits"])
    nbytes = work.msm_bytes(n, cfg["num_limbs"], H, msm_cfg.num_windows)
    bound, by = work.bound_ms(ops, nbytes)
    trace = None
    if stopped is not None:
        stopped.export_chrome_trace(trace_path)
        trace = tracefile.load(trace_path)
        log(f"[trace] {trace_path}: {len(trace.calls)} of {traced_calls} "
            f"calls")
    rec = Run(workload=wl, config=cfg, setup_s=setup_s,
              call_s=[t2 - t1 for _, t1, t2, _, _ in records],
              window_s=window_s, launches=launches,
              peak_window_bytes=peak_window, bound_ms=bound, trace=trace)
    log(f"[work] {ops} int32 op, {nbytes} B a call: bound {bound:.4f} ms "
        f"by {by}; {passes} pass(es), W={msm_cfg.num_windows}, "
        f"B={msm_cfg.half_columns}")
    metrics: Dict[str, dict] = {}
    for m in cell_metrics(spec, cell, traced):
        value = read_metric(bench_dir, m["name"], rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    attempted, failed = len(records), mismatched + raised
    result = {"correct": attempted > 0 and failed == 0,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": wl["chips"],
                         "memory_peak_bytes": max(setup_peak, peak_window)}}
    if trace is not None and trace.calls:
        result["device"]["busy_s"] = trace.busy_us() * 1e-6
        result["device"]["window_s"] = trace.window_us() * 1e-6
        idle: Dict[str, float] = {}
        for label, (s, e) in trace.idle_gaps():
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in
                           trace.device_seconds_by_name()[:10]],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
    result["compared"] = {
        "mismatched_calls": {"value": mismatched, "limit": 0},
        "raised_calls": {"value": raised, "limit": 0}}
    return result
