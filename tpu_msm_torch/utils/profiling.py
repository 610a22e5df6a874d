"""Tracing and timing helpers.

The port of `tpu_msm/utils/profiling.py`:

  * `trace(logdir)`: a context manager around `torch.profiler` (CPU
    activity, and CUDA activity where a card is present) that writes a
    Chrome trace into `logdir`; every CUDA kernel of `csrc/` shows up in
    it by name, with its device time;
  * `block(x)`: wait for the device work behind every CUDA tensor of a
    nested structure;
  * `device_ms(fn, *args)`: median wall ms of a call, `block` around
    each run;
  * `StageTimer`: named spans, printed as a table or a JSON object.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, List

import torch

from .. import _build


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the body and write a Chrome trace (chrome://tracing,
    Perfetto) into `logdir` (default: trace/ in the build directory).
    Yields the path of the trace file, which exists once the body ends:

        with profiling.trace("traces") as path:
            pipe.msm(points, scalars)
    """
    logdir = logdir or str(_build.build_dir() / "trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()   # the body's kernels end inside
        prof.stop()
        prof.export_chrome_trace(path)


def block(x: Any) -> Any:
    """Wait for the device work behind every CUDA tensor in a nested
    structure of dicts, lists and tuples (a readback barrier); CPU
    tensors and other leaves need none. Returns x."""
    seen = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda" and v.device not in seen:
                seen.add(v.device)
                torch.cuda.synchronize(v.device)
        elif isinstance(v, dict):
            for item in v.values():
                walk(item)
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)

    walk(x)
    return x


def device_ms(fn: Callable, *args, runs: int = 3, warmup: int = 1,
              **kw) -> float:
    """Median wall ms of fn(*args) with block around each run."""
    for _ in range(warmup):
        block(fn(*args, **kw))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        block(fn(*args, **kw))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class StageTimer:
    """Structured per-stage timings: accumulate named spans, emit a table
    or a JSON object."""

    def __init__(self) -> None:
        self.spans: List[Dict[str, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.spans.append(
            {"name": name, "ms": (time.perf_counter() - t0) * 1e3})

    def record(self, name: str, ms: float) -> None:
        self.spans.append({"name": name, "ms": ms})

    def total(self) -> float:
        return sum(s["ms"] for s in self.spans)

    def table(self) -> str:
        width = max((len(s["name"]) for s in self.spans), default=4)
        lines = [f"{s['name']:<{width}}  {s['ms']:>10.2f} ms"
                 for s in self.spans]
        lines.append(f"{'total':<{width}}  {self.total():>10.2f} ms")
        return "\n".join(lines)

    def json(self) -> str:
        return json.dumps({"stages": self.spans,
                           "total_ms": self.total()})
