"""What a traced run reads from torch.profiler's Chrome trace: the
harness's own spans and the device's operations, call by call.

The harness opens `bench.msm` around each call and `bench.window_sums`
and `bench.horner` inside it (`record_function`, category
"user_annotation"). A device operation is a kernel, a copy or a memset
(categories "kernel", "gpu_memcpy", "gpu_memset"). Calls run one after
another and each ends with its result on the host, so every device
operation of a call starts and ends inside its `bench.msm` span.
Times in the trace are microseconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("bench.msm", "bench.window_sums", "bench.horner")

Interval = Tuple[float, float]


@dataclasses.dataclass
class Call:
    span: Interval                   # bench.msm
    ops: List[Tuple[str, Interval]]  # its device operations, by start

    @property
    def head_us(self):
        """From the span's start to its first device operation's."""
        return self.ops[0][1][0] - self.span[0] if self.ops else None

    @property
    def tail_us(self):
        """From its last device operation's end to the span's end."""
        if not self.ops:
            return None
        return self.span[1] - max(end for _, (_, end) in self.ops)


@dataclasses.dataclass
class Trace:
    calls: List[Call]
    spans: Dict[str, List[Interval]]

    @property
    def window(self) -> Interval:
        return self.calls[0].span[0], self.calls[-1].span[1]

    def busy(self) -> List[Interval]:
        """The union of the device operations' intervals in the window."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for c in self.calls
                     for _, (s, e) in c.ops if e > lo and s < hi)
        out: List[Interval] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def window_us(self) -> float:
        lo, hi = self.window
        return hi - lo

    def idle_gaps(self) -> List[Tuple[str, Interval]]:
        """Each stretch of the window with no device operation, cut where
        a harness span starts or ends, labelled by what the host was in:
        the innermost harness span, with ":head" before the call's first
        device operation and ":tail" after its last, or "between
        calls"."""
        lo, hi = self.window
        cuts = sorted({t for ivs in self.spans.values() for iv in ivs
                       for t in iv})
        out, t = [], lo
        for s, e in self.busy() + [(hi, hi)]:
            if s > t:
                inner = cuts[bisect.bisect_right(cuts, t):
                             bisect.bisect_left(cuts, s)]
                for a, b in zip([t] + inner, inner + [s]):
                    out.append((self.label((a + b) / 2), (a, b)))
            t = max(t, e)
        return out

    def label(self, t: float) -> str:
        k = bisect.bisect_right([c.span[0] for c in self.calls], t) - 1
        if k < 0 or t > self.calls[k].span[1]:
            return "between calls"
        call = self.calls[k]
        name = "bench.msm"
        for inner in ("bench.window_sums", "bench.horner"):
            ivs = self.spans.get(inner, [])
            j = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if j >= 0 and ivs[j][0] <= t <= ivs[j][1]:
                name = inner
        if call.ops and t < call.ops[0][1][0]:
            return name + ":head"
        if call.ops and t > max(e for _, (_, e) in call.ops):
            return name + ":tail"
        return name

    def device_seconds_by_name(self) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = {}
        for c in self.calls:
            for name, (s, e) in c.ops:
                tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and
    parameters: `scan_kernel<22, 12, 2>`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0] if "(" in name else name


def parse(events: List[dict]) -> Trace:
    """Calls and spans from a Chrome trace's `traceEvents`."""
    spans: Dict[str, List[Interval]] = {name: [] for name in SPANS}
    ops: List[Tuple[str, Interval]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        iv = (s, s + float(ev.get("dur", 0.0)))
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev.get("name") in spans:
            spans[ev["name"]].append(iv)
        elif cat in DEVICE_CATS:
            name = ev.get("name", cat)
            ops.append((short_name(name) if cat == "kernel" else name, iv))
    for v in spans.values():
        v.sort()
    calls = [Call(iv, []) for iv in spans["bench.msm"]]
    starts = [c.span[0] for c in calls]
    for name, iv in sorted(ops, key=lambda o: o[1][0]):
        k = bisect.bisect_right(starts, iv[0]) - 1
        if k >= 0 and iv[0] <= calls[k].span[1]:
            calls[k].ops.append((name, iv))
    return Trace(calls, spans)


def load(path: str) -> Trace:
    with open(path) as f:
        return parse(json.load(f)["traceEvents"])
