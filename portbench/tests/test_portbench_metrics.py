"""Each metric reader, on a small synthetic Chrome trace and run."""

import importlib.util
import json
import os

import pytest

import harness
import tracefile
from conftest import BENCH_DIR


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def synthetic_events():
    """Two calls of 100 us. Call 1: head 10 us, a copy 10..20, kernels
    20..50 and 40..60 (overlapping), a copy 70..75, tail 25 us. Call 2
    (starts at 120): head 5, kernel 125..185, tail 35."""
    out = []
    for start in (0, 120):
        out.append(ev("user_annotation", "bench.msm", start, 100))
        out.append(ev("user_annotation", "bench.window_sums", start + 1, 80))
        out.append(ev("user_annotation", "bench.horner", start + 82, 17))
        out.append(ev("cpu_op", "aten::empty", start + 2, 1))
    out += [ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10, 10),
            ev("kernel", "void (anonymous namespace)::prefix_scan_kernel"
               "<22, 12, 2>(short const*, int)", 20, 30),
            ev("kernel", "col_prefix_kernel", 40, 20),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 70, 5),
            ev("kernel", "void (anonymous namespace)::prefix_scan_kernel"
               "<22, 12, 2>(short const*, int)", 125, 60),
            {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5}]
    return out


@pytest.fixture
def trace():
    return tracefile.parse(synthetic_events())


def make_run(trace=None, **kw):
    args = dict(workload={}, config={}, setup_s=9.5,
                call_s=[0.010] * 190 + [0.020] * 10, window_s=2.5,
                launches=10400, peak_window_bytes=3 * 2**29, bound_ms=0.015,
                trace=trace)
    args.update(kw)
    return harness.Run(**args)


def read(name, run):
    return harness.read_metric(BENCH_DIR, name, run)


def test_parse(trace):
    assert len(trace.calls) == 2
    assert [len(c.ops) for c in trace.calls] == [4, 1]
    assert trace.window == (0, 220)
    assert trace.busy() == [(10, 60), (70, 75), (125, 185)]
    assert trace.busy_us() == 115
    assert trace.device_seconds_by_name()[0] == (
        "prefix_scan_kernel<22, 12, 2>", pytest.approx(90e-6))
    assert dict(trace.device_seconds_by_name())[
        "Memcpy HtoD (Pinned -> Device)"] == pytest.approx(10e-6)


def test_idle_gaps_are_labelled(trace):
    gaps = trace.idle_gaps()
    assert gaps == [
        ("bench.msm:head", (0, 1)), ("bench.window_sums:head", (1, 10)),
        ("bench.window_sums", (60, 70)),
        ("bench.window_sums:tail", (75, 81)), ("bench.msm:tail", (81, 82)),
        ("bench.horner:tail", (82, 99)), ("bench.msm:tail", (99, 100)),
        ("between calls", (100, 120)),
        ("bench.msm:head", (120, 121)), ("bench.window_sums:head", (121, 125)),
        ("bench.window_sums:tail", (185, 201)), ("bench.msm:tail", (201, 202)),
        ("bench.horner:tail", (202, 219)), ("bench.msm:tail", (219, 220))]
    assert sum(e - s for _, (s, e) in gaps) + trace.busy_us() == 220


def test_host_head_and_tail(trace):
    run = make_run(trace)
    assert read("host_head_ms", run) == pytest.approx((10 + 5) / 2 * 1e-3)
    assert read("host_tail_ms", run) == pytest.approx((25 + 35) / 2 * 1e-3)


def test_device_idle_and_roofline(trace):
    run = make_run(trace)
    assert read("device_idle_pct", run) == pytest.approx(100 * 105 / 220)
    # 0.015 ms of least work against 115 us / 2 calls busy
    assert read("kernels_roofline", run) == pytest.approx(
        100 * 0.015 / 0.0575)


def test_end_to_end_readers():
    run = make_run()
    assert read("setup_s", run) == 9.5
    assert read("msm_ms", run) == pytest.approx(2.5 / 200 * 1e3)
    # nearest rank: the 190th of 200 sorted calls
    assert read("msm_ms_p95", run) == pytest.approx(10.0)
    assert read("msm_ms_p95", make_run(
        call_s=[0.010] * 189 + [0.020] * 11)) == pytest.approx(20.0)
    assert read("launches_per_msm", run) == 52
    assert read("peak_mem_gib", run) == 1.5


def test_readers_are_silent_with_nothing_to_read():
    run = make_run(call_s=[0.01] * 20, launches=0, peak_window_bytes=0)
    for name in ("host_head_ms", "host_tail_ms", "kernels_roofline",
                 "device_idle_pct", "msm_ms_p95", "launches_per_msm",
                 "peak_mem_gib"):
        assert read(name, run) is None, name
    idle = tracefile.parse([ev("user_annotation", "bench.msm", 0, 50)])
    assert read("kernels_roofline", make_run(idle)) is None
    assert read("device_idle_pct", make_run(idle)) is None


def test_every_metric_has_a_reader_and_unit():
    with open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")) as f:
        spec = json.load(f)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert "setup_s" in names
    for name in names:
        path = os.path.join(BENCH_DIR, "metrics", name + ".py")
        mod_spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        assert callable(mod.read), name
