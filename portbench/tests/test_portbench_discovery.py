"""A configuration, a cell and a metric are added by adding files and
entries only: the harness finds each by its name."""

import json
import os

import harness


def test_new_config_cell_and_metric_are_found(tiny_bench):
    bench, spec = tiny_bench
    with open(os.path.join(bench, "metrics", "calls_in_window.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.call_s))\n")
    spec["end_to_end"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["tiny62.msm_2p8"]})
    res = harness.run("tiny62.msm_2p8", 2**31 + 7, 0.5, False, device="cpu",
                      bench_dir=bench, spec=spec, log=lambda m: None)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    m = res["metrics"]
    assert m["calls_in_window"] == {"value": float(res["attempted"]),
                                    "unit": "calls"}
    assert {"setup_s", "msm_ms", "calls_in_window"} <= set(m)
    assert "msm_ms_p95" not in m        # fewer than 200 calls: silent
    assert list(res)[-1] == "compared"
    assert res["compared"] == {"mismatched_calls": {"value": 0, "limit": 0},
                               "raised_calls": {"value": 0, "limit": 0}}


def test_cell_metrics_follow_the_workloads_lists():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, cell["name"],
                                                        False)}
        layer = {m["name"] for m in harness.cell_metrics(spec, cell["name"],
                                                          True)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        assert layer, cell["name"]
    # a cell that no list names gets only the metrics without a list
    assert [m["name"] for m in harness.cell_metrics(spec, "unlisted",
                                                     False)] == ["setup_s"]


def test_every_cell_and_config_has_its_file():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
    for w in spec["workloads"]:
        wl = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads",
                                            w["name"] + ".json"))
        assert {k: wl[k] for k in ("name", "config", "traffic", "chips",
                                   "why")} == w
