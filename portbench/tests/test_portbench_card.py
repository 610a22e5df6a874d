"""On the card: one short run of a cell through the command, correct,
with its metrics (5 s: over the 200 calls that `msm_ms_p95` needs at
2^18). Skipped on the CPU."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "bn254.msm_2p18",
         "--seed", str(2**31 + 21), "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    names = ({"host_head_ms", "kernels_roofline", "device_idle_pct"}
             if trace else {"setup_s", "msm_ms", "msm_ms_p95"})
    assert names <= set(res["metrics"])
    if trace:
        assert 0 < res["metrics"]["kernels_roofline"]["value"] < 100
        assert res["device"]["busy_s"] > 0
