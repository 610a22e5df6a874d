"""Tests of the benchmark harness. They run on the CPU; a test that needs
the CUDA card is marked `card` and skips where there is none, which is
decided inside the test (the `card` fixture), never at import.

    python -m pytest portbench/tests -q
"""

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [ROOT, BENCH_DIR]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on the CPU")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")


def tiny_config() -> dict:
    """A configuration of the port's 62-bit test curve, TINY62: the same
    code paths as BN254 at 6 limbs, fast enough for the CPU."""
    from tpu_msm_torch.constants import TINY62 as c
    return {"name": "tiny62", "source": "tpu_msm_torch.constants.TINY62",
            "profile": "TINY62",
            "curve": {"p": hex(c.p), "r": hex(c.scalar_modulus),
                      "b": hex(c.b_coeff), "gen_x": hex(c.gen_x),
                      "gen_y": hex(c.gen_y)},
            "num_limbs": c.num_limbs, "limb_bits": c.log_limb_size}


TINY_CELL = {"name": "tiny62.msm_2p8", "config": "tiny62",
             "traffic": "msm_2p8", "n": 256, "k_base": 15,
             "scalar_sets": 4, "callers": 1, "loop": "closed", "chips": 1,
             "why": "a CPU-sized cell of the test curve"}


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark's folder with the TINY62 configuration and
    cell added as files, and the spec with the cell in it: (folder,
    spec)."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "configs" / "tiny62.json").write_text(json.dumps(tiny_config()))
    (bench / "workloads" / "tiny62.msm_2p8.json").write_text(
        json.dumps(TINY_CELL))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({k: TINY_CELL[k] for k in
                              ("name", "config", "traffic", "chips", "why")})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY_CELL["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(bench), spec
