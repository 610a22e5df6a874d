"""The port's tracing and timing helpers (`tpu_msm_torch/utils/profiling.py`)
on the CPU, against the JAX package's (`tpu_msm/utils/profiling.py`)."""

import json
import os

import pytest
import torch

from tpu_msm.utils import profiling as jprofiling
from tpu_msm_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as path:
        x = torch.arange(1 << 12, dtype=torch.int32)
        (x * x + 7).sum()
    assert os.path.dirname(path) == str(logdir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::mul" in n for n in names), sorted(names)[:20]


def test_trace_writes_even_if_the_body_raises(tmp_path):
    with pytest.raises(KeyError):
        with profiling.trace(str(tmp_path)) as path:
            torch.ones(3).sum()
            raise KeyError("boom")
    assert os.path.exists(path)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on a CUDA device."""

    index = 0

    @property
    def device(self):
        return torch.device("cuda", self.index)


def _fake(index):
    t = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(2))
    t.index = index
    return t


def test_block_walks_nested_structures(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    cpu = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": "text"}
    assert profiling.block(cpu) is cpu
    assert synced == []
    x = {"a": [_fake(0), (_fake(0), 1.5)], "b": {"c": _fake(1)},
         "d": [torch.ones(1)]}
    assert profiling.block(x) is x
    assert synced == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert profiling.block(7) == 7


@pytest.mark.parametrize("runs,warmup", [(3, 1), (5, 2), (1, 0)])
def test_device_ms_call_count(runs, warmup):
    calls = []

    def fn(a, b=0):
        calls.append((a, b))
        return [torch.ones(1)]

    ms = profiling.device_ms(fn, 1, runs=runs, warmup=warmup, b=2)
    assert len(calls) == runs + warmup and set(calls) == {(1, 2)}
    assert ms >= 0.0


def test_stage_timer_text_equals_jax():
    spans = [("pack", 12.345), ("window_sums", 7.5), ("horner", 0.004)]
    ours, theirs = profiling.StageTimer(), jprofiling.StageTimer()
    for name, ms in spans:
        ours.record(name, ms)
        theirs.record(name, ms)
    assert ours.table() == theirs.table()
    assert ours.json() == theirs.json()
    assert ours.total() == theirs.total()
    empty = profiling.StageTimer()
    assert empty.table() == jprofiling.StageTimer().table()
    with ours.span("more"):
        pass
    assert ours.spans[-1]["name"] == "more" and ours.spans[-1]["ms"] >= 0
