"""The comparison catches the control and each fault a cell can have, in
a run driven whole on the CPU (the harness's look for a card skipped):
the reference with each scalar's lowest bit cleared in the program's
place, a call that returns the previous call's result, half of the
points left out, one limb of a window sum altered where the device
program writes it, and the bases read at an index cut to fewer bits or
shifted by a tile. The same run unbroken is correct."""

import pytest

import control
import harness
import reference
from conftest import tiny_config


def run_tiny(bench, spec, make_call=harness.msm_call, seed=2**31 + 99):
    return harness.run("tiny62.msm_2p8", seed, 0.6, False, device="cpu",
                       bench_dir=bench, spec=spec, make_call=make_call,
                       log=lambda m: None)


def test_unbroken_run_is_correct(tiny_bench):
    res = run_tiny(*tiny_bench)
    assert res["correct"] is True and res["failed"] == 0


@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_makes_the_run_incorrect(tiny_bench, fault, monkeypatch):
    # the tiny cell's 256 points: an index cut to 7 bits, not 16
    monkeypatch.setattr(control, "TRUNCATE_BITS", 7)
    curve = reference.Curve.from_config(tiny_config())
    res = run_tiny(*tiny_bench, make_call=control.make_call_for(fault, curve))
    assert res["correct"] is False
    mism = res["compared"]["mismatched_calls"]["value"]
    assert mism > res["compared"]["mismatched_calls"]["limit"]
    # every call of the window: the stale fault's first returns the last
    # warm-up call's result
    assert mism == res["attempted"]


def test_a_call_that_raises_is_failed(tiny_bench):
    def make_call(pipe, inputs):
        inner = harness.msm_call(pipe, inputs)
        count = []

        def call(hw):
            count.append(1)
            if len(count) > len(inputs.scalar_sets):     # after warm-up
                raise RuntimeError("planted")
            return inner(hw)
        return call
    res = run_tiny(*tiny_bench, make_call=make_call)
    assert res["correct"] is False
    assert res["compared"]["raised_calls"]["value"] == res["attempted"]
