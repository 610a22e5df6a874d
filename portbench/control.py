"""The control, and the faults, that the comparison has to catch.

Each puts something in the place of the timed path of a run and reports
what the comparison read; the benchmark's own runs never use them.

  control  the reference at a lower precision in the program's place:
           every scalar's lowest bit cleared, a scalar of one bit less
           precision, the rest of the reference as it is (the
           configuration states an exact result and no lower precision,
           so the control breaks that guarantee by the least step). Each
           call returns that MSM of its scalar set, worked out once a
           set.
  stale    the program, each call returning the previous call's result
           (a step that returns its state unchanged).
  half     the program on the first half of the points and scalars only
           (half of the batch left out).
  altered  the program with one limb of the first window sum's x raised
           by one where the device program writes it (an answer altered
           where it is produced).
  truncated  the program reading the base of point i at index
           i & (2^TRUNCATE_BITS - 1) (a point index cut to 16 bits, as
           where it is packed beside a key).
  shifted  the program reading the base of point i at index i + SHIFT
           mod n (an offset of one tile of 64 points).

    python3 portbench/control.py --workload bn254.msm_2p20 \
        --fault control --seeds 11,12,13 --seconds 3

prints one line a seed with the numbers compared and `correct`. Run
from the root of a checkout on a machine with the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import run

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FAULTS = ("control", "stale", "half", "altered", "truncated", "shifted")
TRUNCATE_BITS = 16
SHIFT = 64


def make_call_for(fault: str, curve):
    """A `make_call` for `harness.run` that plants `fault`."""
    import torch

    import harness
    import reference

    def control(pipe, inputs):
        memo = {}

        def call(hw):
            key = hw.data_ptr()
            if key not in memo:
                aff = reference.expected_msm(
                    curve, inputs.bases,
                    hw.view(torch.int16).numpy().view("<u2"),
                    dropped_bits=1)
                memo[key] = (1, 1, 0) if aff is None else (*aff, 1)
            return memo[key]
        return call

    def stale(pipe, inputs):
        inner = harness.msm_call(pipe, inputs)
        last = []

        def call(hw):
            res = inner(hw)
            out = last[0] if last else res
            last[:] = [res]
            return out
        return call

    def half(pipe, inputs):
        m = inputs.xs.shape[1] // 2

        class Half:
            def window_sums(self, xs, ys, hw):
                return pipe.window_sums(xs[:, :m], ys[:, :m], hw[:, :m])

            def horner(self, sums):
                return pipe.horner(sums)
        return harness.msm_call(Half(), inputs)

    def altered(pipe, inputs):
        program = pipe._device_program

        def device_program(*args):
            g = program(*args)
            g[0, 0, 0] += 1
            return g
        pipe._device_program = device_program
        return harness.msm_call(pipe, inputs)

    def misread(index_of):
        def make(pipe, inputs):
            idx = index_of(torch.arange(inputs.xs.shape[1],
                                        device=inputs.xs.device))
            bases = dataclasses.replace(
                inputs, xs=inputs.xs[:, idx].contiguous(),
                ys=inputs.ys[:, idx].contiguous())
            return harness.msm_call(pipe, bases)
        return make

    truncated = misread(lambda i: i & ((1 << TRUNCATE_BITS) - 1))
    shifted = misread(lambda i: (i + SHIFT) % i.numel())

    return {"control": control, "stale": stale, "half": half,
            "altered": altered, "truncated": truncated,
            "shifted": shifted}[fault]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=FAULTS, required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    run.prepare()
    import torch
    import harness
    import reference

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    wl = harness.load_json(os.path.join(BENCH_DIR, "workloads",
                                        args.workload + ".json"))
    cfg = harness.load_json(os.path.join(BENCH_DIR, "configs",
                                         wl["config"] + ".json"))
    curve = reference.Curve.from_config(cfg)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False,
                          make_call=make_call_for(args.fault, curve), log=log)
        line = {"workload": args.workload, "fault": args.fault, "seed": seed,
                "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"], "compared": res["compared"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
