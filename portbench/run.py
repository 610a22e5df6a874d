"""Run one cell of the benchmark of `tpu_msm_torch` once, on the CUDA
card of this machine, and print its result as the last line of
standard output.

    python3 portbench/run.py --workload bn254.msm_2p20 --seed 7 \
        --seconds 51 --trace 0

Run it from the root of a checkout that holds `tpu_msm_torch`. With
`--trace 0` the result holds the cell's end-to-end metrics of
`BENCHMARK.json`, with `--trace 1` its per-layer metrics, read from one
torch.profiler session over the window's first calls. It exits with a
non-zero code and prints no result where the machine has fewer CUDA
cards than the cell asks for, where the package cannot be imported,
and where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_msm")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name, power limit and clock, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({e.__class__.__name__})"
    return "[card] " + (out or "not read")


def prepare() -> None:
    """Every cache of the program at a fixed path inside the checkout;
    the autotune cache at a path that is never written, so that
    default_config gives the static schedule users get by default; the
    checkout and this folder on the module path."""
    os.environ["TPU_MSM_TORCH_BUILD_DIR"] = os.path.join(
        ROOT, "build", "tpu_msm_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TPU_MSM_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tempfile.gettempdir(), "portbench-no-autotune", "absent.json")
    sys.path[:0] = [ROOT, BENCH_DIR]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()

    import torch
    import harness
    t_torch = time.perf_counter()

    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    t_cuda = time.perf_counter()
    import tpu_msm_torch  # noqa: F401  (fails where the checkout lacks it)

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    log(f"[imports] torch {t_torch - T0:.3f} s, cards {t_cuda - t_torch:.3f} "
        f"s, tpu_msm_torch {time.perf_counter() - t_cuda:.3f} s")
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", spec=spec, t0=T0,
                         log=log)
    log(card_line())
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    for name, c in result["compared"].items():
        log(f"[compared] {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
