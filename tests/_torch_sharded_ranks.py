"""Rank processes of the port's multi-device MSM, for
tests/test_torch_sharded_ranks.py (not collected: no test_ prefix).

`run_ranks` spawns one process a rank of a `torch.distributed` gloo
world on the CPU (`tpu_msm_torch.parallel.spawn`), which meets through
a file store, builds the port's mesh with `convert.mesh_from_jax` and
runs `sharded_msm` (or the sharded pipeline's `window_sums`) on the
case's inputs, generated in the rank from the case's seed. A spawned
rank unpickles its target by module, so this module imports only
`torch` and `tpu_msm_torch`: no rank imports `jax` or `tpu_msm`.
"""

from __future__ import annotations

import datetime
import math
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

from tpu_msm_torch import convert
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.constants import CURVES
from tpu_msm_torch.parallel import spawn
from tpu_msm_torch.parallel.sharded import get_sharded_pipeline, sharded_msm
from tpu_msm_torch.reference import curve as ref

# A collective that waits longer than this fails its rank.
GROUP_TIMEOUT_S = 60


def rank_main(rank: int, world: int, case: dict, workdir: str) -> dict:
    """One rank: the case's MSM (case["windows"]: its decoded window
    sums) on the mesh case["mesh"]."""
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = convert.mesh_from_jax(case["mesh"], "cpu")
        curve = CURVES[case["curve"]]
        cfg = MSMConfig(curve=curve, **case["config"])
        pts, scalars = ref.gen_points_scalars(curve, case["n"],
                                              seed=case["seed"])
        if case.get("windows"):
            pipe = get_sharded_pipeline(cfg, mesh, "cpu")
            return {"windows": pipe.window_sums(*pipe.pack(pts, scalars))}
        return {"msm": sharded_msm(pts, scalars, mesh, config=cfg,
                                   device="cpu")}
    finally:
        dist.destroy_process_group()


def run_ranks(case: dict, workdir: Path, deadline_s: float) -> list:
    """The ranks of case["mesh"], spawned (`parallel.spawn.run_ranks`),
    meeting in workdir -> each rank's result in rank order. A rank that
    fails or is still running at the deadline fails the call."""
    workdir.mkdir(parents=True, exist_ok=True)
    return spawn.run_ranks(rank_main, math.prod(case["mesh"].values()),
                           (case, str(workdir)), deadline_s)


def probe(rank: int, world: int, mode: str):
    """For the test of the spawn harness itself: rank 1 raises, hangs or
    dies without a value as `mode` says; every other rank returns
    (rank, world)."""
    if rank == 1 and mode == "raise":
        raise ValueError("rank 1 raised")
    if rank == 1 and mode == "hang":
        time.sleep(600)
    if rank == 1 and mode == "die":
        os._exit(3)
    return rank, world
