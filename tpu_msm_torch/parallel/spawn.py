"""A world of rank processes on one host, spawned, with a deadline.

`run_ranks(fn, world, args, deadline_s)` starts `world` processes (the
"spawn" start method), runs `fn(rank, world, *args)` in each and returns
their return values in rank order. Each rank makes its own process group
(`torch.distributed.init_process_group` with its rank and the world
size); the ranks of a test meet through a `file://` store, which needs
no port. A rank that raises, dies, or has not returned by the deadline
fails the call, and every rank still running is killed. `fn`, its
arguments and its value must pickle: `fn` is a module-level function,
which a spawned process imports by its module.
"""

from __future__ import annotations

import multiprocessing
import queue
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_entry(fn: Callable, rank: int, world: int, args: Sequence,
                results) -> None:
    """One rank: (rank, True, fn's value) or (rank, False, the traceback)
    on `results`; a failure also fails the process."""
    try:
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              deadline_s: float = 120.0) -> List[Any]:
    """fn(rank, world, *args) on ranks 0 .. world - 1, one spawned
    process each -> the ranks' values in rank order. Raises
    RuntimeError with the traceback of the first rank that fails, or
    when a rank dies without a value, and TimeoutError when the ranks
    have not all returned within deadline_s."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    got, dead_polls = {}, 0
    try:
        while len(got) < world:
            if time.monotonic() > end:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} not done in {deadline_s} s")
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                # a rank's value is in the pipe before its process ends:
                # a rank is dead when it has ended and, a poll later,
                # still sent nothing
                if dead and dead_polls:
                    raise RuntimeError(f"ranks {dead} of {world} died "
                                       f"(exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                dead_polls = dead_polls + 1 if dead else 0
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            got[r] = value
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if failed:
        raise RuntimeError(f"ranks failed after returning (exit codes "
                           f"{failed})")
    return [got[r] for r in range(world)]
