"""Run a function on a group of ranks on one host, each rank a process
(``multiprocessing``'s spawn start method), as torchrun would start them:
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT are set, and the
default process group is initialised (``sharding.init_distributed``:
gloo on the CPU or when the ranks share a card, NCCL with a card a rank).

Every group has a deadline: when it passes, or when a rank fails, the
ranks still running are killed and ``run_ranks`` raises.  A rank's failure
is never swallowed.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback


def _rank_main(fn, args, rank: int, world: int, port: int,
               device_type: str, timeout_s: float, threads: int, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from . import sharding

    if threads:
        torch.set_num_threads(threads)
    try:
        sharding.init_distributed(device_type, timeout_s)
        result = fn(*args)
        out.put((rank, True, result))
    except BaseException:           # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), device_type: str = "cpu",
              timeout_s: float = 300.0, threads: int = 0) -> list:
    """``fn(*args)`` on ``world`` ranks; returns each rank's result (it must
    pickle), in rank order.  ``fn`` must be importable by name (a module's
    top-level function).  ``threads`` > 0 sets each rank's torch threads.
    Raises ``RuntimeError`` with the rank's traceback when a rank fails and
    ``TimeoutError`` when the group outlives ``timeout_s``; either way no
    rank outlives the call."""
    from .sharding import free_port

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world, port, device_type,
                               timeout_s, threads, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world} ranks: no result from ranks "
                    f"{sorted(set(range(world)) - set(results))} within "
                    f"{timeout_s:.0f} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       f"result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == world else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
