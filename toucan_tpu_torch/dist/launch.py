"""Start the ranks of a mesh as processes of one machine.

``run_ranks(target, world, ...)`` starts ``world`` processes with the
``spawn`` start method (never ``fork``: a forked child of a process that
has initialised CUDA cannot use the card), joins each to one process group
on a free localhost port, calls ``target(rank, world, *args)`` in each and
returns their results in rank order.  Every rank has its own clock: the
process group's timeout bounds each collective, and the parent kills every
rank when one fails or when ``timeout_s`` has passed, then raises with the
failing rank's traceback, so a hung collective costs one call, never the
run.  ``target`` must be importable by name (a module-level function).
"""

from __future__ import annotations

import queue as queue_mod
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(target, rank, world, port, backend, args, results, timeout_s):
    import torch.distributed as dist

    from toucan_tpu_torch.dist.mesh import initialize_distributed

    try:
        initialize_distributed(f"localhost:{port}", world, rank, backend=backend,
                               timeout_s=timeout_s)
        results.put((rank, True, target(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world: int, args=(), backend: str = "gloo", timeout_s: float = 300.0):
    """[target(rank, world, *args) for each rank], run in ``world`` spawned
    processes joined over ``backend``; raises RuntimeError if a rank fails
    or the ranks outlive ``timeout_s``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(target, r, world, port, backend, args, results, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} did not "
                                   f"finish within {timeout_s:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
