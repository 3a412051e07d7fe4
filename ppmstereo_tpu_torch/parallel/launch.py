"""Run one function in a group of processes on this host.

`run_group(fn, world, args)` spawns `world` processes (start method
`spawn`), forms a gloo process group among them through a `FileStore` in a
temporary directory (no port, no network), calls `fn(rank, world, *args)`
in each and returns the ranks' results in rank order. Every collective of
the group, and the wait for the results, is bounded by `timeout_s`. A
failure or a timeout in any process ends all of them and raises.

Results travel back pickled: return numpy arrays and plain values, not
tensors. On a card the processes may share one device; gloo then stages
their messages through the host (`parallel/ring_attention.py`).
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank: int, world: int, store_path: str, timeout_s: float, threads: int,
           results, fn, args) -> None:
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"  # the group's processes share one host
    torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout_s))
        try:
            results.put((rank, None, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, traceback.format_exc(), None))


def run_group(fn, world: int, args: tuple = (), timeout_s: float = 300.0,
              threads: int = 1) -> list:
    """fn(rank, world, *args) in `world` spawned processes of one gloo group
    (`threads` torch threads each); returns the results in rank order."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(r, world, store, timeout_s, threads, results,
                                                  fn, args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        try:
            deadline = time.monotonic() + timeout_s
            while len(out) < world:
                try:
                    rank, error, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"process {dead[0]} of the group exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the group of {world} gave no result in {timeout_s} s")
                    continue
                if error is not None:
                    raise RuntimeError(f"process {rank} of the group failed:\n{error}")
                out[rank] = value
            for p in procs:
                p.join(timeout=timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
