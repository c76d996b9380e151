"""Data-parallel processes: one ``torch.distributed`` rank a card.

:func:`run_ranks` spawns W processes (the ``spawn`` start method: a
child never inherits a parent's CUDA state), joins them into one group
through a ``file://`` rendezvous in a fresh temporary directory (no
fixed TCP port, so several launches can run on one host at once), sets
each rank's device, runs ``fn(rank, device, *args)`` in each and returns
the ranks' results in rank order (pickled by value).  It raises if any rank raises (with
that rank's traceback), dies or outlives ``timeout_s``, and stops every
process it started before it returns or raises.

The backend is ``nccl`` on cards, one rank a card.  ``gloo`` runs only
where the caller names it (the CPU tests; two ranks on one card, which
NCCL refuses).  :func:`process_group` is the same set-up in the calling
process, for a group of one.

Usage (the rank body must be a module-level function: it is pickled by
its import path)::

    from repro_torch.launch.ranks import run_ranks
    results = run_ranks(body, torch.cuda.device_count(), args=(...,))
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


@contextlib.contextmanager
def process_group(backend: str, world: int, rank: int, init_file: str,
                  device=None, timeout_s: float = 900.0):
    """Join (and on exit leave) the default process group of ``world``
    ranks as ``rank``, rendezvous at the file ``init_file``; a CUDA
    ``device`` becomes the current one first.  Yields the group."""
    device = torch.device(device if device is not None else "cpu")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device       # NCCL binds the rank's card
    dist.init_process_group(
        backend, init_method="file://" + os.path.abspath(init_file),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, backend, init_file, device, timeout_s, fn, args,
               results):
    try:
        with process_group(backend, world, rank, init_file, device,
                           timeout_s):
            out = fn(rank, torch.device(device), *args)
        # by value: torch's queue reductions would pass a tensor's storage
        # as a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:      # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              backend: str = "nccl", devices: Optional[Sequence] = None,
              timeout_s: float = 900.0,
              tmp_dir: Optional[str] = None) -> list:
    """``fn(rank, device, *args)`` in ``world`` spawned processes of one
    group; returns the results in rank order (they travel by pickle).

    ``devices``: each rank's device; default ``cuda:<rank>`` for
    ``nccl`` (which needs a distinct card a rank) and the CPU for
    ``gloo``.  Raises ``RuntimeError`` with the rank's traceback where a
    rank raised or died, ``TimeoutError`` where ranks are still running
    after ``timeout_s``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if devices is None:
        devices = [f"cuda:{r}" if backend == "nccl" else "cpu"
                   for r in range(world)]
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend == "nccl":
        if any(not d.startswith("cuda") for d in devices) or \
                len(set(devices)) != world:
            raise ValueError(f"nccl needs a distinct card a rank: "
                             f"{devices}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=tmp_dir)
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, init_file, devices[r],
                               timeout_s, fn, args, results))
             for r in range(world)]
    got: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"rank(s) {dead} exited (codes "
                        f"{[procs[r].exitcode for r in dead]}) without a "
                        "result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(got))} "
                        f"still running after {timeout_s:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} raised:\n{out}")
            got[rank] = pickle.loads(out)
        return [got[r] for r in range(world)]
    finally:
        procs = [p for p in procs if p.pid is not None]     # started
        for p in procs:
            p.join(timeout=30 if len(got) == world else 0.1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


__all__ = ["process_group", "run_ranks"]
