"""Fault tolerance: restartable training loop with failure injection,
step watchdog (straggler mitigation), and checkpoint-resume.

Port of ``repro/runtime/fault.py`` (``fault.py:1-85``).  The loop
contract:
  * every step is deterministic given (state, step): data is
    counter-based (``repro_torch.data.pipeline``) and so is the step's
    generator (``train.step``), so a restart from a checkpoint replays
    identically;
  * a step exceeding ``watchdog_s`` is counted as a straggler;
  * any exception -> restore the latest checkpoint -> continue, up to
    ``max_restarts``.

Under a ``torch.distributed`` group (the data-parallel step) every rank
runs the loop with the ``group``: checkpoints are the group's
(``ckpt.save(..., group=)``), and before each step the ranks agree
whether any of them failed to get there (an injected failure, which
``inject_rank`` confines to one rank, or the batch), in which case every
rank restores the latest checkpoint.  A failure inside the step's own
collectives cannot be agreed on (the other ranks wait in them): it
propagates, and the launcher (``launch.ranks``) reports it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..ckpt import checkpoint as ckpt
from ..sharding import collective


@dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 5
    watchdog_s: Optional[float] = None
    # test hook: raise at these steps to exercise the restart path (on
    # rank inject_rank only, under a group; None: on every rank)
    inject_failures_at: tuple = ()
    inject_rank: Optional[int] = None


@dataclass
class LoopStats:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: list = field(default_factory=list)


def _any(failed: bool, group) -> bool:
    """Whether any rank of ``group`` failed (``failed`` alone in one
    process)."""
    if group is None:
        return failed
    import torch
    import torch.distributed as dist
    flag = torch.tensor([int(failed)], dtype=torch.int32,
                        device=_device_of(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def _device_of(group):
    """The device a collective of ``group`` takes its tensors on."""
    import torch
    import torch.distributed as dist
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def run_training(train_step: Callable, state, batches: Callable,
                 n_steps: int, fc: FaultConfig, group=None) -> tuple:
    """batches: step -> batch dict. Returns (state, LoopStats).  With
    ``group``, every rank of it runs this together (module
    docstring)."""
    stats = LoopStats()
    rank = 0
    if group is not None:
        import torch.distributed as dist
        rank = dist.get_rank(group)
    saver = ckpt.AsyncCheckpointer(fc.ckpt_dir, fc.keep, group)
    restored = ckpt.latest_step(fc.ckpt_dir)
    collective.barrier(group)       # every rank has looked before any writes
    if restored is not None:
        state, _ = ckpt.restore(state, fc.ckpt_dir, restored)
        start = int(state["step"])
    else:
        start = int(state["step"])
        ckpt.save(state, fc.ckpt_dir, start, fc.keep, group)

    step = start
    injected = set(fc.inject_failures_at)
    while step < n_steps:
        t0 = time.perf_counter()
        error = None
        try:
            if step in injected:
                injected.discard(step)
                if fc.inject_rank in (None, rank):
                    raise RuntimeError(f"injected failure at step {step}")
            batch = batches(step)
        except Exception as e:  # noqa: BLE001 — restart-on-anything
            error = e
        failed = _any(error is not None, group)
        if not failed:
            try:
                state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])
            except Exception as e:  # noqa: BLE001 — restart-on-anything
                if group is not None:
                    raise
                error, failed = e, True
        if failed:
            stats.restarts += 1
            if stats.restarts > fc.max_restarts:
                raise error or RuntimeError(
                    f"another rank failed at step {step}")
            saver.wait()
            collective.barrier(group)
            last = ckpt.latest_step(fc.ckpt_dir)
            state, _ = ckpt.restore(state, fc.ckpt_dir, last)
            step = int(state["step"])
            continue
        dt = time.perf_counter() - t0
        if fc.watchdog_s is not None and dt > fc.watchdog_s:
            stats.stragglers += 1
        stats.losses.append(loss)
        stats.steps_run += 1
        step += 1
        if step % fc.ckpt_every == 0:
            saver.maybe_save(state, step)
    saver.wait()
    ckpt.save(state, fc.ckpt_dir, step, fc.keep, group)
    return state, stats
