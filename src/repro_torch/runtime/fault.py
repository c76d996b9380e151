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
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..ckpt import checkpoint as ckpt


@dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 5
    watchdog_s: Optional[float] = None
    # test hook: raise at these steps to exercise the restart path
    inject_failures_at: tuple = ()


@dataclass
class LoopStats:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: list = field(default_factory=list)


def run_training(train_step: Callable, state, batches: Callable,
                 n_steps: int, fc: FaultConfig) -> tuple:
    """batches: step -> batch dict. Returns (state, LoopStats)."""
    stats = LoopStats()
    saver = ckpt.AsyncCheckpointer(fc.ckpt_dir, fc.keep)
    restored = ckpt.latest_step(fc.ckpt_dir)
    if restored is not None:
        state, _ = ckpt.restore(state, fc.ckpt_dir, restored)
        start = int(state["step"])
    else:
        start = int(state["step"])
        ckpt.save(state, fc.ckpt_dir, start, fc.keep)

    step = start
    injected = set(fc.inject_failures_at)
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            if step in injected:
                injected.discard(step)
                raise RuntimeError(f"injected failure at step {step}")
            batch = batches(step)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if fc.watchdog_s is not None and dt > fc.watchdog_s:
                stats.stragglers += 1
            stats.losses.append(loss)
            stats.steps_run += 1
            step += 1
            if step % fc.ckpt_every == 0:
                saver.maybe_save(state, step)
        except Exception:  # noqa: BLE001 — restart-on-anything is the point
            stats.restarts += 1
            if stats.restarts > fc.max_restarts:
                raise
            saver.wait()
            last = ckpt.latest_step(fc.ckpt_dir)
            state, _ = ckpt.restore(state, fc.ckpt_dir, last)
            step = int(state["step"])
    saver.wait()
    ckpt.save(state, fc.ckpt_dir, step, fc.keep)
    return state, stats
