"""Deterministic sharded synthetic-token pipeline with host prefetch.

Port of ``repro/data/pipeline.py`` (``pipeline.py:1-111``), a numpy
copy: every (step, data-shard) pair maps to a counter-based RNG stream,
so restarts resume mid-stream exactly (the iterator state is the step
number), each data-parallel host generates only its slice, and a
straggler that skips a step stays consistent with the fleet.  The
generator produces Zipf-distributed token documents packed into fixed
sequences, with enough structure for a small model to show a learning
curve.  ``TokenPipeline`` yields tensors on its ``device`` (default
``cuda``); the batches themselves are drawn in numpy, bit for bit the
reference's.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCell
from ..kernels.dispatch import resolve_device


@dataclass
class DataShard:
    shard_id: int
    n_shards: int


def _batch_for_step(step: int, shard: DataShard, vocab: int, batch: int,
                    seq: int, seed: int = 1234) -> dict:
    """Counter-based deterministic batch (shard-local slice)."""
    local = batch // shard.n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard.shard_id]))
    # Zipf-ish unigram with markov-ish bigram structure: token t+1 depends
    # on t via a cheap hash so the LM has something learnable
    base = rng.zipf(1.3, size=(local, seq + 1)).astype(np.int64)
    base = base % (vocab - 2) + 1
    mix = (base[:, :-1] * 2654435761 % (vocab - 2) + 1)
    keep = rng.random((local, seq)) < 0.5
    nxt = np.where(keep, mix, base[:, 1:])
    tokens = base[:, :-1]
    labels = nxt
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32)}


class TokenPipeline:
    """Iterator with background prefetch; resume via ``start_step``.
    Batches are dicts of tensors on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: ModelConfig, cell: ShapeCell,
                 shard: Optional[DataShard] = None, start_step: int = 0,
                 prefetch: int = 2, seed: int = 1234, device=None):
        self.cfg = cfg
        self.cell = cell
        self.shard = shard or DataShard(0, 1)
        self.step = start_step
        self.seed = seed
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            b = _batch_for_step(step, self.shard, self.cfg.vocab,
                                self.cell.global_batch, self.cell.seq_len,
                                self.seed)
            extra = _extra_inputs(self.cfg, self.cell, step, self.seed)
            b.update(extra)
            try:
                self._q.put((step, b), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            step, b = self._q.get()
            if step < self.step:     # stale after a skip
                continue
            self.step = step + 1
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in b.items()}

    def skip_to(self, step: int) -> None:
        """Straggler mitigation: jump the stream forward."""
        self.step = step

    def close(self):
        self._stop.set()


def _extra_inputs(cfg: ModelConfig, cell: ShapeCell, step: int,
                  seed: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 777]))
    out = {}
    if cfg.family == "vlm" and cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.normal(
            0, 0.02, (cell.global_batch, cfg.n_prefix_embeds,
                      cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(
            0, 0.02, (cell.global_batch, cell.seq_len,
                      cfg.d_model)).astype(np.float32)
    return out
