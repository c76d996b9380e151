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

Data parallelism: ``DataShard(r, W)`` draws rank r's contiguous block of
the global batch (the concatenation of the W shards' draws in shard
order is the global batch; the vlm / encdec embeddings are drawn whole
and cut to the same block, :func:`shard_rows`).  The reference's step
holds its microbatch i's rows split over the data axis
(:func:`microbatch_rows`), a different grouping: the port's step gathers
the shards' blocks and takes its own rows (``train/step.py``).
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


def shard_rows(batch: dict, shard: DataShard) -> dict:
    """``shard``'s contiguous block of a global batch's rows (numpy
    arrays or tensors); ``ValueError`` where the rows do not divide."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % shard.n_shards:
            raise ValueError(f"{k}: {n} rows do not divide into "
                             f"{shard.n_shards} shards")
        b = n // shard.n_shards
        out[k] = v[shard.shard_id * b:(shard.shard_id + 1) * b]
    return out


def microbatch_rows(global_batch: int, microbatches: int,
                    shard: DataShard) -> list:
    """The global rows ``shard`` holds in each microbatch of the
    reference's data-parallel step, ``[(start, stop), ...]``: microbatch
    i is rows i*B/mb .. (i+1)*B/mb - 1, split over the shards in order
    (the layout ``P(None, dp_axes)`` gives after the step's reshape).
    ``ValueError`` unless B divides by mb * W."""
    mb, w = max(1, microbatches), shard.n_shards
    if global_batch % (mb * w):
        raise ValueError(f"a global batch of {global_batch} does not "
                         f"divide into {mb} microbatches x {w} ranks")
    per, b = global_batch // mb, global_batch // (mb * w)
    return [(i * per + shard.shard_id * b, i * per + (shard.shard_id + 1) * b)
            for i in range(mb)]


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
            b.update(shard_rows(extra, self.shard))
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
