"""Unified model interface of the dense family: specs, prefill and decode
functions, and batch descriptions for prefill / decode shape cells.

Port of ``repro/models/zoo.py`` (``zoo.py:18-112``), dense subset.
``loss_fn`` and train cells wait for the training slice; the encdec and
vlm branches for their families (ROADMAP A14).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCell
from ..kernels.dispatch import resolve_device
from . import transformer as tr


def model_specs(cfg: ModelConfig) -> dict:
    return tr.model_specs(cfg)


def prefill_fn(cfg: ModelConfig, cache_len: int):
    """``(params, batch) -> (logits (B, 1, V) f32, cache)``; runs on the
    device of ``batch["tokens"]``."""
    tr.check_supported(cfg)
    return lambda params, batch: tr.prefill(params, batch["tokens"], cfg,
                                            cache_len)


def decode_fn(cfg: ModelConfig):
    """``(params, token, cache) -> (logits (B, 1, V) f32, cache)``."""
    tr.check_supported(cfg)
    return lambda params, token, cache: tr.decode_step(params, token,
                                                       cache, cfg)


# ------------------------------------------------------------------ batches
def batch_desc(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """{name: (shape, dtype, logical_axes)} for a prefill or decode cell."""
    tr.check_supported(cfg)
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "prefill":
        return {"tokens": ((b, s), "int32", ("batch", "seq"))}
    if cell.kind == "decode":
        return {"token": ((b,), "int32", ("batch",))}
    if cell.kind == "train":
        raise NotImplementedError("train cells wait for the training "
                                  "slice (ROADMAP A14)")
    raise ValueError(cell.kind)


def make_batch(cfg: ModelConfig, cell: ShapeCell, seed: int = 0,
               device=None) -> dict:
    """A random batch matching ``batch_desc`` on ``device`` (default
    ``cuda``), drawn with numpy exactly as the reference draws it, so
    the same seed gives the same tokens."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _, _) in batch_desc(cfg, cell).items():
        out[name] = torch.from_numpy(
            rng.integers(0, cfg.vocab, size=shape).astype(np.int32)).to(dev)
    return out
