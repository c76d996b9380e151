"""Unified model interface: specs, loss, prefill and decode functions
per family, and batch descriptions for train / prefill / decode shape
cells.

Port of ``repro/models/zoo.py`` (``zoo.py:18-112``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCell
from ..kernels.dispatch import resolve_device
from . import encdec as ed
from . import transformer as tr
from .params import torch_dtype

ENC_MEM_LEN = 4096     # encoder memory length for enc-dec decode shapes


def model_specs(cfg: ModelConfig) -> dict:
    if cfg.family == "encdec":
        return ed.encdec_specs(cfg)
    return tr.model_specs(cfg)


def loss_fn(cfg: ModelConfig):
    """``(params, batch) -> (loss, metrics)`` (ref ``zoo.py:24-27``);
    runs on the device of the batch."""
    if cfg.family == "encdec":
        return lambda params, batch: ed.encdec_loss(params, batch, cfg)
    return lambda params, batch: tr.lm_loss(params, batch, cfg)


def prefill_fn(cfg: ModelConfig, cache_len: int):
    """``(params, batch) -> (logits (B, 1, V) f32, cache)``; runs on the
    device of ``batch["tokens"]``.  An encdec batch holds
    ``src_embeds``, a vlm batch ``prefix_embeds``."""
    if cfg.family == "encdec":
        return lambda params, batch: ed.encdec_prefill(
            params, batch["src_embeds"], batch["tokens"], cfg, cache_len)
    if cfg.family == "vlm":
        return lambda params, batch: tr.prefill(
            params, batch["tokens"], cfg, cache_len,
            prefix_embeds=batch["prefix_embeds"])
    return lambda params, batch: tr.prefill(params, batch["tokens"], cfg,
                                            cache_len)


def decode_fn(cfg: ModelConfig):
    """``(params, token, cache) -> (logits (B, 1, V) f32, cache)``."""
    if cfg.family == "encdec":
        return lambda params, token, cache: ed.encdec_decode_step(
            params, token, cache, cfg)
    return lambda params, token, cache: tr.decode_step(params, token,
                                                       cache, cfg)


# ------------------------------------------------------------------ batches
def batch_desc(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """{name: (shape, dtype, logical_axes)} for the given shape cell."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.family == "vlm" and cfg.n_prefix_embeds:
        # the image-patch prefix is part of the context budget: text
        # tokens + prefix == seq_len (the decode cache is seq_len long)
        s = max(s - cfg.n_prefix_embeds, 1)
    if cell.kind == "train":
        if cfg.family == "encdec":
            return {
                "src_embeds": ((b, s, cfg.d_model), cfg.dtype,
                               ("batch", "seq", "embed_noshard")),
                "tokens": ((b, s), "int32", ("batch", "seq")),
                "labels": ((b, s), "int32", ("batch", "seq")),
            }
        d = {
            "tokens": ((b, s), "int32", ("batch", "seq")),
            "labels": ((b, s), "int32", ("batch", "seq")),
        }
        if cfg.family == "vlm":
            d["prefix_embeds"] = ((b, cfg.n_prefix_embeds, cfg.d_model),
                                  cfg.dtype,
                                  ("batch", "seq", "embed_noshard"))
        return d
    if cell.kind == "prefill":
        if cfg.family == "encdec":
            return {
                "src_embeds": ((b, s, cfg.d_model), cfg.dtype,
                               ("batch", "seq", "embed_noshard")),
                "tokens": ((b, 1), "int32", ("batch", "seq")),
            }
        d = {"tokens": ((b, s), "int32", ("batch", "seq"))}
        if cfg.family == "vlm":
            d["prefix_embeds"] = ((b, cfg.n_prefix_embeds, cfg.d_model),
                                  cfg.dtype,
                                  ("batch", "seq", "embed_noshard"))
        return d
    if cell.kind == "decode":
        return {"token": ((b,), "int32", ("batch",))}
    raise ValueError(cell.kind)


def cache_desc(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """{name: (shape, axes, dtype)} decode-cache description."""
    if cfg.family == "encdec":
        return ed.encdec_cache_spec(cfg, cell.global_batch, cell.seq_len,
                                    ENC_MEM_LEN)
    return tr.cache_spec(cfg, cell.global_batch, cell.seq_len)


def make_batch(cfg: ModelConfig, cell: ShapeCell, seed: int = 0,
               device=None) -> dict:
    """A random batch matching ``batch_desc`` on ``device`` (default
    ``cuda``), drawn with numpy exactly as the reference draws it (ints
    in [0, vocab), floats ``rng.normal(0, 0.02)`` rounded once to the
    dtype), so the same seed gives the same batch."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype, _) in batch_desc(cfg, cell).items():
        if dtype == "int32":
            out[name] = torch.from_numpy(
                rng.integers(0, cfg.vocab, size=shape).astype(np.int32)).to(
                    dev)
        else:
            out[name] = torch.from_numpy(rng.normal(0, 0.02, size=shape)).to(
                device=dev, dtype=torch_dtype(dtype))
    return out
