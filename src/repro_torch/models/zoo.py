"""Unified model interface: specs, loss, prefill and decode functions
per family, and batch descriptions for train / prefill / decode shape
cells.

Port of ``repro/models/zoo.py`` (``zoo.py:18-112``).

Serving over ranks: ``prefill_fn`` / ``decode_fn`` with a ``mesh`` of
processes (a ``LogicalMesh`` with ``group``, as ``build_train_step``
takes it; ``launch.mesh.make_host_mesh`` inside ``launch.ranks``) run
each rank on its block of the batch's rows (``data.pipeline.
shard_rows``) and its chunks of the parameters (:func:`rank_params`),
inside the mesh's data-parallel group and model line
(:func:`serving_parallel`).  The attention families split heads, the
MLP or experts and the vocabulary over the model line as the training
step does, and the KV cache as the reference lays it out
(``transformer.cache_splits``); the logits come back whole on every
rank of the line.  The ssm, hybrid and encdec families run over the
data axes alone; under a model line of several ranks they raise
``NotImplementedError`` (ROADMAP Queue A item 10(b)).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, RunConfig, ShapeCell
from ..kernels.dispatch import resolve_device
from ..sharding import collective
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


def serving_parallel(mesh) -> collective.DataParallel | None:
    """The group serving runs in over a mesh of processes: the data
    axes' line, and where the ``model`` axis spans several ranks the
    rank's ``ModelLine``; None without a mesh of processes.  Every rank
    of the mesh calls it together (it makes the lines' groups)."""
    if mesh is None or getattr(mesh, "group", None) is None:
        return None
    dp = tuple(a for a in collective.DP_AXES if a in mesh.axis_names)
    group, size, _ = mesh.line(dp)
    model = None
    if mesh.shape.get(collective.MODEL_AXIS, 1) > 1:
        model = collective.ModelLine(
            *mesh.line((collective.MODEL_AXIS,)),
            span=mesh.line(dp + (collective.MODEL_AXIS,))[0])
    return collective.DataParallel(group, size, model=model)


def rank_params(cfg: ModelConfig, params, mesh, fsdp: bool = False):
    """The whole parameters ``params`` (``init_params``,
    ``convert.params_from_reference``; a leaf may be a zero-argument
    callable returning it) cut to this rank's chunks over a mesh of
    processes, by the guard's specs under ``default_rules(fsdp=fsdp)``,
    as ``train.step.init_state`` cuts them (``shard_params``): the model
    chunks of what the guard puts on ``model``, under FSDP the data
    chunks of those."""
    from ..train.step import shard_params
    return shard_params(cfg, RunConfig(fsdp=fsdp), params, mesh)


def _in_group(fn, mesh):
    dp = serving_parallel(mesh)
    if dp is None:
        return fn

    def run(*args):
        with collective.data_parallel(dp):
            return fn(*args)
    return run


def prefill_fn(cfg: ModelConfig, cache_len: int, mesh=None):
    """``(params, batch) -> (logits (B, 1, V) f32, cache)``; runs on the
    device of ``batch["tokens"]``.  An encdec batch holds
    ``src_embeds``, a vlm batch ``prefix_embeds``.  Over a ``mesh`` of
    processes (the module docstring) ``params`` are the rank's chunks,
    ``batch`` its rows, and the cache its chunk
    (``transformer.cache_splits``)."""
    if cfg.family == "encdec":
        return _in_group(lambda params, batch: ed.encdec_prefill(
            params, batch["src_embeds"], batch["tokens"], cfg, cache_len),
            mesh)
    return _in_group(lambda params, batch: tr.prefill(
        params, batch["tokens"], cfg, cache_len,
        prefix_embeds=batch["prefix_embeds"] if cfg.family == "vlm"
        else None, mesh=mesh), mesh)


def decode_fn(cfg: ModelConfig, mesh=None):
    """``(params, token, cache) -> (logits (B, 1, V) f32, cache)``; over a
    ``mesh`` of processes the rank's chunks, rows and cache, as
    :func:`prefill_fn` made them."""
    if cfg.family == "encdec":
        return _in_group(lambda params, token, cache: ed.encdec_decode_step(
            params, token, cache, cfg), mesh)
    return _in_group(lambda params, token, cache: tr.decode_step(
        params, token, cache, cfg), mesh)


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
