"""Checkpointing: atomic, async-capable, in the reference's layout.

Port of ``repro/ckpt/checkpoint.py`` (``checkpoint.py:1-140``).  Layout:
``<dir>/step_<n:08d>/`` with one ``.npy`` per tensor, named by its path
in the nested-dict state with ``/`` replaced by ``__`` (bf16 widened
losslessly to f32: ``.npy`` has no bf16), plus ``manifest.json`` (step,
sorted keys, time).  Writes go to a ``.tmp`` directory renamed into
place, so a killed writer never corrupts the latest checkpoint.  A
checkpoint written by either package restores in the other.

``restore`` loads each tensor on the host and places it on the device
(and in the dtype) of the template's leaf.

Over a ``torch.distributed`` group (the data-parallel step,
``train/step.py``) every rank calls ``save`` with the ``group``: a ZeRO-1
or FSDP chunk (a moment, a factor or, under FSDP, a parameter: a tensor
marked with its ``sharding.collective.Shard``) is all-gathered first, so
the checkpoint holds the reference's one-device layout, and the group's
rank 0 alone copies it to the host and writes.  Under tensor
parallelism a parameter or a piece of optimizer state is the rank's
model chunk (marked with its model split, ``collective.tag_model``), or
a ZeRO-1 / FSDP chunk of that: it is gathered over the data line, then
over the model line (``collective.whole``).  ``restore`` cuts a marked
template leaf's chunk out of the whole tensor on disk (its model chunk,
then the data chunk of that), so a state moves between W processes and
one.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..sharding import collective


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} over nested dicts (and lists / tuples, keyed
    ``#i``, as the reference keys sequence entries)."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"#{i}", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten_like(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_like(v, flat, f"{prefix}/#{i}" if prefix
                               else f"#{i}")
               for i, v in enumerate(template)]
        return type(template)(out)
    return flat[prefix]


def _to_numpy(leaf, copy: bool = False) -> np.ndarray:
    """``leaf`` on the host as numpy, bf16 widened to f32; with ``copy``
    never a view of the caller's memory (which it may update in
    place)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            # .npy can't hold bf16; widen losslessly to f32
            t = t.to(torch.float32)
        return t.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _whole(leaf):
    """A ZeRO-1, FSDP or model chunk all-gathered into its whole tensor
    (every rank of its lines calls this together); any other leaf as it
    is."""
    return collective.whole(leaf) if isinstance(leaf, torch.Tensor) \
        else leaf


def _writes(group) -> bool:
    import torch.distributed as dist
    return group is None or dist.get_rank(group) == 0


def save(state, directory: str, step: int, keep: int = 3,
         group=None) -> str:
    """Atomic synchronous save. Returns the checkpoint path.  With
    ``group`` every rank of it calls this: chunks are gathered, rank 0
    writes, and all return once the checkpoint is in place."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = _writes(group)
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    flat = _flatten(state)
    manifest = {"step": int(step), "keys": sorted(flat),
                "time": time.time()}
    for key, leaf in flat.items():
        whole = _whole(leaf)          # collective: every rank gathers
        if writer:                    # the host copy: the writer's alone
            np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"),
                    _to_numpy(whole))
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)
    collective.barrier(group)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _like(arr: np.ndarray, leaf):
    """``arr`` in the template leaf's form: a tensor on its device and
    in its dtype (a marked chunk: its chunk of ``arr``, the model
    split's then the data split's, marked alike), or a numpy array of
    its dtype."""
    if isinstance(leaf, torch.Tensor):
        sh, m = collective.shard_of(leaf), collective.model_of(leaf)
        for split in (m, sh):
            if split is not None:
                arr = np.take(arr, range(split.index * split.size,
                                         (split.index + 1) * split.size),
                              axis=split.dim)
        t = torch.from_numpy(np.array(arr, order="C"))   # 0-d stays 0-d
        return collective.tag_model(collective.tag(
            t.to(device=leaf.device, dtype=leaf.dtype), sh), m)
    return arr.astype(np.asarray(leaf).dtype)


def restore(template, directory: str, step: Optional[int] = None):
    """Load into the structure of ``template``: each tensor on the
    device and in the dtype of the template's leaf.  Returns (state,
    step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    out = {}
    for key, leaf in _flatten(template).items():
        arr = np.load(os.path.join(path, key.replace("/", "__") + ".npy"))
        out[key] = _like(arr, leaf)
    return _unflatten_like(template, out), step


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; at most one in flight.
    The state is copied to the host before ``maybe_save`` returns, so
    the caller may go on updating it in place.  With ``group`` every
    rank calls ``maybe_save`` at the same steps: the chunks are gathered
    on each call, rank 0 holds the host copy and writes it, and it waits
    for its previous save rather than skip one (a skip on rank 0 alone
    would leave the others' gathers unmatched)."""

    def __init__(self, directory: str, keep: int = 3, group=None):
        self.directory = directory
        self.keep = keep
        self.group = group
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def maybe_save(self, state, step: int) -> bool:
        if self._thread is not None and self._thread.is_alive():
            if self.group is None:
                return False               # previous save still running
            self._thread.join()
        writer = _writes(self.group)
        host = {}
        for k, v in _flatten(state).items():
            whole = _whole(v)
            if writer:
                host[k] = _to_numpy(whole, copy=whole is v)
        if not writer:
            self.last_saved = step
            return True
        host_state = _unflatten_like(state, host)

        def work():
            save(host_state, self.directory, step, self.keep)
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
