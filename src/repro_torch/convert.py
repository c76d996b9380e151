"""Carry a reference snapshot's state, or a reference model's
parameters, into the port.

``snapshot_from_reference`` builds the port's ``LIMSSnapshot`` from the
fields of a ``repro.core.snapshot.LIMSSnapshot`` handed over as numpy
arrays, so both executors can run on the identical learned state: the
rank-model tables, the certified bounds and the layout are the index's
"weights".  ``params_from_reference`` does the same for an LM's
parameter tree.  This module reads numpy only; it never imports
``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.snapshot import (DEVICE_FIELDS, HOST_FIELDS, LP_DTYPES,
                            SCALAR_FIELDS, LIMSSnapshot, host_tables)
from .kernels.dispatch import resolve_device

# every field snapshot_from_reference reads
FIELDS = DEVICE_FIELDS + HOST_FIELDS + SCALAR_FIELDS


def snapshot_from_reference(arrays: dict, device=None) -> LIMSSnapshot:
    """``arrays`` maps every name in :data:`FIELDS` to a numpy array (or
    a Python int for the scalars), e.g.
    ``{f: np.asarray(getattr(ref_snap, f)) for f in FIELDS}``.  Device
    fields keep their dtypes and land on ``device`` (default ``cuda``).

    The reduced-precision filter plane comes over when ``arrays`` holds
    ``rows_lp``: its bits as uint16 (numpy has no bf16), with
    ``rows_lp_dtype`` ("bf16" or "f16") and the margin ``lp_eps``."""
    missing = [f for f in FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"reference snapshot fields missing: {missing}")
    dev = resolve_device(device)
    kw = {f: int(arrays[f]) for f in SCALAR_FIELDS}
    for f in DEVICE_FIELDS:
        kw[f] = torch.tensor(np.asarray(arrays[f]), device=dev)
    kw["gids_np"] = np.asarray(arrays["gids_np"], np.int64)
    kw["rows_np"] = np.asarray(arrays["rows_np"], np.float64)
    kw["valid_np"] = np.asarray(arrays["valid_np"], bool)
    kw["tables_np"] = host_tables(*(arrays[f] for f in (
        "rids", "pivots", "coef", "model_lo", "model_hi", "model_n",
        "rank_err", "in_ring")))
    if arrays.get("rows_lp") is not None:
        bits = np.array(arrays["rows_lp"])         # a writable copy
        if bits.dtype != np.uint16:
            raise TypeError(f"rows_lp must be the plane's uint16 bits, "
                            f"got {bits.dtype}")
        kw["rows_lp"] = torch.from_numpy(bits.view(np.int16)).view(
            LP_DTYPES[arrays["rows_lp_dtype"]]).to(dev)
        kw["lp_eps"] = float(arrays["lp_eps"])
    return LIMSSnapshot(**kw)


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16: same bits
        t = torch.from_numpy(np.array(a, copy=True).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype if t.is_floating_point() and
                dtype is not None else t.dtype)


def params_from_reference(tree: dict, device=None, dtype=None) -> dict:
    """The port's parameter tree from the reference's, handed over as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``):
    the same leaf names and shapes, on ``device`` (default ``cuda``).
    Leaves keep their dtypes unless ``dtype`` is given, which casts the
    floating leaves except the norm weights (names ending in ``norm``),
    which the specs pin to float32."""
    dev = resolve_device(device)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _tensor(node, dev, None if name.endswith("norm") else dtype)

    return walk(tree, "")


__all__ = ["FIELDS", "snapshot_from_reference", "params_from_reference"]
