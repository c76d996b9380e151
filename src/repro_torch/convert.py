"""Carry a reference snapshot's state into the port.

``snapshot_from_reference`` builds the port's ``LIMSSnapshot`` from the
fields of a ``repro.core.snapshot.LIMSSnapshot`` handed over as numpy
arrays, so both executors can run on the identical learned state: the
rank-model tables, the certified bounds and the layout are the index's
"weights".  This module reads numpy only; it never imports ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.snapshot import (DEVICE_FIELDS, HOST_FIELDS, SCALAR_FIELDS,
                            LIMSSnapshot)
from .kernels.dispatch import resolve_device

# every field snapshot_from_reference reads
FIELDS = DEVICE_FIELDS + HOST_FIELDS + SCALAR_FIELDS


def snapshot_from_reference(arrays: dict, device=None) -> LIMSSnapshot:
    """``arrays`` maps every name in :data:`FIELDS` to a numpy array (or
    a Python int for the scalars), e.g.
    ``{f: np.asarray(getattr(ref_snap, f)) for f in FIELDS}``.  Device
    fields keep their dtypes and land on ``device`` (default ``cuda``)."""
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
    return LIMSSnapshot(**kw)


__all__ = ["FIELDS", "snapshot_from_reference"]
