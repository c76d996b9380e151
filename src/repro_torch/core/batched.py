"""Batched LIMS query engine: the one-shot API.

Port of ``repro/core/batched.py``: build a snapshot from a host index on
a device and query it.  ``BatchedLIMS`` *is* a ``QueryExecutor`` (same
methods, same bit-exact results).
"""
from __future__ import annotations

from .executor import QueryExecutor
from .index import LIMSIndex
from .snapshot import LIMSSnapshot, maybe_paged


class BatchedLIMS(QueryExecutor):
    """Device snapshot of a LIMSIndex (vector metrics, L2) on ``device``
    (default ``cuda``; raises if there is no card).

    Under ``REPRO_STORAGE=paged`` the snapshot spills to a self-cleaning
    paged store and serves store-backed (bit-identical results, page IO
    in place of resident rows)."""

    def __init__(self, index: LIMSIndex, device=None):
        super().__init__(maybe_paged(LIMSSnapshot.build(index, device)))


__all__ = ["BatchedLIMS"]
