"""N-LIMS (paper §6.7): identical LIMS structure and page layout, with the
rank prediction models replaced by B+-tree-style binary search. Same page
accesses by construction; the delta is pure CPU (probe count / locate
time), which is exactly what Fig. 14 measures.

Port of ``repro/baselines/nlims.py`` (``:1-16``), copied; it wraps
the port's host ``LIMSIndex``.
"""
from __future__ import annotations

from ..core.index import LIMSIndex
from ..core.metrics import MetricSpace


class NLIMS(LIMSIndex):
    name = "nlims"

    def __init__(self, space: MetricSpace, **kw):
        kw.pop("learned", None)
        super().__init__(space, learned=False, **kw)
