"""Baselines the paper compares against (§6.1.2).

All share the LIMS page-accounting conventions (same PageStore, same
QueryStats) so the comparison measures index structure, not bookkeeping:

  * ``LinearScan``   — brute force over pages (sanity floor).
  * ``NLIMS``        — LIMS with B+-tree-style binary search instead of
                       learned models (the paper's ablation, §6.7); exposed
                       here as a thin wrapper over ``LIMSIndex(learned=False)``.
  * ``MLIndex``      — the ML-index (EDBT'20): iDistance keys + learned
                       models; single-pivot per cluster.
  * ``ZMIndex``      — z-order + learned CDF (MDM'19); vector spaces,
                       range/point only (no kNN, as in the paper).
  * ``BallTree``     — metric ball tree; stand-in for the M-tree
                       (same triangle-inequality node pruning, node = page).

Port of ``repro/baselines/__init__.py`` (``:1-23``), copied: host
numpy algorithms over ``repro_torch.core``; no device argument.
"""
from .linear_scan import LinearScan
from .ml_index import MLIndex
from .nlims import NLIMS
from .zm_index import ZMIndex
from .balltree import BallTree

__all__ = ["LinearScan", "MLIndex", "NLIMS", "ZMIndex", "BallTree"]
