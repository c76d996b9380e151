"""LIMS core (port of ``repro.core``): the host index and the resident
device query path — ``LIMSSnapshot`` -> ``Planner`` -> ``QueryExecutor``,
with ``BatchedLIMS`` as the one-shot shim."""
from .batched import BatchedLIMS
from .clustering import Clustering, kcenter, kmeans
from .executor import QueryExecutor
from .index import LIMSIndex, QueryStats
from .kselect import KSelectResult, select_k
from .mapping import PivotMapping, build_mapping, lims_value, ring_of_rank
from .metrics import MetricSpace, cdist, dist_one_to_many
from .paging import PageStore
from .pivots import fft_pivots
from .rankmodel import (PolyRankModel, SearchStats, binary_search,
                        exponential_search)
from .snapshot import LIMSSnapshot

__all__ = [
    "BatchedLIMS", "Clustering", "kcenter", "kmeans", "LIMSIndex",
    "QueryStats", "LIMSSnapshot", "QueryExecutor",
    "KSelectResult", "select_k", "PivotMapping", "build_mapping",
    "lims_value", "ring_of_rank", "MetricSpace", "cdist",
    "dist_one_to_many", "PageStore", "fft_pivots", "PolyRankModel",
    "SearchStats", "binary_search", "exponential_search",
]
