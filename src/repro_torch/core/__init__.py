"""LIMS core (port of ``repro.core``): the host index and the device
query path — ``LIMSSnapshot`` (resident, or store-backed through
``repro_torch.storage``) -> ``Planner`` -> ``QueryExecutor``
(``make_executor``) -> ``ServingEngine`` (double-buffered refresh, from
``repro_torch.serving``), with ``BatchedLIMS`` as the one-shot shim."""
from .batched import BatchedLIMS
from .clustering import Clustering, kcenter, kmeans
from .executor import QueryExecutor, make_executor
from .index import LIMSIndex, QueryStats
from .kselect import KSelectResult, select_k
from .mapping import PivotMapping, build_mapping, lims_value, ring_of_rank
from .metrics import MetricSpace, cdist, dist_one_to_many
from .paging import PageStore
from .pivots import fft_pivots
from .rankmodel import (PolyRankModel, SearchStats, binary_search,
                        exponential_search)
from .snapshot import LIMSSnapshot, maybe_paged


def __getattr__(name: str):
    # lazy: ServingEngine lives in repro_torch.serving (core.serving is a
    # shim); importing it eagerly here would cycle through the serving
    # package while this module is still initializing
    if name == "ServingEngine":
        from ..serving.engine import ServingEngine
        return ServingEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BatchedLIMS", "Clustering", "kcenter", "kmeans", "LIMSIndex",
    "QueryStats", "LIMSSnapshot", "maybe_paged", "QueryExecutor",
    "make_executor",
    "ServingEngine",
    "KSelectResult", "select_k", "PivotMapping", "build_mapping",
    "lims_value", "ring_of_rank", "MetricSpace", "cdist",
    "dist_one_to_many", "PageStore", "fft_pivots", "PolyRankModel",
    "SearchStats", "binary_search", "exponential_search",
]
