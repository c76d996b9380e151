"""The serving stack (port of ``repro/serving``).

Request path, top to bottom::

    ServingFrontend   dynamic batching + admission control (frontend)
        PlanRouter    one CandidatePlan per batch, sub-batches to
                      replicas by TriPrune cluster ownership (router)
        ReplicaSet    executors over the snapshot, one per device,
                      per-replica load stats (replicas)
    ServingEngine     snapshot lifecycle: updates, double-buffered
                      refresh, retrains, storage, compaction (engine)

``MonitorDaemon`` closes the monitoring loop: heat-skew findings
rebalance the router's replica ownership, rank-drift findings recommend
or run retrains on the engine.  Every layer preserves exactness:
per-query results are independent of batchmates and of which replica
executes them, so a query submitted through the frontend returns
bit-identical results to a direct ``QueryExecutor`` call.
``repro_torch.core.serving`` remains as a shim for ``ServingEngine``.
"""
from .daemon import MonitorDaemon
from .engine import ServingEngine
from .frontend import FrontendOverload, ServingFrontend
from .replicas import Replica, ReplicaSet
from .router import PlanRouter

__all__ = ["ServingEngine", "ServingFrontend", "FrontendOverload",
           "MonitorDaemon", "Replica", "ReplicaSet", "PlanRouter"]
