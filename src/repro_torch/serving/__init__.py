"""The serving stack (port of ``repro/serving``): the snapshot lifecycle
(``ServingEngine``: updates, double-buffered refresh, retrains) and the
closed monitoring loop (``MonitorDaemon``).  The request frontend, the
plan router and the replica set wait for ROADMAP A10."""
from .daemon import MonitorDaemon
from .engine import ServingEngine

__all__ = ["ServingEngine", "MonitorDaemon"]
