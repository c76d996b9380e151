"""Replica set: snapshot placement + per-replica load accounting.

Port of ``repro/serving/replicas.py``.  A :class:`ReplicaSet` places
one executor per serving replica, each bound to the *same* snapshot
generation with its device tensors on that replica's device
(``LIMSSnapshot.to``).  Host data (ids, validity, the host mirrors and
the generation-bound ``StoreView``) is shared by reference — so
replicas can never disagree about generation content, and every paged
replica gathers through the same page cache (one buffer pool, one set
of access counters, one pin ledger).  Replicas on the snapshot's own
device hold the snapshot's very tensors: four replicas on one card add
no device memory.

This is the *replicated* placement of the cluster axis: where
``ShardedExecutor`` splits the clusters over a mesh, a replica set
gives every device the whole cluster axis and partitions the *request*
stream instead — the router sends each query sub-batch to one replica,
chosen by TriPrune cluster ownership.  Both placements preserve
exactness (per-cluster state is self-contained; per-query results are
independent of batchmates); replication trades memory for routing
freedom and no cross-device merge on the hot path.

Cluster *ownership* is the routing preference, not a data partition:
every replica can execute any query bit-identically; ownership decides
which replica a query's TriPrune cluster set votes for.  The default is
round-robin (cluster k -> replica k mod R); :meth:`ReplicaSet.rebalance`
reassigns ownership greedily from a cluster-heat signal — by default
the page cache's access counters folded per extent
(``PagedStore.cluster_heat``), the storage -> placement feedback loop.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.executor import QueryExecutor
from ..core.snapshot import LIMSSnapshot
from ..obs import registry as _obs


class Replica:
    """One serving replica: an executor on a device + load counters."""

    def __init__(self, rid: int, device, ex: QueryExecutor):
        self.rid = rid
        self.device = device
        self.ex = ex
        self._lock = threading.Lock()
        self.batches = 0
        self.queries = 0

    def record(self, n_queries: int) -> None:
        with self._lock:
            self.batches += 1
            self.queries += n_queries
        _obs.count(f"replica.{self.rid}.batches")
        _obs.count(f"replica.{self.rid}.queries", n_queries)

    def stats(self) -> dict:
        with self._lock:
            return {"rid": self.rid, "device": str(self.device),
                    "batches": self.batches, "queries": self.queries}


def replica_devices(snapshot: LIMSSnapshot) -> list:
    """The devices a replica set over ``snapshot`` uses by default:
    every visible card for a snapshot on a card, the snapshot's own
    device otherwise (a snapshot the caller built on the CPU)."""
    if snapshot.device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [snapshot.device]


class ReplicaSet:
    """Executors over one snapshot generation, one per device.

    ``devices=None`` -> :func:`replica_devices`; ``n_replicas=None`` ->
    one replica per device (devices cycle when asked for more — four
    replicas on one card share its tensors).  A snapshot on a card never
    gets a CPU replica.  All replicas share the snapshot's host state,
    including its ``StoreView`` when paged.
    """

    def __init__(self, snapshot: LIMSSnapshot, n_replicas: int | None = None,
                 devices: list | None = None,
                 prefetch: str | None = None):
        devices = [torch.device(d) for d in devices] \
            if devices is not None else replica_devices(snapshot)
        if not devices:
            raise ValueError("a replica set needs at least one device")
        if snapshot.device.type == "cuda" and any(
                d.type != "cuda" for d in devices):
            raise ValueError("a snapshot on a card is served by card "
                             "replicas only")
        n = int(n_replicas) if n_replicas is not None else len(devices)
        if n < 1:
            raise ValueError("a replica set needs at least one replica")
        self.snapshot = snapshot
        self.K = snapshot.K
        self.members: list[Replica] = []
        for i in range(n):
            dev = devices[i % len(devices)]
            self.members.append(Replica(i, dev, QueryExecutor(
                snapshot.to(dev), prefetch=prefetch)))
        # ownership[k] = the replica cluster k's routing votes go to
        self._owner = np.arange(self.K, dtype=np.int64) % n
        self._own_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.members)

    @property
    def owner(self) -> np.ndarray:
        """(K,) replica id owning each cluster (routing preference)."""
        return self._owner.copy()

    def ownership(self) -> np.ndarray:
        """(R, K) bool ownership matrix (the router's vote weights)."""
        with self._own_lock:
            return self._owner[None, :] == \
                np.arange(len(self.members))[:, None]

    def cluster_heat(self) -> np.ndarray | None:
        """(K,) access heat from the page cache, or None when resident
        (no page counters to fold — the router falls back to its own
        routed-cluster counts)."""
        store = self.snapshot.store
        return store.cluster_heat() if store is not None else None

    def rebalance(self, heat: np.ndarray) -> np.ndarray:
        """Reassign cluster ownership from a heat signal: hottest
        cluster first, each to the replica with the least heat assigned
        so far — the greedy makespan balance.  Returns the new (K,)
        owner array.  Queries in flight are unaffected (ownership only
        biases future routing; results never depend on it)."""
        heat = np.asarray(heat, np.float64)
        if heat.shape != (self.K,):
            raise ValueError(f"heat must be shape ({self.K},)")
        R = len(self.members)
        owner = np.empty(self.K, np.int64)
        load = np.zeros(R, np.float64)
        for k in np.argsort(-heat, kind="stable"):
            r = int(np.argmin(load))
            owner[k] = r
            load[r] += heat[k]
        with self._own_lock:
            self._owner = owner
        return owner.copy()

    def set_ownership(self, owner: np.ndarray) -> None:
        """Install an explicit (K,) ownership map.  Exactness never
        depends on ownership, so any assignment is legal — this is how
        demos and tests inject placement drift (stale ownership vs live
        heat) for the monitor daemon to detect and repair."""
        owner = np.asarray(owner, np.int64)
        if owner.shape != (self.K,):
            raise ValueError(f"owner must be shape ({self.K},)")
        R = len(self.members)
        if owner.size and (owner.min() < 0 or owner.max() >= R):
            raise ValueError(f"owner ids must be in [0, {R})")
        with self._own_lock:
            self._owner = owner.copy()

    def load_stats(self) -> list:
        with self._own_lock:
            counts = np.bincount(self._owner, minlength=len(self.members))
        out = []
        for rep, c in zip(self.members, counts):
            st = rep.stats()
            st["owned_clusters"] = int(c)
            out.append(st)
        return out


__all__ = ["Replica", "ReplicaSet", "replica_devices"]
