"""Plan-driven routing: one CandidatePlan, dispatched by cluster
ownership.

Port of ``repro/serving/router.py``.  The planner already computes, per
batch, everything a router needs: the TriPrune cluster routing (which
clusters each query can possibly touch) and the full radius schedule.
``PlanRouter`` builds that plan exactly *once* — on its routing
executor, preserving the one-plan-per-batch property — then splits the
batch into per-replica sub-batches and executes each through
``plan.subset`` on its replica.

Assignment: each query's routed clusters vote for the replicas that own
them; the query goes to the replica with the most votes, ties broken
toward the replica with the least load (already-assigned batchmates
included, so one batch spreads under ties); a query whose TriPrune set
is empty (it will match nothing, or its kNN schedule starts elsewhere)
falls to round-robin.

Exactness: a plan row — mask, routing, schedule radius — is a function
of that query and the snapshot metadata alone, never of batchmates;
every execution stage preserves that independence (kernel math is
per-pair, certification and refinement are per-query).  So executing
any sub-batch of a plan on any replica of the same snapshot returns,
per query, exactly what the full batch on one executor returns —
routing is a pure performance decision.

Each sub-batch runs on a thread of its own (one group: on the caller's
thread) and ends in its own device-to-host readbacks; replicas on one
card share its current stream.  A replica whose kernel fails fails the
batch: the error is re-raised on the caller's thread.

Routed-cluster counts accumulate in ``routed_heat``;
:meth:`PlanRouter.rebalance` folds the page cache's per-cluster access
counters (falling back to ``routed_heat`` when resident) back into
replica ownership — the cache -> placement feedback loop.
"""
from __future__ import annotations

import threading

import numpy as np

from ..obs import registry as _obs
from ..obs.trace import span
from .replicas import ReplicaSet


class PlanRouter:
    """Dispatch query batches across a :class:`ReplicaSet` by plan."""

    def __init__(self, replicas: ReplicaSet):
        self.replicas = replicas
        # the routing executor: builds the batch's single plan (and owns
        # the pivot-distance seeding); replica 0 doubles as it, so a
        # one-replica set routes with no extra executor
        self.routing_ex = replicas.members[0].ex
        self.routed_heat = np.zeros(replicas.K, np.int64)
        self._lock = threading.Lock()
        self._rr = 0                    # round-robin cursor (empty routing)

    # ------------------------------------------------------------ queries
    def range_query_batch(self, Q, r):
        Q = np.atleast_2d(np.asarray(Q, np.float64))
        B = Q.shape[0]
        r_arr = np.broadcast_to(np.asarray(r, np.float64), (B,))
        plan = self.routing_ex.planner.plan_range(Q, r_arr)
        parts = self._dispatch(Q, plan, "execute_range")
        out = [None] * B
        for idx, res in parts:
            for j, b in enumerate(idx):
                out[b] = res[j]
        return out

    def knn_query_batch(self, Q, k: int, max_rounds: int = 64):
        Q = np.atleast_2d(np.asarray(Q, np.float64))
        B = Q.shape[0]
        k_eff = min(int(k), self.replicas.snapshot.live)
        if k_eff <= 0:
            return (np.empty((B, 0), np.int64), np.empty((B, 0)))
        plan = self.routing_ex.planner.plan_knn(Q, k_eff, max_rounds)
        parts = self._dispatch(Q, plan, "execute_knn")
        ids = np.empty((B, k_eff), np.int64)
        ds = np.empty((B, k_eff))
        for idx, (ids_p, ds_p) in parts:
            ids[idx] = ids_p
            ds[idx] = ds_p
        return ids, ds

    # ----------------------------------------------------------- dispatch
    def _assign(self, plan) -> np.ndarray:
        """(B,) replica id per query: ownership votes over the plan's
        TriPrune routing, least-loaded tie-break, round-robin for
        unrouted queries."""
        with span("router.assign", {"B": plan.B}):
            return self._assign_inner(plan)

    def _assign_inner(self, plan) -> np.ndarray:
        routing = plan.routing                       # (B, K) bool
        own = self.replicas.ownership()              # (R, K) bool
        votes = routing.astype(np.int64) @ own.T.astype(np.int64)  # (B, R)
        with self._lock:
            self.routed_heat += routing.sum(axis=0)
            load = np.array([m.queries for m in self.replicas.members],
                            np.float64)
            pick = np.empty(routing.shape[0], np.int64)
            for b in range(routing.shape[0]):
                v = votes[b]
                if v.max() == 0:
                    pick[b] = self._rr % len(self.replicas)
                    self._rr += 1
                else:
                    tied = np.nonzero(v == v.max())[0]
                    pick[b] = tied[int(np.argmin(load[tied]))]
                load[pick[b]] += 1.0    # spread batchmates under ties
        return pick

    def _dispatch(self, Q, plan, method: str) -> list:
        """[(query idx, sub-result)] per replica group; groups with >1
        replica run on threads (each replica works its own sub-batch
        concurrently)."""
        pick = self._assign(plan)
        groups = []
        for rep in self.replicas.members:
            idx = np.nonzero(pick == rep.rid)[0]
            if len(idx):
                groups.append((rep, idx))
        if _obs.enabled():
            reg = _obs.REGISTRY
            reg.counter("router.batches").inc()
            reg.counter("router.queries").inc(plan.B)
            reg.counter("router.subbatches").inc(len(groups))
            # how widely one batch spreads across the replica set (1 =
            # everything landed on a single replica)
            reg.histogram("router.replica_spread").observe(len(groups))
        results = [None] * len(groups)
        errors = [None] * len(groups)

        def run(g: int, rep, idx) -> None:
            try:
                with span("router.subbatch",
                          {"replica": rep.rid, "B": len(idx)}):
                    sub = plan.subset(idx, planner=rep.ex.planner,
                                      device=rep.device)
                    # the subset is bound to the replica's own planner,
                    # so execute_* keeps the thread's sync count: start
                    # the sub-batch's own here
                    rep.ex._tls.syncs = 0
                    results[g] = getattr(rep.ex, method)(Q[idx], sub)
                rep.record(len(idx))
            except BaseException as e:  # re-raised on the caller thread
                errors[g] = e

        with span("router.dispatch",
                  {"B": plan.B, "groups": len(groups)}):
            if len(groups) == 1:
                run(0, *groups[0])
            else:
                threads = [threading.Thread(target=run, args=(g, rep, idx),
                                            name=f"lims-route-r{rep.rid}")
                           for g, (rep, idx) in enumerate(groups)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        for err in errors:
            if err is not None:
                raise err
        return [(idx, res) for (rep, idx), res in zip(groups, results)]

    # ---------------------------------------------------------- placement
    def _heat(self) -> np.ndarray:
        """The current per-cluster heat signal: page-cache access
        counters when paged, routed-cluster counts when resident.
        Always length ``replicas.K``: sharded snapshots pad K to a
        device multiple while the store reports real clusters only, so
        the tail pads with zero heat (padding clusters hold no data)."""
        heat = self.replicas.cluster_heat()
        if heat is None or not heat.any():
            heat = self.routed_heat
        heat = np.asarray(heat, np.float64).reshape(-1)
        K = self.replicas.K
        if len(heat) < K:
            heat = np.pad(heat, (0, K - len(heat)))
        return heat[:K]

    def heat_skew(self) -> float:
        """How badly ownership mismatches heat: max per-replica owned
        heat over the per-replica mean (1.0 = balanced, R = one replica
        owns everything hot).  Published as the ``router.heat_skew``
        gauge — the heat-skew detector's input; the monitor daemon
        calls this as its per-tick probe."""
        heat = self._heat()
        own = self.replicas.ownership()              # (R, K) bool
        per = own.astype(np.float64) @ heat          # (R,)
        total = per.sum()
        if total <= 0 or len(per) <= 1:
            skew = 1.0
        else:
            skew = float(per.max() / (total / len(per)))
        _obs.set_gauge("router.heat_skew", skew)
        return skew

    def rebalance(self) -> np.ndarray:
        """Fold the current heat signal into replica ownership: the page
        cache's per-cluster access counters when paged, the router's own
        routed-cluster counts when resident."""
        with span("router.rebalance"):
            moved = self.replicas.rebalance(self._heat())
        _obs.count("router.rebalances")
        return moved

    def load_stats(self) -> dict:
        return {"replicas": self.replicas.load_stats(),
                "routed_heat": self.routed_heat.tolist()}


__all__ = ["PlanRouter"]
