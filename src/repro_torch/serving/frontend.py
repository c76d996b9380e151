"""Layer 4 of the serving stack: the request frontend.

Port of ``repro/serving/frontend.py``.  Kernels want batches; users
send single queries.  ``ServingFrontend`` bridges the two with *dynamic
batching*: submitters enqueue one query each and block; a batcher
thread coalesces compatible requests — same kind, same k — into one
kernel-shaped batch, dispatching when the batch fills (``max_batch``)
or the oldest request's latency budget (``slo_ms``) expires, whichever
is first.  Per-query results are independent of batchmates (the
router's exactness argument), so a coalesced query returns
bit-identical results to a direct ``QueryExecutor`` call.

Admission control is shed-on-overload: the queue is bounded
(``max_queue``) and a submit that finds it full fails *immediately*
with :class:`FrontendOverload` rather than queueing into a latency it
can't meet (callers retry against another frontend or back off).  Shed
requests cost the engine nothing: no plan, no kernel launch, no page
IO.

Behind the batcher sits the plan-driven router over a replica set
(``router``/``replicas``); the frontend tracks its engine's snapshot
generation and rebuilds the replica set after a refresh lands, so
batches never mix generations (each batch runs on the replica set it
was dispatched to — the same atomic-grab contract the engine's own
query methods keep).  Over a sharded engine the replicas are plain
executors over the engine's padded snapshot: sharding and replication
do not compose.  A batch whose replica fails (a kernel that does not
build or launch) fails every request in it, with that error.

``pause()``/``resume()`` hold the batcher between dispatches —
deterministic coalescing and overload in tests and benchmarks, never
needed in production.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..obs import monitor as _mon
from ..obs import registry as _obs
from ..obs.monitor import Monitor
from ..obs.registry import Histogram
from ..obs.trace import instant, span
from .daemon import MonitorDaemon
from .replicas import ReplicaSet
from .router import PlanRouter


class FrontendOverload(RuntimeError):
    """Admission control shed this request: the queue was full."""


class _Request:
    __slots__ = ("kind", "q", "arg", "t_in", "t_run", "event", "result",
                 "error")

    def __init__(self, kind: str, q: np.ndarray, arg):
        self.kind = kind
        self.q = q
        self.arg = arg
        self.t_in = time.monotonic()
        self.t_run = None
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None

    @property
    def key(self):
        # range queries coalesce regardless of radius (radii are a (B,)
        # plan input); kNN batches share k (k shapes outputs and plan)
        return (self.kind, self.arg if self.kind == "knn" else None)


class ServingFrontend:
    """Dynamic-batching, admission-controlled frontend over an engine
    (or a bare executor — anything with ``.executor``/``.snap``)."""

    def __init__(self, target, *, n_replicas: int | None = None,
                 max_batch: int = 32, slo_ms: float = 2.0,
                 max_queue: int = 256, prefetch: str | None = None,
                 slo_target_ms: float | None = None,
                 monitor: "bool | Monitor | None" = None):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        # engine-like targets expose .executor + .generation; a bare
        # executor serves one frozen generation
        self._engine = target if hasattr(target, "executor") else None
        self._executor = None if self._engine is not None else target
        self._n_replicas = n_replicas
        self._prefetch = prefetch
        self._max_batch = int(max_batch)
        self._slo = float(slo_ms) / 1e3
        self._max_queue = int(max_queue)
        self._cv = threading.Condition()
        self._pending: list[_Request] = []
        self._paused = False
        self._closed = False
        # metrics (all mutated under self._cv).  Distributions live in
        # bounded reservoirs — a long-running frontend holds O(cap)
        # metric memory, not one float per request ever served.  These
        # are *instance* histograms recording unconditionally:
        # ``metrics()`` is part of the frontend's API contract and must
        # work with REPRO_OBS=off; the process-wide registry mirrors
        # are the mode-gated part.
        self._submitted = 0
        self._shed = 0
        self._batches = 0
        self._coalesced = 0
        self._size_hist = Histogram("frontend.batch_size")
        self._wait_hist = Histogram("frontend.queue_wait_s")
        # end-to-end completion SLO: slo_ms bounds *coalescing wait*;
        # the completion target a request is judged against must also
        # absorb execution, so it defaults to 20x the batching budget.
        # A shed request burns budget too — it counts as a miss.
        self._slo_target = (float(slo_target_ms) if slo_target_ms is not None
                            else 20.0 * float(slo_ms)) / 1e3
        self._slo_ok = 0
        self._slo_miss = 0
        self._lat_hist = Histogram("frontend.request_latency_s")
        self._router_obj: PlanRouter | None = None
        self._gen: int | None = None
        self._batcher = threading.Thread(
            target=self._batch_loop, daemon=True, name="lims-frontend")
        self._batcher.start()
        # continuous health monitoring (the reference's DESIGN.md §12):
        # None → the REPRO_MONITOR knob; True / a Monitor instance force
        # it on.  The daemon subscribes the router + engine to the
        # findings and the monitor thread samples until close().
        self.monitor: Monitor | None = None
        self.daemon: MonitorDaemon | None = None
        if monitor is None:
            monitor = _mon.monitor_enabled()
        if monitor:
            mon = monitor if isinstance(monitor, Monitor) else Monitor()
            self.monitor = mon
            self.daemon = MonitorDaemon(mon, lambda: self._router_obj,
                                        engine=self._engine)
            mon.start()

    # ------------------------------------------------------------- submit
    def range_query(self, q, r: float):
        """Submit one range query; blocks until its batch returns.
        Returns ``(ids, dists)`` exactly as ``QueryExecutor.range_query``.
        """
        return self._submit(_Request(
            "range", np.asarray(q, np.float64), float(r)))

    def knn_query(self, q, k: int):
        """Submit one kNN query; blocks until its batch returns."""
        return self._submit(_Request(
            "knn", np.asarray(q, np.float64), int(k)))

    def _submit(self, req: _Request):
        with self._cv:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if len(self._pending) >= self._max_queue:
                self._shed += 1
                self._slo_miss += 1
                _obs.count("frontend.shed")
                _obs.count("frontend.slo_miss")
                instant("frontend.shed", {"pending": len(self._pending)})
                raise FrontendOverload(
                    f"queue full ({self._max_queue} pending)")
            self._submitted += 1
            _obs.count("frontend.submitted")
            self._pending.append(req)
            self._cv.notify_all()
        req.event.wait()
        self._record_latency(time.monotonic() - req.t_in)
        if req.error is not None:
            raise req.error
        return req.result

    def _record_latency(self, lat: float) -> None:
        """Judge one completed request against the completion SLO (the
        submitter's thread measures its own end-to-end latency: queue
        wait + execution + wakeup)."""
        ok = lat <= self._slo_target
        with self._cv:
            self._lat_hist.observe(lat)
            if ok:
                self._slo_ok += 1
            else:
                self._slo_miss += 1
        if _obs.enabled():
            reg = _obs.REGISTRY
            reg.histogram("frontend.request_latency_s").observe(lat)
            reg.counter(
                "frontend.slo_ok" if ok else "frontend.slo_miss").inc()

    # ------------------------------------------------------------ batcher
    def _batch_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._execute(batch)

    def _next_batch(self) -> list | None:
        """Block until a batch is due: the oldest request's key gathers
        batchmates until ``max_batch`` or its SLO deadline."""
        with self._cv:
            while not self._closed and (self._paused or not self._pending):
                self._cv.wait()
            if not self._pending:       # closed and drained
                return None
            first = self._pending[0]
            deadline = first.t_in + self._slo
            while not self._closed:
                n = sum(1 for r in self._pending if r.key == first.key)
                left = deadline - time.monotonic()
                if n >= self._max_batch or left <= 0:
                    break
                self._cv.wait(left)
            batch = [r for r in self._pending
                     if r.key == first.key][:self._max_batch]
            for r in batch:
                self._pending.remove(r)
            return batch

    def _execute(self, batch: list) -> None:
        t_run = time.monotonic()
        try:
            with span("frontend.execute",
                      {"B": len(batch), "kind": batch[0].kind}):
                router = self._router()
                Q = np.stack([r.q for r in batch])
                if batch[0].kind == "range":
                    rs = np.array([r.arg for r in batch], np.float64)
                    for r, res in zip(batch,
                                      router.range_query_batch(Q, rs)):
                        r.result = res
                else:
                    ids, ds = router.knn_query_batch(Q, batch[0].arg)
                    for j, r in enumerate(batch):
                        r.result = (ids[j], ds[j])
        except BaseException as e:
            for r in batch:
                r.error = e
        finally:
            waits = [t_run - r.t_in for r in batch]
            self._obs_record(len(batch), waits)
            for r in batch:
                r.t_run = t_run
                r.event.set()

    def _obs_record(self, size: int, waits: list) -> None:
        """Fold one dispatched batch into the frontend's bounded metrics
        and (mode permitting) the process-wide registry."""
        with self._cv:
            self._batches += 1
            if size >= 2:
                self._coalesced += 1
            self._size_hist.observe(size)
            for w in waits:
                self._wait_hist.observe(w)
        if _obs.enabled():
            reg = _obs.REGISTRY
            reg.counter("frontend.batches").inc()
            reg.counter("frontend.queries").inc(size)
            if size >= 2:
                reg.counter("frontend.coalesced_batches").inc()
            reg.histogram("frontend.batch_size").observe(size)
            wh = reg.histogram("frontend.queue_wait_s")
            for w in waits:
                wh.observe(w)

    def _router(self) -> PlanRouter:
        """The router for the current snapshot generation (batcher-thread
        only); a landed refresh rebuilds the replica set."""
        gen = self._engine.generation if self._engine is not None else 0
        if self._router_obj is None or gen != self._gen:
            ex = self._engine.executor if self._engine is not None \
                else self._executor
            with span("frontend.replica_rebuild", {"generation": gen}):
                self._router_obj = PlanRouter(ReplicaSet(
                    ex.snap, n_replicas=self._n_replicas,
                    prefetch=self._prefetch))
            _obs.count("frontend.replica_rebuilds")
            self._gen = gen
        return self._router_obj

    # ---------------------------------------------------------- lifecycle
    def pause(self) -> None:
        """Hold the batcher between dispatches (tests/benchmarks)."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, drain what's queued, join the
        batcher."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._batcher.join(timeout)
        if self.monitor is not None:
            self.monitor.stop()

    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        """Frontend-side serving metrics: achieved batch sizes, queue
        wait percentiles, shed rate — plus per-replica load when the
        router has run."""
        with self._cv:
            submitted, shed = self._submitted, self._shed
            batches, coalesced = self._batches, self._coalesced
            slo_ok, slo_miss = self._slo_ok, self._slo_miss
        router = self._router_obj
        out = {
            "submitted": submitted,
            "shed": shed,
            "shed_rate": round(shed / max(submitted + shed, 1), 4),
            "slo_target_ms": round(self._slo_target * 1e3, 3),
            "slo_ok": slo_ok,
            "slo_miss": slo_miss,
            "slo_attained": round(slo_ok / max(slo_ok + slo_miss, 1), 4),
            "latency_ms_p50": round(
                self._lat_hist.percentile(50) * 1e3, 3),
            "latency_ms_p99": round(
                self._lat_hist.percentile(99) * 1e3, 3),
            "batches": batches,
            "batch_size_mean": round(self._size_hist.mean, 2)
            if batches else 0.0,
            "batch_size_max": int(self._size_hist.max) if batches else 0,
            "coalesced_batches": coalesced,
            "queue_wait_ms_p50": round(
                self._wait_hist.percentile(50) * 1e3, 3),
            "queue_wait_ms_p99": round(
                self._wait_hist.percentile(99) * 1e3, 3),
        }
        if router is not None:
            out["routing"] = router.load_stats()
        return out


__all__ = ["ServingFrontend", "FrontendOverload"]
