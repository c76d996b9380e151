"""Snapshot lifecycle: updates, double-buffered refresh, retrains.

Port of ``repro/serving/engine.py``.  ``ServingEngine`` owns

  * the host ``LIMSIndex`` (source of truth for §5.3 updates),
  * a double-buffered pair of snapshot executors: the *active* executor
    serves queries; ``refresh()`` builds a fresh ``LIMSSnapshot`` into
    the standby slot **off the hot path** and then swaps the two with a
    single attribute assignment — atomic under the GIL, so an in-flight
    batch that already grabbed the active executor keeps its consistent
    snapshot while new batches see the new one.  No query ever blocks on
    a rebuild and no query ever observes a half-built snapshot:
    ``LIMSSnapshot.build`` reads the certified bound E back to the host,
    so the build's device work on the building thread's stream has
    finished when it returns, before the swap.

Updates (``insert`` / ``delete`` / ``retrain_cluster``) go straight to
the host index and bump a mutation counter; once the counter reaches
``refresh_every`` the engine triggers a rebuild — synchronously by
default (deterministic for tests), or on a background thread with
``async_refresh=True`` (updates serialize with the rebuild via a lock;
queries never take it).  Between refreshes queries serve the last
snapshot — stale but consistent and exact with respect to that
snapshot (the reference's DESIGN.md §5).

During a refresh three snapshots are resident: active, standby and the
new one.  The swap drops the old standby; the executor holds no
reference cycle, so its device memory is freed as soon as no batch
holds it (and a paged generation's ``StoreView`` and mmaps with it).

Storage (the reference's DESIGN.md §7): with ``storage="paged"`` (or
``REPRO_STORAGE=paged``) every snapshot generation spills to
``storage_path`` and serves store-backed — row payloads on disk behind
an LRU page cache, query IO planned page-wise, no row tensor on the
device.  A refresh writes only the clusters whose rows changed as *new*
page extents and publishes with one atomic manifest swap; the
long-lived ``PagedStore`` keeps its warm cache across generations
because page ids are append-only.  :meth:`ServingEngine.from_spill` is
the cold-start path and :meth:`ServingEngine.compact` reclaims the
garbage extents writebacks leave behind.

Sharding (the reference's DESIGN.md §4): ``sharded``/``mesh`` pass to
``make_executor`` for every generation, so with a mesh (or, with
``sharded=None``, several visible cards) each snapshot serves through a
``ShardedExecutor`` on that mesh, and a refresh builds the standby's on
the same mesh.

:meth:`ServingEngine.frontend` puts the request frontend in front of
the engine: dynamic batching and admission control, then one plan per
batch routed over a replica set of the active snapshot, rebuilt when a
refresh publishes a new generation (``frontend.py``, ``router.py``,
``replicas.py``).
"""
from __future__ import annotations

import shutil
import tempfile
import threading
import weakref
from collections import deque

from ..core.executor import QueryExecutor, make_executor
from ..core.index import LIMSIndex
from ..core.snapshot import LIMSSnapshot
from ..obs import registry as _obs
from ..obs.trace import instant, span
from ..storage import (DEFAULT_CACHE_PAGES, DEFAULT_PAGE_BYTES, PagedStore,
                       storage_mode)


class ServingEngine:
    """Double-buffered snapshot serving over a mutable ``LIMSIndex``.

    ``device`` is where every snapshot generation is built and served
    (default ``cuda``; raises without a card; ``"cpu"`` runs the plain
    versions), and where a retrain the index routes to the device
    runs.  ``storage="paged"`` serves every generation from a paged
    store at ``storage_path`` (default a self-cleaning temporary
    directory) with ``page_bytes`` pages behind a ``cache_pages`` page
    cache; ``prefetch`` ("off" | "async"; None defers to
    ``REPRO_PREFETCH``) sets the paged executors' prefetch.
    ``sharded`` and ``mesh`` choose the executor as ``make_executor``
    does."""

    def __init__(self, index: LIMSIndex | None, *, refresh_every: int = 64,
                 sharded: bool | None = None, mesh=None,
                 async_refresh: bool = False,
                 build_backend: str | None = None,
                 storage: str | None = None,
                 storage_path: str | None = None,
                 page_bytes: int = DEFAULT_PAGE_BYTES,
                 cache_pages: int | None = DEFAULT_CACHE_PAGES,
                 prefetch: str | None = None, device=None,
                 _initial: QueryExecutor | None = None):
        if storage is None:
            storage = storage_mode() or None
        if storage not in (None, "paged"):
            raise ValueError(f"unknown storage mode {storage!r}")
        self._index = index
        self._sharded = sharded
        self._mesh = mesh
        self._device = device
        self._prefetch = prefetch
        self._storage = storage
        self._page_bytes = int(page_bytes)
        self._cache_pages = cache_pages
        self._store: PagedStore | None = None
        self._storage_path = storage_path
        if storage == "paged" and storage_path is None:
            self._storage_path = tempfile.mkdtemp(prefix="lims-store-")
            weakref.finalize(self, shutil.rmtree, self._storage_path,
                             ignore_errors=True)
        self._refresh_every = int(refresh_every)
        # online retrains default to "auto": the index routes each
        # retrain host-vs-device on the cluster's member row count
        # (core.index.RETRAIN_AUTO_ROWS); pass "device"/"host" to pin it
        self._build_backend = "auto" if build_backend is None \
            else build_backend
        self._async = bool(async_refresh)
        # guards host-index mutation + snapshot builds (never queries)
        self._update_lock = threading.Lock()
        # guards background-refresh thread bookkeeping
        self._thread_lock = threading.Lock()
        self._refresh_thread: threading.Thread | None = None
        self._refresh_again = False
        # what stopped the last background refresh; wait_refresh raises it
        self._refresh_error: BaseException | None = None
        self.generation = 0
        self.pending_mutations = 0
        # retrain recommendations surfaced by the monitor daemon
        # (bounded: a serving window, not a log)
        self._retrain_recs: deque = deque(maxlen=64)
        if _initial is not None:
            self._active: QueryExecutor = _initial
            view = _initial.snap.store
            # the engine holds the shared reader; snapshots hold
            # per-generation views of it
            self._store = view.base if view is not None else None
        else:
            self._active = self._build_executor()
        self._standby: QueryExecutor | None = None

    # ----------------------------------------------------------- cold start
    @classmethod
    def from_spill(cls, path: str, *, index: LIMSIndex | None = None,
                   sharded: bool | None = None, mesh=None,
                   cache_pages: int | None = DEFAULT_CACHE_PAGES,
                   prefetch: str | None = None, device=None,
                   **kw) -> "ServingEngine":
        """Cold-start a serving replica from a spilled snapshot directory
        (the port's or the reference's).

        Serving begins immediately — only the manifest and metadata load
        up front; row pages fault in on demand through the page cache.
        Without ``index`` the engine is read-only: updates and refreshes
        raise until a host index is supplied via :meth:`attach_index`.
        With ``index``, refreshes write back to ``path``.
        """
        snap = LIMSSnapshot.load(path, store=True, cache_pages=cache_pages,
                                 device=device)
        ex = make_executor(snap, sharded=sharded, mesh=mesh,
                           prefetch=prefetch)
        # refresh writebacks must keep the on-disk page geometry
        kw.setdefault("page_bytes", snap.store.manifest.page_bytes)
        return cls(index, storage="paged", storage_path=path,
                   sharded=sharded, mesh=mesh, cache_pages=cache_pages,
                   prefetch=prefetch, device=device, _initial=ex, **kw)

    def attach_index(self, index: LIMSIndex) -> None:
        """Give the engine its mutable host index (a cold-started engine
        becomes writable; the next refresh snapshots it)."""
        with self._update_lock:
            self._index = index

    def _require_index(self) -> LIMSIndex:
        if self._index is None:
            raise RuntimeError(
                "engine is read-only: no host index attached "
                "(use attach_index() once one is built)")
        return self._index

    # ------------------------------------------------------------ plumbing
    def _build_executor(self) -> QueryExecutor:
        snap = LIMSSnapshot.build(self._require_index(), self._device)
        if self._storage == "paged":
            snap.spill(self._storage_path, page_bytes=self._page_bytes)
            if self._store is None:
                self._store = PagedStore(self._storage_path,
                                         cache_pages=self._cache_pages)
            else:
                # adopt the freshly published generation: rewritten
                # clusters reference appended extents, cached pages of
                # untouched clusters stay warm (append-only page ids).
                # with_store then freezes the new layout into this
                # snapshot's view — executors still serving the previous
                # generation keep gathering through THEIR view, so the
                # swap can never remap an in-flight batch's slots.
                self._store.refresh()
            snap = snap.with_store(self._store)
        return make_executor(snap, sharded=self._sharded, mesh=self._mesh,
                             prefetch=self._prefetch)

    @property
    def index(self) -> LIMSIndex | None:
        return self._index

    @property
    def store(self) -> PagedStore | None:
        """The paged-store reader (None when serving resident)."""
        return self._store

    @property
    def executor(self) -> QueryExecutor:
        """The active executor; grab it once per batch for a consistent
        view across the whole batch."""
        return self._active

    @property
    def snapshot(self) -> LIMSSnapshot:
        return self._active.snap

    # ------------------------------------------------------------- queries
    # Each query method reads ``self._active`` exactly once: the batch
    # runs against that snapshot even if a refresh swaps mid-flight.
    def range_query_batch(self, Q, r):
        return self._active.range_query_batch(Q, r)

    def range_query(self, q, r: float):
        return self._active.range_query(q, r)

    def knn_query_batch(self, Q, k: int, **kw):
        return self._active.knn_query_batch(Q, k, **kw)

    def knn_query(self, q, k: int):
        return self._active.knn_query(q, k)

    # ------------------------------------------------------------- updates
    # The mutation counter is only ever read or written under
    # _update_lock (refresh() subtracts under the same lock), so
    # concurrent updaters and a background rebuild can't lose counts.
    # The threshold check happens after the lock is released — refresh()
    # re-takes it — so two racing updaters can at worst both trigger a
    # refresh, which is harmless (the second sees zero pending).
    def insert(self, p) -> int:
        with self._update_lock:
            gid = self._require_index().insert(p)
            self.pending_mutations += 1
            pending = self.pending_mutations
        self._maybe_refresh(pending)
        return gid

    def delete(self, q) -> int:
        with self._update_lock:
            removed = self._require_index().delete(q)
            self.pending_mutations += removed
            pending = self.pending_mutations
        if removed:
            self._maybe_refresh(pending)
        return removed

    def retrain_cluster(self, c: int) -> None:
        with self._update_lock:
            self._require_index().retrain_cluster(
                c, backend=self._build_backend, device=self._device)
            # a retrain rewrites cluster structure the snapshot mirrors;
            # force the next refresh decision regardless of the
            # insert/delete count
            self.pending_mutations += self._refresh_every
            pending = self.pending_mutations
        self._maybe_refresh(pending)

    def recommend_retrain(self, c: int, reason: str = "") -> dict:
        """Record a retrain recommendation for cluster ``c`` (bounded
        ring, newest kept) — the monitor daemon surfaces rank-model
        drift findings here under ``REPRO_MONITOR_RETRAIN=recommend``;
        operators (or the daemon's ``auto`` mode) act on them.  Returns
        the recorded entry."""
        rec = {"cluster": int(c), "reason": str(reason),
               "generation": self.generation}
        with self._update_lock:
            self._retrain_recs.append(rec)
        _obs.count("engine.retrain_recommendations")
        return rec

    def retrain_recommendations(self) -> list:
        """Pending retrain recommendations, oldest first."""
        with self._update_lock:
            return list(self._retrain_recs)

    def clear_retrain_recommendations(self) -> None:
        with self._update_lock:
            self._retrain_recs.clear()

    def compact(self):
        """Reclaim the paged store's garbage extents: rewrite live
        extents into a fresh pages file and swap manifests atomically
        (``PagedStore.compact``).  Serialized with updates and refreshes
        through the update lock — queries never block, and executors
        serving the pre-compaction generation keep their file pinned
        through their ``StoreView``.  No-op (returns None) when serving
        resident."""
        if self._store is None:
            return None
        with self._update_lock:
            return self._store.compact()

    def _maybe_refresh(self, pending: int) -> None:
        if self._refresh_every and pending >= self._refresh_every:
            if self._async:
                self._spawn_refresh()
            else:
                self.refresh()

    # ------------------------------------------------------------- refresh
    def refresh(self) -> None:
        """Rebuild the standby snapshot and swap it in atomically."""
        with self._update_lock:
            seen = self.pending_mutations
            with span("engine.snapshot_build",
                      {"pending_mutations": seen}):
                new = self._build_executor()
            # the swap: one attribute store (GIL-atomic); the previous
            # executor moves to standby, kept alive for in-flight
            # batches, and the old standby is dropped
            self._active, self._standby = new, self._active
            self.pending_mutations -= seen
            self.generation += 1
            _obs.count("engine.refreshes")
            instant("engine.snapshot_swap",
                    {"generation": self.generation})

    def _spawn_refresh(self) -> None:
        with self._thread_lock:
            if self._refresh_thread is not None:
                # a rebuild is running: ask it to go again before exiting
                # (its exit decision happens under this same lock, so the
                # request can never fall into a teardown window)
                self._refresh_again = True
                return
            t = threading.Thread(target=self._refresh_worker, daemon=True,
                                 name="lims-snapshot-refresh")
            self._refresh_thread = t
        t.start()

    def _refresh_worker(self) -> None:
        me = threading.current_thread()
        try:
            while True:
                self.refresh()
                with self._thread_lock:
                    if not self._refresh_again:
                        self._refresh_thread = None
                        return
                    self._refresh_again = False
        except Exception as e:
            # kept for wait_refresh, which raises it
            with self._thread_lock:
                self._refresh_error = e
            _obs.count("engine.refresh_errors")
        finally:
            # a failed build must not leave a dead thread registered:
            # wait_refresh would wait on it forever
            with self._thread_lock:
                if self._refresh_thread is me:
                    self._refresh_thread = None
                    self._refresh_again = False

    def wait_refresh(self) -> None:
        """Block until every requested background refresh has landed.
        Raises ``RuntimeError`` (from the cause) when a background
        refresh failed; the active snapshot is then the last one that
        was published."""
        while True:
            with self._thread_lock:
                t = self._refresh_thread
                err, self._refresh_error = self._refresh_error, None
            if err is not None:
                raise RuntimeError("a background refresh failed") from err
            if t is None:
                return
            t.join()

    # ------------------------------------------------------------ frontend
    def frontend(self, **kw) -> "ServingFrontend":
        """A request frontend over this engine: dynamic batching +
        admission control in front, plan-driven replica routing behind.
        Keyword arguments pass through to
        :class:`~repro_torch.serving.frontend.ServingFrontend`."""
        from .frontend import ServingFrontend
        return ServingFrontend(self, **kw)


__all__ = ["ServingEngine"]
