"""Async page prefetcher: overlap upcoming rounds' page IO with kernel
refinement.

Port of ``repro/storage/prefetch.py``.

The kNN schedule is deterministic (``CandidatePlan``: round t's radius
is ``seed · 2^t``), so the paged backend knows round t+1's IOPlan before
round t's refinement has run.  This module turns that plan into a
background fetch: a single daemon worker drains a queue of page lists
and pulls them into the store's cache (under the store's own lock, so it
composes with concurrent query threads for free), while the main thread
runs the round's ``pdist`` refinement and certification.  When the next
round issues its synchronous fetch, the pages are already resident —
the fetch degrades to cache hits and the round's IO cost has been hidden
behind compute.

Speculation is bounded and safe: a prefetched page the batch never ends
up needing (its queries all certified in the meantime) cost one wasted
background read, never a wrong result — correctness is entirely the
store's (idempotent, locked) fetch path.  Prefetch IO bypasses the
store's buffer-pool counters (``record=False``) so the per-query IO
metrics keep meaning "what the queries demanded"; the prefetcher keeps
its own ledger instead, including two numbers worth reading: the *hit rate* (fraction of prefetched pages a later round
actually demanded — speculation accuracy) and *overlapped rounds*
(rounds whose background IO completed before the demand fetch arrived —
proof the overlap actually happened).

``REPRO_PREFETCH=async`` enables the prefetcher on paged executors;
unset/anything else keeps today's fully synchronous behavior.

Shutdown: the worker is a daemon thread, but daemon teardown at
interpreter exit can kill it mid-``fetch_pages`` while library state is
being finalized — so ``shutdown_prefetch`` (registered with ``atexit``)
stops it deliberately: it sets the shutdown flag, enqueues a sentinel,
and joins with a timeout.  In-flight IOPlans are *dropped*, not drained
— speculative IO has no correctness obligation and exit shouldn't wait
on disk — and every dropped plan is counted on its prefetcher
(``dropped_plans`` / ``pages_dropped`` in ``snapshot()``), so a caller
that cares can see exactly what the close threw away.
"""
from __future__ import annotations

import atexit
import queue
import threading
from dataclasses import dataclass, field

import numpy as np

from .. import env
from ..obs import registry as _obs


def prefetch_mode() -> str:
    """Process-wide prefetch policy: ''/off (synchronous) or 'async'
    (``REPRO_PREFETCH``, validated by ``repro_torch.env``)."""
    return env.get("REPRO_PREFETCH")


@dataclass
class PrefetchTicket:
    """One submitted round's prefetch: its pages + completion event."""

    pages: np.ndarray
    _event: threading.Event = field(default_factory=threading.Event)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)


# one shared daemon worker drains every prefetcher's submissions: a
# process can hold many paged executors (one per snapshot generation,
# per engine, per test...) and a thread per executor would pile up —
# speculative IO is background work, one background thread is enough.
# The worker owns no state a crash could corrupt (each store's lock
# serializes the actual cache/mmap mutation), so process teardown needs
# no handshake.
_QUEUE: queue.SimpleQueue = queue.SimpleQueue()
_WORKER_LOCK = threading.Lock()
_WORKER: threading.Thread | None = None
_SHUTDOWN = threading.Event()
_SENTINEL = object()
_EMPTY_PAGES = np.empty(0, np.int64)    # shared drain-marker payload


def _drop(prefetcher, pages) -> None:
    """Account a plan the shutdown discarded (drain markers — empty
    page lists — are control flow, not dropped IO)."""
    if prefetcher is not None and len(pages):
        with prefetcher._lock:
            prefetcher.dropped_plans += 1
            prefetcher.pages_dropped += len(pages)


def _worker_loop() -> None:
    while True:
        item = _QUEUE.get()
        if item is _SENTINEL:
            return
        prefetcher, pages, ev = item
        try:
            if _SHUTDOWN.is_set():
                _drop(prefetcher, pages)
            elif len(pages):
                prefetcher.store.fetch_pages(pages, record=False)
                with prefetcher._lock:
                    prefetcher.pages_fetched += len(pages)
                _obs.count("prefetch.pages_fetched", len(pages))
        except Exception:
            # a failed speculative read is a missed optimization, not an
            # error: the demand fetch will read (and raise) for real if
            # the page genuinely matters
            pass
        finally:
            ev.set()


def _ensure_worker() -> None:
    global _WORKER
    if _SHUTDOWN.is_set():
        return                          # closing: no restarts
    with _WORKER_LOCK:
        if _WORKER is None or not _WORKER.is_alive():
            _WORKER = threading.Thread(
                target=_worker_loop, daemon=True, name="lims-page-prefetch")
            _WORKER.start()


def shutdown_prefetch(timeout: float = 2.0) -> bool:
    """Stop the shared worker deliberately (atexit hook; callable early
    by tests).  Queued plans behind the flag are dropped-and-counted by
    the worker on its way to the sentinel; the join timeout bounds exit
    latency if the worker is wedged mid-read.  Returns True when the
    worker is (or was already) fully stopped.  Irreversible for the
    process: later ``submit`` calls drop immediately."""
    global _WORKER
    _SHUTDOWN.set()
    with _WORKER_LOCK:
        w = _WORKER
        if w is None or not w.is_alive():
            _WORKER = None
            return True
        _QUEUE.put(_SENTINEL)
        w.join(timeout)
        stopped = not w.is_alive()
        if stopped:
            _WORKER = None
        return stopped


def drain_queue(timeout: float | None = None) -> bool:
    """Block until every plan queued so far (from any prefetcher) has
    been processed.  The shared worker touches stores — and therefore
    the obs gauges — from its own thread, so anything measuring
    allocation or metric quiescence must drain first.  Returns False on
    timeout; True when the queue was empty or became empty (including
    after shutdown, when nothing can be in flight)."""
    if _SHUTDOWN.is_set():
        return True
    with _WORKER_LOCK:
        if _WORKER is None or not _WORKER.is_alive():
            return True
    ev = threading.Event()
    _QUEUE.put((None, _EMPTY_PAGES, ev))
    return ev.wait(timeout)


def _restart_for_tests() -> None:
    """Undo a test-invoked shutdown so the rest of the suite keeps its
    prefetcher (production exits never restart — atexit is terminal)."""
    shutdown_prefetch()
    _SHUTDOWN.clear()


atexit.register(shutdown_prefetch)


class PagePrefetcher:
    """Background fetcher bound to one store (view), sharing the
    process-wide worker thread.  ``submit`` never blocks;
    ``note_demand`` is the accounting hook the paged backend calls right
    before each round's synchronous fetch.
    """

    def __init__(self, store):
        self.store = store
        self._lock = threading.Lock()
        self.submitted = 0           # tickets with at least one page
        self.pages_submitted = 0
        self.pages_fetched = 0
        self.demand_hits = 0         # prefetched pages a round demanded
        self.overlapped_rounds = 0   # rounds whose prefetch beat demand
        self.dropped_plans = 0       # plans the shutdown discarded
        self.pages_dropped = 0

    # ------------------------------------------------------------------ api
    def submit(self, pages: np.ndarray) -> PrefetchTicket:
        """Queue a background fetch; returns immediately.  After
        ``shutdown_prefetch`` the plan is dropped-and-counted instead
        (its ticket completes at once, with nothing fetched)."""
        pages = np.asarray(pages, np.int64)
        t = PrefetchTicket(pages)
        if len(pages) == 0:
            t._event.set()
            return t
        with self._lock:
            self.submitted += 1
            self.pages_submitted += len(pages)
        _obs.count("prefetch.rounds_submitted")
        _obs.count("prefetch.pages_submitted", len(pages))
        if _SHUTDOWN.is_set():
            _drop(self, pages)
            t._event.set()
            return t
        _ensure_worker()
        _QUEUE.put((self, pages, t._event))
        return t

    def note_demand(self, pages: np.ndarray,
                    ticket: PrefetchTicket | None = None) -> None:
        """Account a round's demand fetch against the prefetch submitted
        for it last round: ``pages`` is what the round is about to fetch
        synchronously; a ticket page the round demands is a hit
        (speculation accuracy — a page prefetched for queries that
        certified in the meantime is the wasted-IO miss case), and a
        ticket already complete at demand time is a fully overlapped
        round."""
        if ticket is None or not len(ticket.pages):
            return
        dem = {int(p) for p in pages}
        hits = sum(1 for p in ticket.pages if int(p) in dem)
        overlapped = ticket.done()
        with self._lock:
            self.demand_hits += hits
            if overlapped:
                self.overlapped_rounds += 1
        # speculation accuracy, process-wide: demand_hits /
        # pages_submitted is the fraction of speculative IO a later
        # round actually wanted
        _obs.count("prefetch.demand_hits", hits)
        if overlapped:
            _obs.count("prefetch.overlapped_rounds")

    def drain(self) -> None:
        """Block until every prefetch queued so far has completed (a
        shut-down worker has nothing left to wait for)."""
        if _SHUTDOWN.is_set():
            return
        ev = threading.Event()
        _ensure_worker()
        _QUEUE.put((self, np.empty(0, np.int64), ev))
        ev.wait()

    def reset(self) -> None:
        """Zero the counters (a caller isolating one workload)."""
        with self._lock:
            self.submitted = self.pages_submitted = 0
            self.pages_fetched = self.demand_hits = 0
            self.overlapped_rounds = 0
            self.dropped_plans = self.pages_dropped = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "mode": "async",
                "submitted_rounds": self.submitted,
                "pages_submitted": self.pages_submitted,
                "pages_fetched": self.pages_fetched,
                "demand_hits": self.demand_hits,
                "hit_rate": round(
                    self.demand_hits / max(self.pages_submitted, 1), 4),
                "overlapped_rounds": self.overlapped_rounds,
                "dropped_plans": self.dropped_plans,
                "pages_dropped": self.pages_dropped,
            }


__all__ = ["PagePrefetcher", "PrefetchTicket", "drain_queue",
           "prefetch_mode", "shutdown_prefetch"]
