"""The paged store: append-only mmap file of cluster extents.

Port of ``repro/storage/store.py``; it writes and reads the reference's
format byte for byte.

Writer (``spill_rows``): lays each cluster's ``n_max`` slot rows (f64,
mapped-value order — the order the learned positions predict) into a
contiguous extent of fixed-size pages inside the generation's pages
file.  Incremental spills reuse the extents of clusters whose row bytes
are unchanged (sha1 in the manifest) and *append* extents for dirty
ones; the new generation is published with one atomic manifest swap
(``repro_torch.storage.manifest``).  A pages file is never rewritten in
place, so live readers — and their page caches — stay valid across
swaps.

Compaction (``PagedStore.compact``): append-only writebacks leave
garbage extents behind.  ``compact()`` rewrites the *live* extents into
a fresh pages file (named per generation) and publishes it with the same
atomic manifest swap; the old file is unlinked, but in-flight readers
keep serving through it because every generation-bound ``StoreView``
pins the (layout, pages file) pair it was created under, and an open
mmap keeps an unlinked file's bytes alive.  Page ids restart in the new
file, so the cache keys pages by (file, id) — ids are immutable *within*
a file, which preserves the never-invalidate property per generation.

Reader (``PagedStore``): read-only ``np.memmap``s over the pages files
plus an LRU page cache with access counters.  ``fetch`` takes an
``IOPlan`` (deduplicated, run-coalesced page list from the IO-batch
scheduler) and reads each missing run as one sequential slice;
``gather`` returns the f64 rows for a set of flat slot ids through the
cache, which is both the kernels' filter input (cast to f32 — the
same cast the resident snapshot applies) and the exact f64 refinement
input, so store-backed results are bit-identical to the in-memory path.
``record=False`` lets the async prefetcher pull pages in without
touching the demand-side buffer-pool counters (its IO is speculative;
the demand metrics keep meaning what queries asked for) — its reads
are charged to ``stats.prefetch_reads`` instead, so misses +
prefetch_reads always equals total page IO.
"""
from __future__ import annotations

import hashlib
import io
import os
import threading
import weakref

import numpy as np

from ..obs import registry as _obs
from .cache import DEFAULT_CACHE_PAGES, CacheStats, LRUPageCache
from .layout import DEFAULT_PAGE_BYTES, PageLayout, rows_per_page
from .manifest import FORMAT_VERSION, PAGES_NAME, Manifest, write_atomic
from .scheduler import IOPlan, page_runs


def _cluster_hashes(rows64: np.ndarray) -> list:
    return [hashlib.sha1(np.ascontiguousarray(rows64[k]).tobytes())
            .hexdigest() for k in range(rows64.shape[0])]


def spill_rows(root: str, rows64: np.ndarray,
               page_bytes: int = DEFAULT_PAGE_BYTES,
               meta_arrays: dict | None = None) -> Manifest:
    """Write (or incrementally refresh) the paged row store under ``root``.

    ``rows64``: (K, n_max, d) f64 cluster-major slot rows.  When a
    compatible manifest already exists, unchanged clusters keep their
    extents and only dirty clusters append new pages ("retrained
    clusters write back as new page extents") — into whatever pages file
    the current generation references (a compaction may have renamed
    it); otherwise every cluster gets a fresh extent (still
    append-only).  ``meta_arrays`` (optional) lands in a
    generation-stamped ``meta-<gen>.npz`` referenced by the manifest,
    published together by the atomic manifest swap.
    """
    K, n_max, d = rows64.shape
    rows64 = np.ascontiguousarray(rows64, dtype=np.float64)
    os.makedirs(root, exist_ok=True)
    prev = Manifest.load(root) if Manifest.exists(root) else None
    rpp = rows_per_page(page_bytes, d)
    reusable = (prev is not None and prev.n_max == n_max and prev.d == d
                and prev.rows_per_page == rpp and prev.K == K)
    if prev is not None and not reusable and (prev.d != d or
                                              prev.rows_per_page != rpp):
        raise ValueError(
            "store geometry changed (d or page size); spill to a fresh "
            "directory instead of mixing record formats in one file")
    hashes = _cluster_hashes(rows64)
    ppc = -(-n_max // rpp)
    next_page = prev.total_pages if prev is not None else 0
    extents, dirty = [], []
    for k in range(K):
        if reusable and prev.cluster_sha1[k] == hashes[k]:
            extents.append(prev.extents[k])
        else:
            extents.append(next_page)
            dirty.append(k)
            next_page += ppc

    pages_file = prev.pages_file if prev is not None else PAGES_NAME
    pages_path = os.path.join(root, pages_file)
    stride_rows = ppc * rpp
    with open(pages_path, "r+b" if prev is not None else "wb") as f:
        for k in dirty:
            block = np.zeros((stride_rows, d), np.float64)
            block[:n_max] = rows64[k]
            f.seek(extents[k] * rpp * d * 8)
            f.write(block.tobytes())
        f.flush()
        os.fsync(f.fileno())

    gen = prev.generation + 1 if prev is not None else 0
    meta_file = ""
    if meta_arrays is not None:
        meta_file = f"meta-{gen}.npz"
        buf = io.BytesIO()
        np.savez(buf, **meta_arrays)
        write_atomic(os.path.join(root, meta_file), buf.getvalue())
    man = Manifest(version=FORMAT_VERSION, generation=gen,
                   page_bytes=page_bytes, rows_per_page=rpp, d=d,
                   n_max=n_max, K=K, total_pages=next_page,
                   extents=extents, cluster_sha1=hashes,
                   pages_file=pages_file,
                   meta_file=meta_file or (prev.meta_file if prev else ""))
    man.save(root)
    # prune stale metas, but never one a live manifest can reference:
    # the one just published (possibly carried forward from an older
    # generation) or the previous manifest's (a reader that loaded it
    # moments ago must still find its meta)
    keep = {man.meta_file} | ({prev.meta_file} if prev else set())
    for name in os.listdir(root):
        if name.startswith("meta-") and name.endswith(".npz") \
                and name not in keep:
            g = int(name[5:-4])
            if g < gen - 1:
                os.unlink(os.path.join(root, name))
    return man


def load_meta(root: str) -> tuple[dict, Manifest]:
    """Read the manifest and its generation's metadata arrays."""
    man = Manifest.load(root)
    if not man.meta_file:
        raise FileNotFoundError(f"store at {root!r} has no metadata file")
    with np.load(os.path.join(root, man.meta_file)) as z:
        meta = {k: z[k] for k in z.files}
    return meta, man


class PagedStore:
    """mmap reader over a spilled store: page cache + IO accounting."""

    def __init__(self, root: str,
                 cache_pages: int | None = DEFAULT_CACHE_PAGES):
        self.root = root
        self.manifest = Manifest.load(root)
        self.cache = LRUPageCache(cache_pages)
        self.stats = CacheStats()
        # serializes cache/mmap mutation: executors share one reader
        # across concurrent lock-free query threads (the resident path's
        # immutability argument doesn't cover the page cache), so page
        # IO is the one place store-mode queries serialize.  Reentrant —
        # gather() fetches missing pages under its own lock; the async
        # prefetcher's background fetches take the same lock.
        self._lock = threading.RLock()
        # pages files by name: the current generation's plus any older
        # ones still pinned by generation-bound views (a compaction
        # retires a file from the manifest, but its mmap lives here
        # until the last view of it dies, so in-flight readers keep
        # their bytes even after the unlink — and the disk blocks ARE
        # freed once those views go away, see _prune_maps)
        self._maps: dict[str, np.memmap] = {}
        self._view_refs: dict[str, weakref.WeakSet] = {}
        self._map()

    def _map(self) -> None:
        """(Re)map the current manifest's pages file."""
        man = self.manifest
        self.layout: PageLayout = man.layout()
        n_rows = man.total_pages * man.rows_per_page
        self._maps[man.pages_file] = np.memmap(
            os.path.join(self.root, man.pages_file), dtype="<f8", mode="r",
            shape=(max(n_rows, 1), man.d))

    def _register_view(self, view: "StoreView") -> None:
        """Track which pages files live views pin (weakly — a dead view
        stops pinning automatically)."""
        with self._lock:
            self._view_refs.setdefault(view.file, weakref.WeakSet()) \
                .add(view)

    def _prune_maps(self) -> None:
        """Drop mmaps of non-current files no live view pins (called
        under the lock).  Closing the last mapping of an unlinked
        pages file is what actually returns its disk blocks — without
        this, compaction would only ever *rename* garbage."""
        cur = self.manifest.pages_file
        for name in list(self._maps):
            if name == cur:
                continue
            refs = self._view_refs.get(name)
            if refs is None or not len(refs):
                del self._maps[name]
                self._view_refs.pop(name, None)

    def _mmap_for(self, file: str) -> np.memmap:
        mm = self._maps.get(file)
        if mm is None:
            # a view bound before this reader existed (cross-process
            # race); best effort by size — raises if compaction already
            # unlinked the file
            path = os.path.join(self.root, file)
            n_rows = os.path.getsize(path) // (self.manifest.d * 8)
            mm = np.memmap(path, dtype="<f8", mode="r",
                           shape=(max(int(n_rows), 1), self.manifest.d))
            self._maps[file] = mm
        return mm

    @property
    def generation(self) -> int:
        return self.manifest.generation

    @property
    def pages_file(self) -> str:
        return self.manifest.pages_file

    def refresh(self) -> "PagedStore":
        """Adopt the latest published manifest (after a writer swap).

        Within one pages file page ids are append-only, so cached pages
        stay byte-valid and a rewritten cluster simply references new
        ids; a compaction switches the manifest to a fresh file, which
        maps alongside the old one (views pinned to the old file keep
        gathering through it).
        """
        with self._lock:
            man = Manifest.load(self.root)
            if man.generation != self.manifest.generation:
                self.manifest = man
                self._map()
            self._prune_maps()
        return self

    # ------------------------------------------------------------------ io
    def fetch_pages(self, pages: np.ndarray, file: str | None = None,
                    record: bool = True) -> None:
        """Ensure ``pages`` (of ``file``; default the current
        generation's) are cached; missing ones read as runs.
        ``record=False`` skips the demand-side buffer-pool counters —
        the async prefetcher's speculative IO — but the reads still
        land in ``prefetch_reads``, so misses + prefetch_reads is
        always the total page IO (no invisible reads)."""
        with self._lock:
            file = file if file is not None else self.manifest.pages_file
            st = self.stats
            missing = []
            hits = 0
            for pid in np.asarray(pages, dtype=np.int64):
                pid = int(pid)
                if record:
                    st.requests += 1
                if self.cache.touch((file, pid)):
                    hits += 1
                else:
                    missing.append(pid)
            if record:
                st.hits += hits
                _obs.count("storage.page_requests", len(pages))
                _obs.count("storage.cache_hits", hits)
            if not missing:         # fully cache-resident: no file IO,
                return              # and no mapping of a retired file
            rpp = self.layout.rows_per_page
            mm = self._mmap_for(file)
            evs = 0
            for a, b in page_runs(np.asarray(missing, np.int64)):
                block = np.array(mm[a * rpp:b * rpp], dtype=np.float64)
                for j, pid in enumerate(range(a, b)):
                    evs += self.cache.put(
                        (file, pid), block[j * rpp:(j + 1) * rpp])
                if record:
                    st.misses += b - a
                else:
                    st.prefetch_reads += b - a
            # evictions are real whoever triggered the insert — an
            # uncounted speculative insert could silently thrash the pool
            st.evictions += evs
            _obs.count("storage.page_reads" if record
                       else "storage.prefetch_reads", len(missing))
            if evs:
                _obs.count("storage.evictions", evs)

    def fetch(self, plan: IOPlan, file: str | None = None) -> None:
        """Execute an IO-batch plan: each deduped page read at most once
        (and not at all when cache-resident)."""
        self.fetch_pages(plan.pages, file=file)

    # ------------------------------------------------------ schedule pins
    def pin_pages(self, pages: np.ndarray, file: str | None = None) -> None:
        """Hold ``pages`` against capacity eviction for a planned batch
        (refcounted; pinning before the fetch is fine — the hold applies
        on insert).  Callers must pair with ``unpin_pages`` — the paged
        backend does so in a ``finally`` so an executor error can't leak
        a batch's pins."""
        with self._lock:
            file = file if file is not None else self.manifest.pages_file
            self.cache.pin([(file, int(p)) for p in np.asarray(pages)])
            pinned = self.cache.pinned
        _obs.count("storage.page_pins", len(pages))
        _obs.set_gauge("storage.pinned_pages", pinned)

    def unpin_pages(self, pages: np.ndarray,
                    file: str | None = None) -> None:
        """Release one batch's holds; pages rejoin plain LRU at the
        recency their accesses earned, and any pin-era overflow evicts
        immediately (counted with the regular eviction stats)."""
        with self._lock:
            file = file if file is not None else self.manifest.pages_file
            evs = self.cache.unpin(
                [(file, int(p)) for p in np.asarray(pages)])
            self.stats.evictions += evs
            pinned = self.cache.pinned
        if evs:
            _obs.count("storage.evictions", evs)
        _obs.set_gauge("storage.pinned_pages", pinned)

    def cluster_heat(self, layout: PageLayout | None = None,
                     file: str | None = None) -> np.ndarray:
        """(K,) page-cache access counts folded per cluster extent — the
        demand signal the router's replica placement consumes (hot
        clusters get replicated / reassigned first).  Counts accumulate
        across the store's lifetime; callers diff snapshots for a rate.
        """
        with self._lock:
            lay = layout if layout is not None else self.layout
            file = file if file is not None else self.manifest.pages_file
            ppc = lay.pages_per_cluster
            K = len(lay.extents)
            owner = {}                      # page id → cluster (this gen)
            for k in range(K):
                base = int(lay.extents[k])
                for p in range(base, base + ppc):
                    owner[p] = k
            heat = np.zeros(K, np.int64)
            for (f, pid), cnt in self.cache.access.items():
                k = owner.get(pid) if f == file else None
                if k is not None:
                    heat[k] += cnt
            return heat

    def gather(self, slots: np.ndarray, layout: PageLayout | None = None,
               file: str | None = None) -> np.ndarray:
        """(len(slots), d) f64 rows for flat slot ids, through the cache.

        ``layout``/``file`` map slots for a specific store generation (a
        ``StoreView`` passes its frozen pair); default is the current
        manifest's.  Pages already resident are *not* re-counted as
        cache requests — the buffer-pool stats reflect the planned
        fetches, while gather is the data access behind them (only a
        page evicted between fetch and gather costs a genuine re-read).
        """
        lay = layout if layout is not None else self.layout
        slots = np.asarray(slots, dtype=np.int64)
        out = np.empty((len(slots), lay.d), np.float64)
        if len(slots) == 0:
            return out
        with self._lock:
            file = file if file is not None else self.manifest.pages_file
            pages, offs = lay.slot_locations(slots)
            missing = [int(p) for p in np.unique(pages)
                       if self.cache.peek((file, int(p))) is None]
            if missing:
                self.fetch_pages(np.asarray(missing, np.int64), file=file)
            order = np.argsort(pages, kind="stable")
            sp, so = pages[order], offs[order]
            bounds = np.concatenate(
                [[0], np.nonzero(np.diff(sp))[0] + 1, [len(sp)]])
            for a, b in zip(bounds[:-1], bounds[1:]):
                block = self.cache.peek((file, int(sp[a])))
                if block is None:           # evicted under tiny capacity
                    self.fetch_pages(sp[a:a + 1], file=file)
                    block = self.cache.peek((file, int(sp[a])))
                out[order[a:b]] = block[so[a:b]]
            self.stats.rows_gathered += len(slots)
        _obs.count("storage.rows_gathered", len(slots))
        return out

    def view(self, layout: PageLayout | None = None,
             file: str | None = None) -> "StoreView":
        """Freeze a generation's (layout, pages file) into a view (what
        a snapshot binds to — see ``StoreView``); default the current."""
        return StoreView(self, layout, file)

    def record_queries(self, pages_per_query, cand_per_query) -> None:
        """Record per-query serving metrics under the store lock (the
        executor is shared across lock-free query threads; unsynchronized
        read-modify-writes would lose counts)."""
        with self._lock:
            self.stats.record_queries(pages_per_query, cand_per_query)
        _obs.count("storage.queries", len(pages_per_query))
        _obs.count("storage.pages_touched", int(np.sum(pages_per_query)))
        _obs.count("storage.candidates", int(np.sum(cand_per_query)))

    def read_cluster(self, k: int) -> np.ndarray:
        """(n_max, d) f64 bulk read of one cluster extent (no cache —
        used by the resident loader, not the query path)."""
        a, b = self.layout.cluster_file_rows(k)
        with self._lock:
            return np.array(self._mmap_for(self.manifest.pages_file)[a:b],
                            dtype=np.float64)

    # ------------------------------------------------------------ lifecycle
    def compact(self, unlink_old: bool = True) -> Manifest:
        """Rewrite the live extents into a fresh pages file and publish
        it with an atomic manifest swap.

        Repeated retrain writebacks append new extents and orphan the
        old ones; compaction reclaims that garbage: every cluster's
        current extent is copied, in cluster order, into
        ``pages-<gen>.bin`` (dense extents, ``K · pages_per_cluster``
        total pages), the manifest flips to it atomically, and the old
        file is unlinked (``unlink_old``).  In-flight readers are
        untouched: their ``StoreView``s pin the old (layout, file) pair
        and the already-open mmap keeps the unlinked bytes readable
        until the views die.  Metadata (``meta-*.npz``) is untouched —
        compaction moves rows, not models.

        The copy reads through a fresh mmap sized to the *latest
        published* manifest — never this reader's possibly older one —
        so extents appended since the last ``refresh()`` are copied in
        full.  Published extents are immutable, so the rewrite runs
        outside the store lock (queries never block on it); only the
        adoption of the new manifest serializes with fetch/gather.
        Concurrent *writers* must be serialized by the caller, as for
        ``spill_rows`` (``ServingEngine.compact`` holds its update
        lock).
        """
        man = Manifest.load(self.root)     # latest published
        lay = man.layout()
        rpp = man.rows_per_page
        ppc = lay.pages_per_cluster
        stride = ppc * rpp
        src = np.memmap(os.path.join(self.root, man.pages_file),
                        dtype="<f8", mode="r",
                        shape=(max(man.total_pages * rpp, 1), man.d))
        new_name = f"pages-{man.generation + 1}.bin"
        path = os.path.join(self.root, new_name)
        with open(path, "wb") as f:
            for k in range(man.K):
                a = int(man.extents[k]) * rpp
                f.write(np.ascontiguousarray(
                    src[a:a + stride], dtype="<f8").tobytes())
            f.flush()
            os.fsync(f.fileno())
        new_man = Manifest(
            version=FORMAT_VERSION, generation=man.generation + 1,
            page_bytes=man.page_bytes, rows_per_page=rpp, d=man.d,
            n_max=man.n_max, K=man.K, total_pages=man.K * ppc,
            extents=[k * ppc for k in range(man.K)],
            cluster_sha1=list(man.cluster_sha1),
            pages_file=new_name, meta_file=man.meta_file)
        new_man.save(self.root)
        if unlink_old:
            for name in os.listdir(self.root):
                if name != new_name and (
                        name == PAGES_NAME or
                        (name.startswith("pages-") and
                         name.endswith(".bin"))):
                    os.unlink(os.path.join(self.root, name))
        with self._lock:
            self.manifest = new_man
            self._map()
            self._prune_maps()
        return new_man

    def drop_os_cache(self) -> bool:
        """Best-effort eviction of every pages file from the OS page
        cache, so the next cold pass reads from the device (the
        ``REPRO_REAL_IO=1`` mode).  True when the platform supports
        the advice.

        ``POSIX_FADV_DONTNEED`` cannot evict pages a live mapping pins,
        so files still on disk are *remapped*: the old mmap is dropped
        (its cached page blocks are copies, nothing dangles), the
        advice runs against an unmapped file, and a fresh mmap comes
        back cold.  Unlinked files (pre-compaction generations pinned
        by in-flight views) are left mapped — they have no disk
        presence to evict anyway."""
        if not hasattr(os, "posix_fadvise"):
            return False
        with self._lock:
            names = [n for n in set(self._maps) | {self.manifest.pages_file}
                     if os.path.exists(os.path.join(self.root, n))]
            for name in names:
                self._maps.pop(name, None)      # munmap: release the pin
            for name in names:
                path = os.path.join(self.root, name)
                fd = os.open(path, os.O_RDONLY)
                try:
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            self._map()                         # remap current, cold
        return True

    def nbytes_file(self) -> int:
        return os.path.getsize(os.path.join(self.root,
                                            self.manifest.pages_file))


class StoreView:
    """One snapshot's binding to a ``PagedStore``: the generation's
    (layout, pages file) frozen at bind time.

    The reader is shared and mutable (``refresh()`` adopts newer
    manifests so a serving engine reuses one warm cache across
    generations), but a snapshot's slot ids are only meaningful under
    the extents of *its* generation — so each snapshot gathers through
    a view that captured them.  Within a pages file page ids are
    append-only, which keeps an old view's extents byte-valid (and its
    cached pages correct) after any number of later writebacks; across
    a compaction the view additionally pins the *file*, whose open mmap
    outlives the unlink — which is exactly what lets an in-flight batch
    on a pre-swap executor finish correctly.
    """

    def __init__(self, store: PagedStore, layout: PageLayout | None = None,
                 file: str | None = None):
        self.base = store
        # an explicit layout/file pins a specific generation (the
        # snapshot loader passes the pair matching the metadata it just
        # read, so a concurrent writeback between the two reads can't
        # mismatch them)
        self.layout = layout if layout is not None else store.layout
        self.file = file if file is not None else store.manifest.pages_file
        store._register_view(self)

    def gather(self, slots: np.ndarray) -> np.ndarray:
        return self.base.gather(slots, layout=self.layout, file=self.file)

    def fetch(self, plan: IOPlan) -> None:
        self.base.fetch_pages(plan.pages, file=self.file)

    def fetch_pages(self, pages: np.ndarray, record: bool = True) -> None:
        self.base.fetch_pages(pages, file=self.file, record=record)

    def pin_pages(self, pages: np.ndarray) -> None:
        self.base.pin_pages(pages, file=self.file)

    def unpin_pages(self, pages: np.ndarray) -> None:
        self.base.unpin_pages(pages, file=self.file)

    def cluster_heat(self) -> np.ndarray:
        return self.base.cluster_heat(layout=self.layout, file=self.file)

    def __getattr__(self, name):
        # everything generation-agnostic (stats, cache, manifest,
        # generation, record_queries, nbytes_file, ...) delegates
        return getattr(self.base, name)


__all__ = ["PagedStore", "StoreView", "spill_rows", "load_meta"]
