"""Plan *execution* over a snapshot, and exact host refinement.

Port of ``repro/core/executor.py``, single device.  The planner
(``planner.py``) builds one :class:`CandidatePlan` per query batch and
one of two backends executes it.  ``_ResidentBackend`` runs the kernels
over the snapshot's device rows:

  * range: the fused L2-ball prefilter (``range_filter``) applied to the
    plan's device mask — by default (``REPRO_COMPACT=on``) over the
    plan's compacted candidate gather, the union certified candidate
    rows gathered once into a power-of-two bucket, so filter bytes
    scale with TriPrune's survivors instead of padded slots;
  * kNN: the certified growing-radius schedule driven from the host,
    one round at a time (the reference's ``_knn_host_rounds``): a
    ``pdist`` distance matrix over every slot, the plan math per round,
    and ``torch.topk`` for the k-th distance.

``_PagedBackend`` serves a store-backed snapshot (``snap.store`` set;
the storage tier, the reference's DESIGN.md §7–§8): the plan's masks
become deduplicated, run-coalesced page IO through the snapshot's
``StoreView``; ``range_filter`` (range) and ``pdist`` (each kNN round's
newly gathered rows) run on the gathered rows, cast to f32 on the host
and copied to the device through a pinned staging buffer; the round's
schedule mask is the planner's ``eval_mask`` (``pdist_rankeval`` on
CUDA).  With ``REPRO_PREFETCH=async`` round t+1's pages are fetched on
a background thread while round t's kernels run.

Exactness contract: results are bit-identical to the host ``LIMSIndex``
— the plan's masks are a certified superset of the candidates, kNN
rounds certify only once the k-th ball provably fits inside the round
radius minus the guard band, and the final refinement recomputes f64
distances on the host.

Every batch is observed as in the reference (``REPRO_OBS``, default
on): ``execute_range``/``execute_knn`` wrap the backend and the
refinement in ``executor.*`` spans and record one ``QueryProfile``
(``last_profile``), with the batch's observed rank-model error replayed
in host f32 over up to 32 certified candidates.  Profiling adds no
device→host copy: it reads the final mask the backend returned and the
snapshot's host mirrors (``host_syncs`` are equal with ``REPRO_OBS`` on
and off).

Left for later slices: the sharded executor (ROADMAP A9), the compiled
device kNN loop and the reduced-precision plane.
"""
from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from ..kernels import ops
from ..kernels.dispatch import compact_enabled
from ..obs import registry as _obs
from ..obs.profile import QueryProfile, record_profile
from ..obs.trace import span
from ..storage import (PagePrefetcher, cache_pin_mode, plan_batch,
                       prefetch_mode)
from .metrics import dist_one_to_many
from .planner import (_BALL_ABS, _R_REL, _SEED_REL, CandidatePlan, Planner,
                      plan_arrays)
from .snapshot import LIMSSnapshot

def _bucket_size(n: int, min_rows: int = 128) -> int:
    """Next power-of-two row bucket (≥ ``min_rows``) for ``n`` rows."""
    return max(min_rows, 1 << max(n - 1, 1).bit_length())


def _kth_smallest(dm: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) k-th smallest value per row (``lax.top_k`` in the reference)."""
    return torch.topk(dm, k, dim=1, largest=False, sorted=True).values[:, -1]


def _knn_round_masks(d2, cand, rf, eps):
    """One round's certified ball mask, candidate count and masked
    distance matrix (the reference's jitted ``_knn_round_masks``)."""
    ball = d2 <= ((rf * (1.0 + _R_REL) + _BALL_ABS + eps) ** 2)[:, None]
    candb = cand & ball
    cnt = torch.sum(candb, dim=1)
    dm = torch.where(candb, d2, torch.full_like(d2, float("inf")))
    return candb, cnt, dm


def _resident_only(snap: LIMSSnapshot) -> None:
    if snap.store is not None:
        raise RuntimeError(
            "store-backed executor never scans every slot; the kNN "
            "driver routes through the paged backend")


class _ResidentBackend:
    """In-memory execution: kernels over the snapshot's device rows."""

    name = "resident"

    def __init__(self, ex: "QueryExecutor"):
        # weak: the executor owns its backend (see QueryExecutor)
        self.ex = weakref.proxy(ex)

    def release(self, plan: CandidatePlan) -> None:
        """No storage, nothing pinned."""

    def range_hits(self, plan: CandidatePlan) -> np.ndarray:
        ex = self.ex
        rf = torch.from_numpy(plan.radii.astype(np.float32)).to(
            plan.qf.device)
        if compact_enabled():
            slots = plan.compact_slots()
            if slots is not None:
                return self._range_hits_compact(plan, rf, slots)
        ex.last_compact = None
        hits = plan.mask_dev & ex._ball_filter(plan.qf, rf)
        hits = hits.cpu().numpy()
        ex._count_sync()
        return hits

    def _range_hits_compact(self, plan: CandidatePlan, rf,
                            slots: np.ndarray) -> np.ndarray:
        """Ball prefilter over the plan's compacted candidate gather.

        Bit-identical to the full-array path: the gathered rows are the
        very rows the full filter would stream, per-pair kernel math is
        independent of which rows share a launch, the bucket's padding
        rows are sliced off the mask, and slots outside the union are
        non-candidates for the whole batch in both paths.  The gather
        stays in the filter plane's type."""
        ex = self.ex
        s = ex.snap
        cand = plan.mask
        hits = np.zeros_like(cand)
        bucket = 0
        if slots.size:
            frows, eps = s.filter_rows()
            sub = frows.reshape(s.n_slots, s.d)[
                torch.from_numpy(slots).to(s.device)]
            bucket = _bucket_size(int(slots.size))
            if bucket > slots.size:
                sub = torch.cat([sub, ops.far_rows(bucket - slots.size,
                                                   sub)])
            ball, _ = ops.range_filter(
                plan.qf, sub, rf * (1.0 + _R_REL) + _BALL_ABS + eps)
            ball = ball[:, :slots.size].cpu().numpy().astype(bool)
            ex._count_sync()
            hits[:, slots] = cand[:, slots] & ball
        ex.last_compact = {"slots": int(slots.size), "bucket": int(bucket),
                           "n_slots": int(s.n_slots)}
        _obs.count("executor.compact_batches")
        if s.n_slots:
            _obs.observe("executor.compact_frac",
                         slots.size / float(s.n_slots))
        return hits

    def knn_candidates(self, plan: CandidatePlan):
        """The certified growing-radius schedule, one host-driven round
        at a time: seed skip-ahead to the first schedule radius that
        covers the k-th distance estimate, the guard-band certification
        per query, and the exact full scan for anything the schedule
        never certifies.  The certified set is a superset of the closed
        k-th ball, so refinement returns the host index's results."""
        ex = self.ex
        s = ex.snap
        qf = plan.qf
        k_eff = plan.k
        d2, eps = ex._filter_dists(qf)
        kth0 = torch.sqrt(torch.clamp(_kth_smallest(d2, k_eff), min=0.0))
        r0 = torch.from_numpy(plan.radii.astype(np.float32)).to(qf.device)
        seed = kth0 * (1.0 + _SEED_REL) + _BALL_ABS
        t0 = torch.ceil(torch.log2(torch.clamp(seed, min=1e-30) / r0))
        r = (r0 * torch.exp2(torch.clamp(t0, min=0.0))).cpu().numpy()
        ex._count_sync()
        B = plan.B
        done = np.zeros(B, bool)
        final = np.zeros((B, s.n_slots), bool)
        rounds = 0
        for t in range(plan.max_rounds):
            rounds = t + 1
            rf = torch.from_numpy(r).to(qf.device)
            cand = ex._plan_arrays(qf, rf)[0]
            candb, cnt, dm = _knn_round_masks(d2, cand, rf, eps)
            kth = torch.sqrt(torch.clamp(_kth_smallest(dm, k_eff), min=0.0))
            ok = ((cnt >= k_eff) &
                  (kth <= rf * (1.0 - _R_REL) - _BALL_ABS - eps))
            ok = ok.cpu().numpy()
            ex._count_sync()
            newly = ok & ~done
            if newly.any():
                sel = torch.from_numpy(newly).to(qf.device)
                final[newly] = candb[sel].cpu().numpy()
                done |= newly
            if done.all():
                break
            r = np.where(done, r, r * 2.0)
        else:
            final[~done] = s.valid_np[None]
        ex.last_driver = "rounds"
        return final, rounds


class _PagedBackend:
    """Storage-tier execution: the plan's masks drive page IO.

    Round t's certified mask becomes a deduplicated, run-coalesced
    ``IOPlan``; rows are gathered through the snapshot's
    generation-bound ``StoreView`` and refined with the same kernels.
    With a prefetcher attached (``REPRO_PREFETCH=async``), round t+1's
    IOPlan — known from the schedule before round t's refinement starts
    — is fetched on a background thread while the kernels run, so the
    next round's fetch finds its pages already resident.

    Gathered rows reach the kernels unpadded.  The reference pads them
    to a power-of-two bucket of far rows (``_pad_bucket``) only to bound
    XLA recompiles; the CUDA kernels take any point count, and per-pair
    math does not depend on which other rows share a launch, so masks
    and distances are the same without the up-to-2x extra bytes.
    """

    name = "paged"

    def __init__(self, ex: "QueryExecutor", prefetch: str | None = None):
        # weak: the executor owns its backend (see QueryExecutor), so a
        # generation a swap drops frees its StoreView and mmaps too
        self.ex = weakref.proxy(ex)
        mode = prefetch_mode() if prefetch is None else str(prefetch).lower()
        self.prefetcher = PagePrefetcher(ex.snap.store) \
            if mode == "async" else None
        # the pinned staging buffer, one a thread: executors serve
        # lock-free concurrent query threads (see _to_device)
        self._tls = threading.local()

    # --------------------------------------------------------- staging
    def _to_device(self, rows64: np.ndarray) -> torch.Tensor:
        """Gathered f64 rows as f32 on the snapshot's device.

        The cast runs on the host, as in the reference: it halves the
        bytes sent over PCIe and gives the same f32 bits as a cast on
        the device.  On a CUDA device the rows go through one reused
        pinned staging buffer (one a query thread, grown to the largest
        gather) with a ``non_blocking`` copy on the current stream.
        Design: a single buffer, refilled only after the previous copy's
        kernel result has been read back — every paged round ends in
        that readback (``.cpu()``), which waits for the stream, so the
        copy has landed before the next refill.  A copy moved onto a
        side stream would need two buffers and events between them."""
        dev = self.ex.snap.device
        if dev.type != "cuda":
            return torch.from_numpy(rows64.astype(np.float32))
        n, d = rows64.shape
        buf = getattr(self._tls, "staging", None)
        if buf is None or buf.numel() < n * d:
            buf = torch.empty(n * d, dtype=torch.float32, pin_memory=True)
            self._tls.staging = buf
        host = buf[:n * d].view(n, d)
        np.copyto(host.numpy(), rows64, casting="same_kind")
        return host.to(dev, non_blocking=True)

    # ----------------------------------------------------- schedule pins
    def _pin(self, plan: CandidatePlan, pages: np.ndarray) -> None:
        """Pin one round's planned pages for the plan's lifetime
        (``REPRO_CACHE_PIN=off`` reverts to blind LRU).  The ledger
        lives on the plan so ``release`` can drain it even when the
        executor errors mid-batch."""
        if len(pages) and cache_pin_mode():
            self.ex.snap.store.pin_pages(pages)
            plan._pins.append(pages)

    def release(self, plan: CandidatePlan) -> None:
        """Drop every page hold this plan's execution took (idempotent:
        the ledger drains)."""
        store = self.ex.snap.store
        pins, plan._pins = plan._pins, []
        for pages in pins:
            store.unpin_pages(pages)

    # ------------------------------------------------------------- range
    def range_hits(self, plan: CandidatePlan) -> np.ndarray:
        """Same candidate mask as the resident path, ball prefilter on
        gathered pages.  Per-pair kernel math is independent of which
        other rows share a launch and the gathered f32 rows are the same
        downcast the resident snapshot holds, so the mask is identical
        to the in-memory path."""
        ex = self.ex
        store = ex.snap.store
        cand = plan.mask
        io = plan_batch(cand, store.layout)
        # schedule-aware eviction: the batch's planned pages stay pinned
        # until execute_*'s finally releases the plan — a squeezed cache
        # can't evict them between fetch, gather and exact refinement
        self._pin(plan, io.pages)
        store.fetch(io)
        hits = np.zeros_like(cand)
        if len(io.slots):
            rows64 = store.gather(io.slots)
            rf = torch.from_numpy(plan.radii.astype(np.float32)).to(
                plan.qf.device)
            ball, _ = ops.range_filter(plan.qf, self._to_device(rows64),
                                       rf * (1.0 + _R_REL) + _BALL_ABS)
            ball = ball.cpu().numpy().astype(bool)
            ex._count_sync()
            hits[:, io.slots] = cand[:, io.slots] & ball
        store.record_queries(io.pages_per_query, io.cand_per_query)
        ex.last_io = io.summary()
        ex.last_io["pinned_pages"] = sum(len(p) for p in plan._pins)
        return hits

    # --------------------------------------------------------------- kNN
    def knn_candidates(self, plan: CandidatePlan):
        """Growing-radius rounds whose IO is the candidate pages.

        Each round evaluates the plan's schedule mask for the whole
        batch, fetches only pages not yet resident (the scheduler
        dedupes; earlier rounds' pages are cache hits — Alg. 2's
        never-re-read-a-page contract), computes f32 distances on the
        newly gathered rows with the same ``pdist`` kernel, and
        certifies per query with the resident rounds' guard-band test.
        The certified set is a superset of the closed k-th ball, so
        refinement returns results bit-identical to the in-memory
        executor."""
        ex = self.ex
        ex.last_driver = "paged"
        s = ex.snap
        store = s.store
        pf = self.prefetcher
        qf = plan.qf
        B, k_eff = plan.B, plan.k
        r = plan.radii.copy()
        done = np.zeros(B, bool)
        final = np.zeros((B, s.n_slots), bool)
        pos = np.full(s.n_slots, -1, np.int64)   # slot → gathered column
        d2g = np.empty((B, 0), np.float32)       # sq dists, gathered slots
        pages_seen = [set() for _ in range(B)]   # per-query IO metric
        seen = np.zeros((B, s.n_slots), bool)    # per-query fetched cands
        cand_next = plan.mask                    # round-0 schedule mask
        ticket = None
        rounds = 0
        for t in range(plan.max_rounds):
            rounds = t + 1
            cand = cand_next.copy()
            cand_next = None
            cand[done] = False        # frozen queries stop driving IO
            # per_query=False: the pages_seen sets below are this
            # driver's cross-round page accounting
            io = plan_batch(cand, store.layout, per_query=False)
            if pf is not None:
                pf.note_demand(io.pages, ticket)
                ticket = None
            # pin before the fetch: earlier rounds' pages a later round
            # re-demands (growing radii are supersets) stay resident
            # until execute_knn's finally releases the plan
            self._pin(plan, io.pages)
            store.fetch(io)
            # pages(∪ rounds) = ∪ pages(new slots per round): only map
            # slots not already charged to the query
            newly = cand & ~seen
            seen |= cand
            for b in np.nonzero(newly.any(axis=1))[0]:
                pages_seen[b].update(store.layout.slot_pages(
                    np.nonzero(newly[b])[0]).tolist())
            new = io.slots[pos[io.slots] < 0]
            if len(new):
                rows64 = store.gather(new)
                pos[new] = d2g.shape[1] + np.arange(len(new))
            # the schedule fixes round t+1's radius before round t's
            # refinement runs — evaluate its mask now and hand the page
            # IO of the genuinely new slots (``exclude``: everything
            # this or an earlier round gathered) to the background
            # prefetcher, overlapping the kernel work below
            if pf is not None and t + 1 < plan.max_rounds:
                spec_r = np.where(done, r, r * 2.0)
                cand_next = ex.planner.eval_mask(qf, spec_r)
                spec = cand_next.copy()
                spec[done] = False
                pio = plan_batch(spec, store.layout, per_query=False,
                                 exclude=pos >= 0)
                self._pin(plan, pio.pages)   # speculative pages too
                ticket = pf.submit(pio.pages)
            if len(new):
                d2_new = ops.pdist(qf, self._to_device(rows64))
                d2_new = d2_new.cpu().numpy()
                ex._count_sync()
                d2g = np.concatenate([d2g, d2_new], axis=1)
            r32 = np.asarray(r, np.float32)
            thr = (r32 * np.float32(1.0 + _R_REL) +
                   np.float32(_BALL_ABS)) ** 2    # f32 guard-band ball
            cert = r32 * np.float32(1.0 - _R_REL) - np.float32(_BALL_ABS)
            for b in np.nonzero(~done)[0]:
                sl = np.nonzero(cand[b])[0]
                if len(sl) < k_eff:
                    continue
                db = d2g[b, pos[sl]]
                inball = db <= thr[b]
                if int(inball.sum()) < k_eff:
                    continue
                kth = np.sqrt(np.float32(max(
                    np.partition(db[inball], k_eff - 1)[k_eff - 1], 0.0)))
                # same certification as the resident rounds: the k-th
                # ball fits strictly inside the round radius minus the
                # f32 guard band
                if kth <= cert[b]:
                    final[b, sl[inball]] = True
                    done[b] = True
            if done.all():
                break
            r = np.where(done, r, r * 2.0)
            if cand_next is None and t + 1 < plan.max_rounds:
                cand_next = ex.planner.eval_mask(qf, r)
        else:
            final[~done] = s.valid_np[None]       # exact fallback: scan
            seen[~done] = s.valid_np[None]
        ppq = [len(p) for p in pages_seen]
        # candidates = rows fetched for the query across every round
        # (the union of its candidate sets), matching the range path's
        # accounting — NOT the smaller certified final set
        cpq = seen.sum(axis=1)
        store.record_queries(ppq, cpq)
        ex.last_io = {"pages": len(set().union(*pages_seen)),
                      "pages_per_query": ppq,
                      "candidates_per_query": [int(c) for c in cpq],
                      "pinned_pages": sum(len(p) for p in plan._pins)}
        if pf is not None:
            ex.last_io["prefetch"] = pf.snapshot()
        return final, rounds


class QueryExecutor:
    """Single-device plan execution + exact host refinement.  Runs on
    the snapshot's device.

    A snapshot carrying a paged store (``snap.store``) selects the paged
    backend: candidate masks are computed from the resident metadata
    exactly as in memory, then executed as page-granular IO — results
    bit-identical to the resident path.  ``prefetch`` ("off" | "async";
    None defers to ``REPRO_PREFETCH``) sets the paged backend's
    prefetch.

    The executor owns its planner and backend, and they hold it weakly:
    with no reference cycle, an executor a serving engine drops (the old
    standby at a swap) frees its snapshot's device memory as soon as
    the last batch holding it returns, not at a later cycle
    collection."""

    def __init__(self, snapshot: LIMSSnapshot, prefetch: str | None = None):
        self.snap = snapshot
        self.planner = Planner(self)
        self.backend = _PagedBackend(self, prefetch) \
            if snapshot.store is not None else _ResidentBackend(self)
        # IO summary of the most recent store-mode batch (None otherwise)
        self.last_io: dict | None = None
        # {slots, bucket, n_slots} of the most recent range batch that
        # took the compacted-gather path (None when the full array
        # streamed)
        self.last_compact: dict | None = None
        # {backend, k, rounds, host_syncs, driver} of the most recent
        # kNN batch
        self.last_knn: dict | None = None
        self.last_driver: str | None = None
        # QueryProfile of the most recent batch (None until one runs, or
        # with REPRO_OBS=off; last-writer-wins like last_knn)
        self.last_profile: QueryProfile | None = None
        # per-thread sync counter, as in the reference
        self._tls = threading.local()

    @property
    def live(self) -> int:
        return self.snap.live

    @property
    def prefetcher(self):
        """The backend's async page prefetcher (None unless paged and
        ``REPRO_PREFETCH=async``)."""
        return getattr(self.backend, "prefetcher", None)

    def _count_sync(self) -> None:
        """One device->host materialization on the query path."""
        self._tls.syncs = getattr(self._tls, "syncs", 0) + 1

    # ------------------------------------------------------ device stages
    def _plan_arrays(self, qf: torch.Tensor, rf: torch.Tensor):
        """((B, P) candidate mask, (B, K) routing) — the plan math."""
        return plan_arrays(qf, rf, self.snap, self.snap.n_rings)

    def _ball_filter(self, qf, rf) -> torch.Tensor:
        """(B, P) bool — fused L2-ball prefilter over the filter plane."""
        s = self.snap
        _resident_only(s)
        frows, eps = s.filter_rows()
        ball, _ = ops.range_filter(qf, frows.reshape(s.n_slots, s.d),
                                   rf * (1.0 + _R_REL) + _BALL_ABS + eps)
        return ball.to(torch.bool)

    def _filter_dists(self, qf) -> tuple[torch.Tensor, float]:
        """(B, P) f32 squared distances to every slot on the filter
        plane (inf where invalid), plus the plane's margin eps."""
        s = self.snap
        _resident_only(s)
        frows, eps = s.filter_rows()
        d2 = ops.pdist(qf, frows.reshape(s.n_slots, s.d))
        inf = torch.full_like(d2, float("inf"))
        return torch.where(s.valid.reshape(-1)[None], d2, inf), eps

    def _refine_rows(self, idx: np.ndarray) -> np.ndarray:
        """f64 rows for flat slot ids: the resident matrix or a page
        gather (cache-hot — the prefilter just fetched these pages)."""
        if self.snap.store is not None:
            return self.snap.store.gather(idx)
        return self.snap.rows_np[idx]

    # -------------------------------------------------------- observability
    def _emit_profile(self, plan: CandidatePlan, idxs: list, rounds: int,
                      stages: dict, t0: float) -> None:
        """Build and record one batch's :class:`QueryProfile`.

        Everything derives from state already on the host — each query's
        certified slot ids, which refinement has just taken from the
        backend's final mask, the thread-local sync counter, the
        snapshot's host mirrors — so profiling adds no device syncs.
        Candidates are the certified rows refinement scanned; clusters
        are how many of the K clusters those rows span (TriPrune's
        pruning power, per query).  The reference reduces the (B, P)
        final mask three times for these; the slot lists give the same
        values without another pass over it (at n = 1M ~0.1 s of host
        time a batch, PERF.md)."""
        if not _obs.enabled():
            return
        s = self.snap
        K, n_max, _ = s.rids.shape
        cand = np.array([i.size for i in idxs])
        # slot ids come sorted: a cluster holds candidates where its slot
        # range [k·n_max, (k+1)·n_max) cuts a query's ids
        edges = np.arange(K + 1) * n_max
        clusters = np.array([np.count_nonzero(np.diff(np.searchsorted(
            i, edges))) for i in idxs])
        union = np.zeros(s.n_slots, bool)
        for i in idxs:
            union[i] = True
        if self.backend.name == "paged" and self.last_io is not None:
            pages = int(self.last_io["pages"])
            ppq = float(np.mean(self.last_io["pages_per_query"]))
        else:
            pages, ppq = 0, 0.0
        prof = QueryProfile(
            kind=plan.kind, batch=plan.B, k=plan.k,
            backend=self.backend.name,
            driver=self.last_driver if plan.kind == "knn" else None,
            storage="paged" if s.store is not None else "resident",
            n_shards=1, rounds=int(rounds),
            host_syncs=int(getattr(self._tls, "syncs", 0)),
            pages=pages, pages_per_query=ppq,
            candidates_per_query=float(cand.mean()),
            clusters_per_query=float(clusters.mean()),
            n_clusters=int(K), stages=stages,
            total_s=time.perf_counter() - t0 + plan.plan_s,
            rank_err_ratio=self._observed_rank_err(np.flatnonzero(union)))
        self.last_profile = prof
        record_profile(prof)

    # how many certified candidates the rank-health stat replays per
    # batch (host f32 math over cache-hot rows — bounded, not per-row)
    _HEALTH_SAMPLE = 32

    def _health_arrays(self):
        """Host mirrors of the model/ring fields (``rids``, ``pivots``,
        ``coef``, ``lo``/``hi``/``n``, ``err``, flat ``in_ring``): the
        snapshot's own (``LIMSSnapshot.tables_np``), so the per-batch
        health stat copies nothing back from the device."""
        return self.snap.tables_np

    def _observed_rank_err(self, union: np.ndarray) -> float | None:
        """Observed rank-model error over this batch, as a fraction of
        the certified bound E (the reference's DESIGN.md §12).

        Samples up to ``_HEALTH_SAMPLE`` of the in-ring slots among
        ``union``, the sorted union of the batch's certified slots (the
        reference's ``final.any(axis=0)``), with a deterministic stride —
        no RNG on the query path — recomputes their pivot distances from the f64 rows
        refinement reads, replays the reference's host-f32 ``rank_math``
        arithmetic, and compares the predicted ring id against the one
        the build stored.  A NaN rank (a NaN distance) counts as rank 0,
        ring 0, as the kernels rank it since their NaN repair; on finite
        rows the replay is the reference's to the bit.  Ratio 1.0 means
        predictions are off by as much as the ring-widening budget E
        assumes; the rank-drift detector watches the per-cluster gauges
        this emits.  Returns the sample-mean ratio, or None when the
        batch certified no in-ring rows.  Buffer rows (``in_ring``
        False) bypass the model and are skipped."""
        s = self.snap
        K, n_max, m = s.rids.shape
        h = self._health_arrays()
        slots = union[h.in_ring[union]]
        if slots.size == 0:
            return None
        if slots.size > self._HEALTH_SAMPLE:
            step = slots.size // self._HEALTH_SAMPLE
            slots = slots[::step][:self._HEALTH_SAMPLE]
        rows = np.asarray(self._refine_rows(slots), np.float32)  # (S, d)
        kk = slots // n_max
        jj = slots % n_max
        x = np.sqrt(((rows[:, None, :] - h.pivots[kk]) ** 2).sum(-1))
        # replay rank_math in f32: normalize, Clenshaw high→low, rank →
        # ring id
        lo, hi, nn = h.lo[kk], h.hi[kk], h.n[kk]                 # (S, m)
        t = np.clip((x - lo) / np.maximum(hi - lo, np.float32(1e-30))
                    * 2.0 - 1.0, -1.0, 1.0).astype(np.float32)
        coef = h.coef[kk]                                        # (S, m, C)
        b1 = np.zeros_like(t)
        b2 = np.zeros_like(t)
        t2 = 2.0 * t
        for c in range(coef.shape[-1] - 1, 0, -1):
            b1, b2 = coef[..., c] + t2 * b1 - b2, b1
        r = coef[..., 0] + t * b1 - b2
        rank = np.clip(np.rint(r), 0.0, np.maximum(nn - 1.0, 0.0))
        rank = np.where(np.isnan(rank), np.float32(0.0), rank)
        width = np.ceil(nn / np.float32(s.n_rings))
        pred = np.clip(np.floor(rank / np.maximum(width, 1.0)), 0.0,
                       np.float32(s.n_rings - 1))
        act = h.rids[kk, jj]                                     # (S, m)
        ok = act >= 0
        if not ok.any():
            return None
        ratio = np.where(
            ok, np.abs(pred - act) * width / np.maximum(h.err[kk], 1.0),
            0.0)
        for k in np.unique(kk):
            _obs.set_gauge(f"executor.rank_err_ratio.c{int(k)}",
                           float(ratio[kk == k].max()))
        mean = float(ratio.sum() / ok.sum())
        _obs.observe("executor.rank_err_ratio", mean)
        return mean

    # ------------------------------------------------------- range queries
    def range_query_batch(self, Q, r):
        """Exact batched L2 range query.

        ``Q``: (B, d) queries; ``r``: scalar or (B,) per-query radii.
        Returns a list of B ``(ids, dists)`` pairs (int64 / float64), the
        same results as ``LIMSIndex.range_query`` per query.
        """
        Q = np.atleast_2d(np.asarray(Q, np.float64))
        B = Q.shape[0]
        r_arr = np.broadcast_to(np.asarray(r, np.float64), (B,))
        self._tls.syncs = 0
        plan = self.planner.plan_range(Q, r_arr)
        return self.execute_range(Q, plan)

    def execute_range(self, Q, plan: CandidatePlan):
        """Execute a prebuilt range plan.  ``Q`` must be the (B, d) f64
        queries the plan was built for (the plan carries only their f32
        device copy; exact refinement needs f64).  A plan built by
        another executor's planner starts a fresh sync count here."""
        s = self.snap
        Q = np.atleast_2d(np.asarray(Q, np.float64))
        if plan._planner is not self.planner:
            self._tls.syncs = 0
        t0 = time.perf_counter()
        stages = {"plan": plan.plan_s}
        try:
            with span("executor.range_execute",
                      {"B": plan.B, "backend": self.backend.name}):
                hit = self.backend.range_hits(plan)
            t1 = time.perf_counter()
            stages["execute"] = t1 - t0
            out, idxs = [], []
            with span("executor.refine", {"B": plan.B}):
                for b in range(Q.shape[0]):
                    idx = np.nonzero(hit[b])[0]
                    idxs.append(idx)
                    ids = s.gids_np[idx]
                    d_true = dist_one_to_many(Q[b], self._refine_rows(idx),
                                              "l2")
                    keep = d_true <= plan.radii[b]
                    out.append((ids[keep], d_true[keep]))
            stages["refine"] = time.perf_counter() - t1
            self._emit_profile(plan, idxs, 1, stages, t0)
        finally:
            self.backend.release(plan)
        return out

    def range_query(self, q, r: float):
        """Single-query convenience wrapper over the batch engine."""
        return self.range_query_batch(np.asarray(q)[None], float(r))[0]

    # --------------------------------------------------------- kNN queries
    def knn_query_batch(self, Q, k: int, max_rounds: int = 64):
        """Exact batched kNN: one plan, one backend execution.

        ``k`` is clamped to the number of live objects. Returns
        ``(ids (B, k'), dists (B, k'))`` with ``k' = min(k, live)``.
        """
        s = self.snap
        Q = np.atleast_2d(np.asarray(Q, np.float64))
        B = Q.shape[0]
        k_eff = min(int(k), s.live)
        if k_eff <= 0:
            return (np.empty((B, 0), np.int64), np.empty((B, 0)))
        self._tls.syncs = 0
        plan = self.planner.plan_knn(Q, k_eff, max_rounds)
        return self.execute_knn(Q, plan)

    def execute_knn(self, Q, plan: CandidatePlan):
        """Execute a prebuilt kNN plan (see :meth:`execute_range`)."""
        Q = np.atleast_2d(np.asarray(Q, np.float64))
        if plan._planner is not self.planner:
            self._tls.syncs = 0
        t0 = time.perf_counter()
        stages = {"plan": plan.plan_s}
        try:
            with span("executor.knn_execute",
                      {"B": plan.B, "k": plan.k,
                       "backend": self.backend.name}):
                final, rounds = self.backend.knn_candidates(plan)
            t1 = time.perf_counter()
            stages["execute"] = t1 - t0
            self.last_knn = {"backend": self.backend.name, "k": plan.k,
                             "rounds": rounds,
                             "host_syncs": self._tls.syncs,
                             "driver": self.last_driver}
            with span("executor.refine", {"B": plan.B}):
                idxs = [np.nonzero(row)[0] for row in final]
                out = self._refine_topk(Q, idxs, plan.k)
            stages["refine"] = time.perf_counter() - t1
            self._emit_profile(plan, idxs, rounds, stages, t0)
            return out
        finally:
            self.backend.release(plan)

    def _refine_topk(self, Q, idxs: list, k_eff: int):
        """Exact f64 refinement of the certified candidate sets: each
        query's slot ids ``idxs[b]`` are a superset of its closed k-th
        ball, so the stable distance sort selects the host index's k
        results."""
        s = self.snap
        B = Q.shape[0]
        ids_out = np.empty((B, k_eff), np.int64)
        d_out = np.empty((B, k_eff))
        for b, idx in enumerate(idxs):
            d_true = dist_one_to_many(Q[b], self._refine_rows(idx), "l2")
            sel = np.argsort(d_true, kind="stable")[:k_eff]
            ids_out[b] = s.gids_np[idx[sel]]
            d_out[b] = d_true[sel]
        return ids_out, d_out

    def knn_query(self, q, k: int):
        """Single-query convenience wrapper over the batch engine."""
        ids, dists = self.knn_query_batch(np.asarray(q)[None], k)
        return ids[0], dists[0]


def make_executor(snapshot: LIMSSnapshot, *, sharded: bool | None = None,
                  prefetch: str | None = None) -> QueryExecutor:
    """Executor factory.  ``sharded=None`` (or False) serves on the
    snapshot's one device: unlike the reference it never auto-shards on
    a machine with several cards, since the sharded executor is not
    ported.  ``sharded=True`` raises ``NotImplementedError``.
    ``prefetch`` passes to the paged backend of a store-backed
    snapshot."""
    if sharded:
        raise NotImplementedError(
            "the sharded executor is not ported yet (ROADMAP A9)")
    return QueryExecutor(snapshot, prefetch=prefetch)


__all__ = ["QueryExecutor", "make_executor"]
