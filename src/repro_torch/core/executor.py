"""Plan *execution* over a snapshot, and exact host refinement.

Port of ``repro/core/executor.py``.  The planner (``planner.py``) builds
one :class:`CandidatePlan` per query batch and one of two backends
executes it.  ``_ResidentBackend`` runs the kernels over the snapshot's
device rows:

  * range: the fused L2-ball prefilter (``range_filter``) applied to the
    plan's device mask — by default (``REPRO_COMPACT=on``) over the
    plan's compacted candidate gather, the union certified candidate
    rows gathered once into a power-of-two bucket, so filter bytes
    scale with TriPrune's survivors instead of padded slots;
  * kNN: the certified growing-radius schedule: a ``pdist`` distance
    matrix over every slot (the seed), then per round the plan math,
    the ball, the candidate count and ``torch.topk`` for the k-th
    distance, driven by ``REPRO_KNN_DRIVER`` (the reference's
    ``_knn_driver``).  ``loop`` keeps the rounds on the device: on a
    card one launch of a CUDA graph runs every round (a WHILE
    conditional node over one captured round, ``kernels/graph_loop.py``)
    and the batch's certified masks and rounds come back in one
    readback, so a batch costs O(1) host syncs however many rounds it
    takes; on the CPU the same round runs in a Python loop.  ``rounds``
    is the reference's ``_knn_host_rounds``: ``ok`` reaches the host
    once a round.  ``auto`` picks ``rounds`` for a one-part executor on
    the CPU and ``loop`` everywhere else, as the reference does, except
    on a mesh over several cards, where it picks ``rounds``: a graph's
    capture holds one device.

``_PagedBackend`` serves a store-backed snapshot (``snap.store`` set;
the storage tier, the reference's DESIGN.md §7–§8): the plan's masks
become deduplicated, run-coalesced page IO through the snapshot's
``StoreView``; ``range_filter`` (range) and ``pdist`` (each kNN round's
newly gathered rows) run on the gathered rows, cast to f32 on the host
and copied to the device through a pinned staging buffer; the round's
schedule mask is the planner's ``eval_mask`` (``pdist_rankeval`` on
CUDA).  With ``REPRO_PREFETCH=async`` round t+1's pages are fetched on
a background thread while round t's kernels run.

``QueryExecutor`` runs on the snapshot's one device.
``ShardedExecutor`` splits the snapshot's clusters over a 1-D mesh
(``repro_torch.sharding``; the reference's DESIGN.md §4): every shard
runs the same plan math and kernels over its own clusters, and the
per-shard outputs meet on the snapshot's device, concatenated in shard
order, with the kNN rounds' two reductions (candidate counts, k-th
distance) merged there.  Cluster-granular sharding keeps exactness for
free: pivot tables, rank models and the certified bound E are strictly
per-cluster state.

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

The loop's graphs (``_LoopGraphs``): keyed by (power-of-two batch
bucket, k, max_rounds) — a batch is padded with copies of its first
query, which certify with it, so results and rounds do not change — at
most ``_LOOP_GRAPHS`` an executor, least recently used dropped first,
over inputs and state buffers shared by the executor's graphs.  Every
graph on a card draws its round temporaries from one private memory
pool, and one lock a card (``_CardLoop``) holds each loop from copy-in
to readback, so the card holds one set of round temporaries however
many graphs, executors and router threads use it.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import torch

from .. import env
from ..kernels import _cuda, ops
from ..kernels.dispatch import compact_enabled
from ..kernels.graph_loop import WhileGraph, loop_cond_plain
from ..obs import registry as _obs
from ..obs.profile import QueryProfile, record_profile
from ..obs.trace import span
from ..sharding import Mesh, serving_mesh
from ..storage import (PagePrefetcher, cache_pin_mode, plan_batch,
                       prefetch_mode)
from .metrics import dist_one_to_many
from .planner import (_BALL_ABS, _R_REL, _SEED_REL, CandidatePlan, Planner,
                      plan_arrays)
from .snapshot import DEVICE_FIELDS, LIMSSnapshot

def _bucket_size(n: int, min_rows: int = 128) -> int:
    """Next power-of-two row bucket (≥ ``min_rows``) for ``n`` rows."""
    return max(min_rows, 1 << max(n - 1, 1).bit_length())


def _kth_smallest(dm: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) k-th smallest value per row (``lax.top_k`` in the reference)."""
    return torch.topk(dm, k, dim=1, largest=False, sorted=True).values[:, -1]


def _on_lead(blocks: list, lead: torch.device) -> torch.Tensor:
    """Per-part (B, n_part) blocks as one (B, Σ n_part) tensor on the
    lead device, in part order (one part: the block itself)."""
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat([b.to(lead) for b in blocks], dim=1)


def _merged_count(cnts: list, lead: torch.device) -> torch.Tensor:
    """(B,) candidate count over every part (the reference's ``psum``)."""
    if len(cnts) == 1:
        return cnts[0]
    return torch.stack([c.to(lead) for c in cnts]).sum(dim=0)


def _merged_kth(dms: list, k: int, lead: torch.device) -> torch.Tensor:
    """(B,) k-th smallest value over every part's (B, n_part) block:
    each part's ``min(k, n_part)`` smallest (the reference's shard-local
    ``top_k``, inf where a slot is out), gathered on the lead device
    (its tiled ``all_gather``) and selected again.  The global k
    smallest lie among the parts' k smallest, so the value is the
    single-block k-th bit for bit."""
    if len(dms) == 1:
        return _kth_smallest(dms[0], k)
    tops = [torch.topk(dm, min(k, dm.shape[1]), dim=1, largest=False,
                       sorted=False).values for dm in dms]
    return _kth_smallest(_on_lead(tops, lead), k)


def _knn_round_masks(d2, cand, rf, eps):
    """One round's certified ball mask, candidate count and masked
    distance matrix (the reference's jitted ``_knn_round_masks``)."""
    ball = d2 <= ((rf * (1.0 + _R_REL) + _BALL_ABS + eps) ** 2)[:, None]
    candb = cand & ball
    cnt = torch.sum(candb, dim=1)
    dm = torch.where(candb, d2, torch.full_like(d2, float("inf")))
    return candb, cnt, dm


# ---------------------------------------------------------------------------
# the kNN driver, and the device-resident loop: one copy of the round for
# the CPU loop and the card's CUDA graph, over the executor's parts
# ---------------------------------------------------------------------------
def _cards(ex) -> set:
    """The CUDA device indices the executor's parts lie on."""
    return {torch.cuda.current_device() if p.device.index is None
            else p.device.index for p in ex._parts
            if p.device.type == "cuda"}


def _knn_driver(ex) -> str:
    """Which resident kNN driver runs the schedule, resolved per call
    so ``REPRO_KNN_DRIVER`` set on a long-lived executor takes effect.
    ``loop`` keeps the rounds on the device; ``rounds`` drives them from
    the host.  ``auto`` picks ``rounds`` for a one-part executor on the
    CPU, where the device is the host, and ``loop`` on a card and on
    any sharded executor, as the reference's rule does — except on a
    mesh over several cards, where it picks ``rounds``: the loop's graph
    is captured on one card (``_knn_device_loop`` raises there)."""
    mode = env.get("REPRO_KNN_DRIVER")
    if mode in ("loop", "rounds"):
        return mode
    if ex.snap.device.type == "cpu" and ex.n_shards <= 1:
        return "rounds"
    return "rounds" if len(_cards(ex)) > 1 else "loop"


def _bucket_rows(n: int) -> int:
    """The loop's batch bucket: the next power of two (≥ 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _knn_seed(ex, qf, r0, k_eff: int, out: list | None = None):
    """The schedule's seed, eager and on the device: each part's
    filter-plane squared distances (into ``out``'s blocks where given),
    the plane's margin eps, and each query's start radius — the plan's
    radius ``r0`` skipped ahead on the doubling schedule to the first
    round whose radius covers the merged k-th distance estimate."""
    d2s, eps = ex._seed_dists(qf, out)
    kth0 = torch.sqrt(torch.clamp(_merged_kth(d2s, k_eff, qf.device),
                                  min=0.0))
    seed = kth0 * (1.0 + _SEED_REL) + _BALL_ABS
    t0 = torch.ceil(torch.log2(torch.clamp(seed, min=1e-30) / r0))
    return d2s, eps, r0 * torch.exp2(torch.clamp(t0, min=0.0))


def _round_certify(ex, qf, d2s: list, eps: float, k_eff: int, rf):
    """One round at radii ``rf``, either driver's: each part's (ball
    ∧ candidate mask, count, masked distances) — the plan's mask at
    ``rf``, the ball at ``rf·(1+_R_REL)+_BALL_ABS+eps`` — and the
    guard-band ``ok`` from the merged count and k-th distance."""
    lead = qf.device
    parts = [_knn_round_masks(d2, cand, rf.to(d2.device), eps)
             for d2, cand in zip(d2s, ex._round_masks(qf, rf))]
    cnt = _merged_count([p[1] for p in parts], lead)
    kth = torch.sqrt(torch.clamp(
        _merged_kth([p[2] for p in parts], k_eff, lead), min=0.0))
    return parts, (cnt >= k_eff) & (
        kth <= rf * (1.0 - _R_REL) - _BALL_ABS - eps)


def _knn_round(ex, qf, d2s: list, eps: float, k_eff: int, st) -> None:
    """One round of the certified schedule, in place on the loop state
    ``st`` (``done``, ``r``, each part's ``final`` block), in the
    reference's order: ``ok`` (:func:`_round_certify` at ``r``), then
    ``newly``, ``final``, ``done``, ``r``.  No host sync: the round the
    card's graph captures."""
    rf = st.r
    parts, ok = _round_certify(ex, qf, d2s, eps, k_eff, rf)
    newly = ok & ~st.done
    for (candb, _, _), fin in zip(parts, st.final):
        torch.where(newly.to(fin.device)[:, None], candb, fin, out=fin)
    torch.logical_or(st.done, newly, out=st.done)
    torch.where(st.done, rf, rf * 2.0, out=st.r)


def _loop_state(ex, B: int, device) -> SimpleNamespace:
    """Zeroed loop state for B queries: ``done``, ``r`` and ``rounds``
    on ``device`` (the lead), a ``final`` block a part."""
    return SimpleNamespace(
        done=torch.zeros(B, dtype=torch.bool, device=device),
        r=torch.zeros(B, dtype=torch.float32, device=device),
        rounds=torch.zeros(1, dtype=torch.int32, device=device),
        final=[torch.zeros(B, p.valid.numel(), dtype=torch.bool,
                           device=p.device) for p in ex._parts])


def _reset(st, r_start) -> None:
    """A batch's start: nothing done, no round run, r at its start.
    ``final`` needs no reset: a query's row is written whole when it
    certifies, and a row never certified is the full scan's."""
    st.done.zero_()
    st.rounds.zero_()
    st.r.copy_(r_start)


def _knn_packed(ex, st, B: int) -> torch.Tensor:
    """The loop's result as one uint8 tensor on the lead device, what
    one readback copies: ``rounds`` as int32 in bytes 0–3, then from
    byte 8 the (B, P) certified masks of the batch's first B queries —
    each part's block where its query certified, the part's valid slots
    (the exact full scan) where it never did.  Every part lies on the
    lead's device (the loop runs on one device)."""
    sizes = [f.shape[1] for f in st.final]
    out = torch.empty(8 + B * sum(sizes), dtype=torch.uint8,
                      device=st.done.device)
    out[:4].view(torch.int32).copy_(st.rounds)
    final = out[8:].view(B, -1).view(torch.bool)
    o = 0
    for f, p, n in zip(st.final, ex._parts, sizes):
        torch.where(st.done[:B, None], f[:B], p.valid.reshape(-1)[None],
                    out=final[:, o:o + n])
        o += n
    return out


def _unpacked(host: np.ndarray, B: int):
    """(final (B, P) bool, rounds) from :func:`_knn_packed`'s bytes."""
    return host[8:].reshape(B, -1).view(bool), int(host[:4].view(np.int32)[0])


# graphs a _LoopGraphs keeps (least recently used dropped first)
_LOOP_GRAPHS = 4


class _CardLoop:
    """One card's share of the kNN loop's graphs, across executors.

    Every loop on the card runs under ``lock``, from copy-in to
    readback, over one set of buffers (:meth:`buffers`: the queries,
    each part's seed distances and certified masks, ``done``, ``r``,
    ``rounds``, ``flag``), and every graph draws its round temporaries
    from one private pool (``torch.cuda.graph_pool_handle``).  So the
    card holds one batch's buffers and one round's temporaries however
    many graphs, executors (the frontend's replicas, a serving engine's
    standby) and threads use it.  Buffers grow to the largest batch
    seen; growing them moves ``gen`` on, which retires every graph
    captured over the old ones.  Pool and buffers live while a graph
    does (``graphs``); the next capture after the last graph goes takes
    a new pool (PyTorch cannot join a pool it has released).  ``stream``
    is the card's capture stream."""

    _cards: dict = {}
    _guard = threading.Lock()

    def __init__(self, index: int):
        self.index = index
        self.lock = threading.Lock()
        self.pool = None
        self.graphs = 0
        self.gen = 0
        self._arena = None
        self._count = threading.Lock()
        with torch.cuda.device(index):
            self.stream = torch.cuda.Stream()

    @classmethod
    def of(cls, index: int) -> "_CardLoop":
        with cls._guard:
            card = cls._cards.get(index)
            if card is None:
                card = cls._cards[index] = cls(index)
            return card

    def join_pool(self):
        """The pool, for one more graph."""
        with self._count:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.graphs += 1
            return self.pool

    def leave_pool(self) -> None:
        """One graph fewer; the last takes the pool and buffers along."""
        with self._count:
            self.graphs -= 1
            if self.graphs == 0:
                self.pool = None
                self._arena = None

    def trim(self) -> None:
        """Drop the buffers where no graph holds them (a batch that
        captured nothing: ``max_rounds`` 0)."""
        with self._count:
            if self.graphs == 0:
                self._arena = None

    def buffers(self, ex, Bp: int) -> SimpleNamespace:
        """The loop's buffers for ``ex`` (its parts on this card) at Bp
        queries: views into two arenas (f32: queries, r, each part's
        distances; bool: done, each part's masks) and two int32s.  Call
        under ``lock``."""
        d = ex.snap.d
        sizes = [p.valid.numel() for p in ex._parts]
        n32 = Bp * (d + 1 + sum(sizes))
        n8 = Bp * (1 + sum(sizes))
        a = self._arena
        if a is None or a.f32.numel() < n32 or a.b8.numel() < n8:
            dev = torch.device("cuda", self.index)
            self._arena = None
            a = self._arena = SimpleNamespace(
                f32=torch.zeros(n32 if a is None else max(n32, a.f32.numel()),
                                dtype=torch.float32, device=dev),
                b8=torch.zeros(n8 if a is None else max(n8, a.b8.numel()),
                               dtype=torch.bool, device=dev),
                i32=torch.zeros(2, dtype=torch.int32, device=dev))
            self.gen += 1
        f, b = a.f32, a.b8
        st = SimpleNamespace(qf=f[:Bp * d].view(Bp, d),
                             r=f[Bp * d:Bp * (d + 1)],
                             done=b[:Bp], rounds=a.i32[:1],
                             flag=a.i32[1:], d2=[], final=[], gen=self.gen)
        o32, o8 = Bp * (d + 1), Bp
        for n in sizes:
            st.d2.append(f[o32:o32 + Bp * n].view(Bp, n))
            st.final.append(b[o8:o8 + Bp * n].view(Bp, n))
            o32 += Bp * n
            o8 += Bp * n
        return st


class _LoopEntry:
    """One captured loop: the round's PyTorch graph (it holds the pool's
    memory), the WHILE graph over it, the buffers' generation it was
    captured over, and what the capture recorded — the launches and
    wrapper calls one round makes."""

    def __init__(self, card: _CardLoop, round_graph, loop: WhileGraph,
                 gen: int, tally: _cuda.Tally, seconds: float):
        self.card, self.round_graph, self.loop = card, round_graph, loop
        self.gen, self.tally, self.seconds = gen, tally, seconds

    def close(self) -> None:
        if self.loop is not None:
            self.loop.close()
            self.loop = self.round_graph = None
            self.card.leave_pool()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter shutdown: CUDA may be gone
            pass


class _LoopGraphs:
    """An executor's kNN loops on its card: at most ``_LOOP_GRAPHS``
    captured graphs keyed by (batch bucket, k, max_rounds), over the
    card's buffers.  ``captures`` lists each capture's seconds (a
    warm-up round, the capture, the WHILE graph's build)."""

    def __init__(self, ex, card: _CardLoop):
        self.ex = weakref.proxy(ex)
        self.card = card
        # entries close when dropped (evicted, or with the executor)
        self.entries: OrderedDict = OrderedDict()
        self.captures: list = []

    def _capture(self, st, eps: float, k_eff: int,
                 max_rounds: int) -> _LoopEntry:
        """Capture one round at the batch's shapes into the card's pool
        and build the WHILE graph over it.  The round runs once eagerly
        first (its launches recorded, not counted), so every kernel is
        loaded before the capture; its temporaries are released after."""
        ex, card = self.ex, self.card
        t0 = time.perf_counter()
        with _cuda.recording():
            _knn_round(ex, st.qf, st.d2, eps, k_eff, st)
        torch.cuda.empty_cache()
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError as e:
            raise RuntimeError(
                "REPRO_KNN_DRIVER=loop needs torch.cuda.CUDAGraph("
                "keep_graph=True), which this PyTorch lacks") from e
        pool = card.join_pool()
        try:
            card.stream.wait_stream(torch.cuda.current_stream(card.index))
            with _cuda.recording() as tally, torch.cuda.stream(card.stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    _knn_round(ex, st.qf, st.d2, eps, k_eff, st)
                finally:
                    graph.capture_end()
            loop = WhileGraph(graph, st.done, st.rounds, max_rounds,
                              st.flag)
        except BaseException:
            del graph
            card.leave_pool()
            raise
        entry = _LoopEntry(card, graph, loop, st.gen, tally,
                           time.perf_counter() - t0)
        self.captures.append(entry.seconds)
        _obs.count("executor.knn_loop_captures")
        return entry

    def run(self, qf, r0, k_eff: int, max_rounds: int) -> np.ndarray:
        """One batch through its key's graph, captured at the key's
        first use (or after the card's buffers grew): the padded queries
        and the seed into the buffers, one launch, the packed result
        read back.  Returns the host bytes of :func:`_knn_packed`."""
        ex, card = self.ex, self.card
        B, d = qf.shape
        Bp = _bucket_rows(B)
        key = (Bp, k_eff, max_rounds)
        with card.lock, torch.cuda.device(card.index):
            st = card.buffers(ex, Bp)
            st.qf[:B].copy_(qf)
            st.qf[B:].copy_(qf[:1].expand(Bp - B, d))
            r0p = torch.cat([r0, r0[:1].expand(Bp - B)])
            d2s, eps, r_start = _knn_seed(ex, st.qf, r0p, k_eff, st.d2)
            _reset(st, r_start)
            entry = self.entries.pop(key, None)
            if entry is not None and entry.gen != st.gen:
                entry.close()               # over buffers since replaced
                entry = None
            if entry is None and max_rounds > 0:
                entry = self._capture(st, eps, k_eff, max_rounds)
                _reset(st, r_start)
            if entry is not None:
                self.entries[key] = entry
                while len(self.entries) > _LOOP_GRAPHS:
                    self.entries.popitem(last=False)[1].close()
                entry.loop.launch()
            host = _knn_packed(ex, st, B).cpu().numpy()
            card.trim()
        if entry is not None:
            rounds = int(host[:4].view(np.int32)[0])
            _cuda.add_launches(entry.tally.kernels, rounds)
            _cuda.add_launches({"knn_loop_cond": 1}, rounds)
            ops.count_replayed(entry.tally.calls, rounds)
        return host


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
        if compact_enabled() and ex._compacts:
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
        """The certified growing-radius schedule, by the driver
        ``_knn_driver`` picks: seed skip-ahead to the first schedule
        radius that covers the k-th distance estimate, the guard-band
        certification per query, and the exact full scan for anything
        the schedule never certifies.  The certified set is a superset
        of the closed k-th ball, so refinement returns the host index's
        results whichever driver ran."""
        ex = self.ex
        if _knn_driver(ex) == "rounds":
            return self._knn_host_rounds(plan)
        final, rounds = ex._knn_device_loop(plan)
        ex.last_driver = "loop"
        return final, rounds

    def _knn_host_rounds(self, plan: CandidatePlan):
        """The same schedule driven from the host, one round at a time
        (the reference's ``_knn_host_rounds``).  The wide work runs per
        part of the executor (the whole snapshot, or each cluster shard
        on its device); the candidate count and the k-th distance merge
        on the lead device, and the round's ``ok`` flags reach the host
        once a round."""
        ex = self.ex
        s = ex.snap
        qf = plan.qf
        lead = qf.device
        k_eff = plan.k
        r0 = torch.from_numpy(plan.radii.astype(np.float32)).to(lead)
        d2s, eps, r = _knn_seed(ex, qf, r0, k_eff)
        r = r.cpu().numpy()
        ex._count_sync()
        B = plan.B
        done = np.zeros(B, bool)
        final = np.zeros((B, s.n_slots), bool)
        rounds = 0
        for t in range(plan.max_rounds):
            rounds = t + 1
            rf = torch.from_numpy(r).to(lead)
            parts, ok = _round_certify(ex, qf, d2s, eps, k_eff, rf)
            ok = ok.cpu().numpy()
            ex._count_sync()
            newly = ok & ~done
            if newly.any():
                sel = torch.from_numpy(newly)
                final[newly] = _on_lead(
                    [p[0][sel.to(p[0].device)] for p in parts],
                    lead).cpu().numpy()
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
        # the parts the device stages run over, in flat slot order, each
        # holding the DEVICE_FIELDS on its own device: here the whole
        # snapshot (ShardedExecutor: its cluster shards)
        self._parts: tuple = (snapshot,)
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
        # the kNN loop's CUDA graphs (created at the first loop on a card)
        self._loop: _LoopGraphs | None = None

    @property
    def live(self) -> int:
        return self.snap.live

    @property
    def n_shards(self) -> int:
        return len(self._parts)

    @property
    def _compacts(self) -> bool:
        """Whether range batches may take the compacted gather: one
        part only (the reference compacts on one device only)."""
        return len(self._parts) == 1

    def _filter_plane(self) -> tuple[list, float]:
        """Each part's filter rows and the margin eps: the snapshot's
        plane (bf16/f16 with its margin, when built) for one part; each
        shard's f32 rows with eps 0 for cluster shards, as the
        reference's ``shard_map`` pipeline, which never ships the plane."""
        _resident_only(self.snap)
        if len(self._parts) == 1:
            frows, eps = self.snap.filter_rows()
            return [frows], eps
        return [p.rows for p in self._parts], 0.0

    @property
    def prefetcher(self):
        """The backend's async page prefetcher (None unless paged and
        ``REPRO_PREFETCH=async``)."""
        return getattr(self.backend, "prefetcher", None)

    def _count_sync(self) -> None:
        """One device->host materialization on the query path."""
        self._tls.syncs = getattr(self._tls, "syncs", 0) + 1

    # ------------------------------------------------------ device stages
    # Each stage runs once a part, on the part's device; per-part outputs
    # come back to the lead (the snapshot's device) in part order.
    def _replicas(self, qf) -> tuple:
        """The batch's queries on each part's device, copied once a
        batch: a kNN batch's rounds pass the plan's same ``qf``."""
        cached = getattr(self._tls, "replicas", None)
        if cached is None or cached[0] is not qf:
            cached = (qf, tuple(qf.to(p.device) for p in self._parts))
            self._tls.replicas = cached
        return cached[1]

    def _plan_parts(self, qf, rf) -> list:
        """Each part's ((B, P_part) candidate mask, (B, K_part) routing)
        on the part's device — the plan math."""
        n_rings = self.snap.n_rings
        return [plan_arrays(q, rf.to(q.device), p, n_rings)
                for p, q in zip(self._parts, self._replicas(qf))]

    def _plan_arrays(self, qf: torch.Tensor, rf: torch.Tensor):
        """((B, P) candidate mask, (B, K) routing) on the lead device."""
        parts = self._plan_parts(qf, rf)
        return (_on_lead([p[0] for p in parts], qf.device),
                _on_lead([p[1] for p in parts], qf.device))

    def _round_masks(self, qf, rf) -> list:
        """One kNN round's candidate mask, one (B, P_part) block a part,
        on the part's device."""
        return [p[0] for p in self._plan_parts(qf, rf)]

    def _pivot_dists(self, qf) -> torch.Tensor:
        """(B, K·m) f32 query→pivot distances, the kNN plan's seed."""
        d = self.snap.d
        dq = [ops.pdist(q, p.pivots.reshape(-1, d))
              for p, q in zip(self._parts, self._replicas(qf))]
        return torch.sqrt(torch.clamp(_on_lead(dq, qf.device), min=0.0))

    def _ball_filter(self, qf, rf) -> torch.Tensor:
        """(B, P) bool — fused L2-ball prefilter over the filter plane."""
        frows, eps = self._filter_plane()
        d = self.snap.d
        rb = rf * (1.0 + _R_REL) + _BALL_ABS + eps
        masks = [ops.range_filter(q, fr.reshape(-1, d), rb.to(q.device))[0]
                 for fr, q in zip(frows, self._replicas(qf))]
        return _on_lead(masks, qf.device).to(torch.bool)

    def _seed_dists(self, qf, out: list | None = None) -> tuple[list, float]:
        """The kNN rounds' distances: f32 squared distances to every slot
        on the filter plane (inf where invalid), one (B, P_part) block a
        part (written into ``out``'s blocks where given: the loop's
        buffers), plus the plane's margin eps."""
        frows, eps = self._filter_plane()
        d = self.snap.d
        blocks = []
        for i, (p, fr, q) in enumerate(zip(self._parts, frows,
                                           self._replicas(qf))):
            d2 = ops.pdist(q, fr.reshape(-1, d))
            inf = torch.full_like(d2, float("inf"))
            blocks.append(torch.where(p.valid.reshape(-1)[None], d2, inf,
                                      out=None if out is None else out[i]))
        return blocks, eps

    def _knn_device_loop(self, plan: CandidatePlan):
        """(final (B, P) bool mask, rounds) of the device-resident loop:
        the seed eagerly on the device, then every round without a host
        sync — one CUDA graph launch on a card, a Python loop over the
        CPU tensors on the CPU (its condition read from CPU memory, no
        readback) — and the masks and rounds in one readback.  The batch
        is padded to its power-of-two bucket with copies of its first
        query (per-row work: results and rounds unchanged).  Raises
        on a mesh over several cards: a graph's capture holds one."""
        _resident_only(self.snap)
        qf = plan.qf
        B = plan.B
        r0 = torch.from_numpy(plan.radii.astype(np.float32)).to(qf.device)
        if qf.device.type == "cuda":
            cards = _cards(self)
            if len(cards) > 1:
                raise RuntimeError(
                    f"REPRO_KNN_DRIVER=loop: this mesh spans {len(cards)} "
                    f"cards, and the kNN loop runs as one CUDA graph, "
                    f"captured on one card (a PyTorch capture and a "
                    f"conditional node's body each hold one device); use "
                    f"REPRO_KNN_DRIVER=rounds or auto here")
            if self._loop is None:
                self._loop = _LoopGraphs(self, _CardLoop.of(cards.pop()))
            host = self._loop.run(qf, r0, plan.k, plan.max_rounds)
        else:
            Bp = _bucket_rows(B)
            qp = torch.cat([qf, qf[:1].expand(Bp - B, -1)])
            r0p = torch.cat([r0, r0[:1].expand(Bp - B)])
            d2s, eps, r_start = _knn_seed(self, qp, r0p, plan.k)
            st = _loop_state(self, Bp, qf.device)
            _reset(st, r_start)
            if plan.max_rounds > 0:
                while True:
                    _knn_round(self, qp, d2s, eps, plan.k, st)
                    if not bool(loop_cond_plain(st.done, st.rounds,
                                                plan.max_rounds)):
                        break
            host = _knn_packed(self, st, B).numpy()
        self._count_sync()
        return _unpacked(host, B)

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
            n_shards=self.n_shards, rounds=int(rounds),
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


class ShardedExecutor(QueryExecutor):
    """Cluster-sharded executor over a 1-D device mesh (the reference's
    ``shard_map`` executor, in one process).

    The snapshot's K clusters are padded with inert clusters to a
    multiple of the mesh's extent S and split on the cluster axis: shard
    i holds clusters [i·K/S, (i+1)·K/S) of every device tensor, placed
    once on ``mesh.devices[i]`` — on the snapshot's own device a view of
    the snapshot's tensor, not a copy.  The snapshot's device is the
    lead: queries are copied to each shard's device once a batch, every
    shard runs the unchanged ``plan_arrays`` body and kernels over its
    own clusters, and the per-shard outputs come back to the lead
    concatenated in shard order, which is the padded snapshot's flat
    slot order that refinement indexes.

    * range: the plan's mask and routing, then ``range_filter`` per
      shard over the shard's f32 rows with eps 0, even where the
      snapshot carries a bf16/f16 filter plane (as the reference, whose
      ``shard_map`` pipeline never ships the plane); no compacted
      gather.
    * kNN: the same device-resident loop as the single-device executor
      (``_knn_round``, one copy), run over the shards: each round's two
      reductions merge on the lead — the candidate count is the sum of
      the shards' counts, the k-th distance the k-th smallest of the
      shards' ``min(k, P/S)`` smallest (the reference's ``psum`` and
      tiled ``all_gather`` of shard-local ``top_k`` inside its
      ``shard_map`` loop); the seed filters each shard's f32 rows with
      eps 0, as the reference's sharded loop does.  ``auto`` picks the
      loop on the CPU and on a mesh naming one card (one CUDA graph
      captures every shard's round), and the host-driven rounds on a
      mesh over several cards, where ``loop`` raises: a graph is
      captured on one device.
    * a store-backed snapshot: only the plan math runs sharded; the
      paged backend does the rest on the lead, as in the reference.

    The shards are the executor's parts (``QueryExecutor._parts``), so
    every device stage is the single-device one run once a shard.
    ``n_shards <= 1`` (a one-device mesh) is the plain executor.  With
    no ``mesh``, every visible card (``serving_mesh``).  No fallback: a
    shard whose kernel fails to build or launch fails the batch.
    """

    def __init__(self, snapshot: LIMSSnapshot, mesh: Mesh | None = None,
                 prefetch: str | None = None):
        if mesh is None:
            mesh = serving_mesh()
        self.mesh = mesh
        S = mesh.size
        if S > 1:
            snapshot = snapshot.pad_clusters(-(-snapshot.K // S) * S)
        super().__init__(snapshot, prefetch=prefetch)
        if S > 1:
            kl = snapshot.K // S
            self._parts = tuple(
                SimpleNamespace(device=dev, **{
                    f: getattr(snapshot, f).narrow(0, i * kl, kl).to(dev)
                    for f in DEVICE_FIELDS})
                for i, dev in enumerate(mesh.devices))


def make_executor(snapshot: LIMSSnapshot, *, sharded: bool | None = None,
                  mesh: Mesh | None = None,
                  prefetch: str | None = None) -> QueryExecutor:
    """Executor factory.  ``sharded=None`` shards when a ``mesh`` is
    given, or when the snapshot lies on a card and more than one card
    is visible (the reference's auto-shard); otherwise the plain
    single-device executor.  ``prefetch`` passes to the paged backend
    of a store-backed snapshot."""
    if sharded is None:
        sharded = mesh is not None or (
            snapshot.device.type == "cuda" and torch.cuda.device_count() > 1)
    if sharded:
        return ShardedExecutor(snapshot, mesh=mesh, prefetch=prefetch)
    return QueryExecutor(snapshot, prefetch=prefetch)


__all__ = ["QueryExecutor", "ShardedExecutor", "make_executor"]
