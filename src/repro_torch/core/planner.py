"""Query planning: the *plan* half of the plan/execute query path.

Port of ``repro/core/planner.py``.  A :class:`CandidatePlan` holds one
query batch's certified plan: per-query radii (plus the growing-radius
schedule kNN rounds walk), the error-widened candidate masks and the
per-query cluster routing (TriPrune).  It is built once per batch by a
:class:`Planner` from snapshot metadata only — pivot distances, rank
tables and the certified bound E — never from the rows.

Guard-band constants live here because they are plan semantics: the
masks must be a certified superset of the host's exact candidate sets
(the reference's DESIGN.md §3), and every consumer widens and narrows
by the same bands.

Plan construction is observed as in the reference: a
``planner.plan_range`` / ``planner.plan_knn`` span around each build,
its wall time in ``CandidatePlan.plan_s``, and the
``planner.plans_built`` and ``planner.round_evals`` counters.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels import ops
from ..obs import registry as _obs
from ..obs.trace import span

# f32 guard bands: rank math and distances run in f64 on the host; the
# device path inflates radii so rounding can never exclude a true result
# (the final f64 refinement removes the extras).
_R_REL = 1e-5       # relative radius inflation for the ring box
_R_ABS = 1e-4       # absolute radius inflation for the ring box
_BALL_ABS = 1e-3    # absolute inflation for the distance-ball prefilter
# seed-radius inflation: pivot/k-th distances are f32, the schedule base
# is f64
_SEED_REL = 1e-3
# compacted-gather payoff bound: when the union candidate set exceeds
# this fraction of the slot array, gathering survivors moves more bytes
# than the full-array filter saves, and the plan reports "don't compact"
_COMPACT_MAX_FRAC = 0.5


def plan_arrays(qf, rf, snap, n_rings: int, fused: bool | None = None):
    """The device plan math: (B, K·n_max) candidate mask + (B, K)
    cluster routing.

    Staged: one ``pdist`` launch gives query->pivot distances (TriPrune
    and AreaLocate inputs); one ``rankeval`` launch evaluates all K·m
    rank models at the lo/hi annulus boundaries of the whole batch,
    laid out (G, 2B).  Fused (``fused=None`` defers to
    ``dispatch.fused_plan_enabled``: on CUDA), both collapse into one
    ``pdist_rankeval`` launch, bit-identical on the same device.  The
    predicted ring box is then widened by the certified per-group
    rank-error bound, so it is a superset of the host's box.
    """
    B = qf.shape[0]
    K, n_max, m = snap.rids.shape
    d = snap.rows.shape[-1]
    N = n_rings
    r_g = rf * (1.0 + _R_REL) + _R_ABS                      # (B,)
    if fused is None:
        fused = ops.fused_plan_enabled(qf.device)
    G = K * m
    if fused:
        dq, rank_lo, rank_hi = ops.pdist_rankeval(
            qf, snap.pivots.reshape(G, d), snap.coef.reshape(G, -1),
            snap.model_lo.reshape(-1), snap.model_hi.reshape(-1),
            snap.model_n.reshape(-1), r_g, n_rings=N)
    else:
        dq = torch.sqrt(torch.clamp(
            ops.pdist(qf, snap.pivots.reshape(G, d)), min=0.0))
        # one rankeval launch: G groups × (lo | hi) boundaries of all B
        x = torch.cat([(dq - r_g[:, None]).T,
                       (dq + r_g[:, None]).T], dim=1)        # (G, 2B)
        rank, _ = ops.rankeval(
            x, snap.coef.reshape(G, -1), snap.model_lo.reshape(-1),
            snap.model_hi.reshape(-1), snap.model_n.reshape(-1),
            n_rings=N)
        rank_lo, rank_hi = rank[:, :B], rank[:, B:]
    dqr = dq.reshape(B, K, m)
    # TriPrune, per query per cluster
    alive = torch.all((dqr <= snap.dmax[None] + r_g[:, None, None]) &
                      (dqr >= snap.dmin[None] - r_g[:, None, None]),
                      dim=-1) & (snap.ns[None] > 0)         # (B, K)
    err = snap.rank_err.reshape(-1)[:, None]                # (G, 1)
    lo_rank = torch.clamp(rank_lo.to(torch.float32) - err, min=0.0)
    hi_rank = rank_hi.to(torch.float32) + err
    w = snap.width[None, :, None].to(torch.float32)
    rid_lo = torch.clamp(torch.floor(lo_rank.T.reshape(B, K, m) / w),
                         0, N - 1).to(torch.int32)
    rid_hi = torch.clamp(torch.floor(hi_rank.T.reshape(B, K, m) / w),
                         0, N - 1).to(torch.int32)
    box = torch.all((snap.rids[None] >= rid_lo[:, :, None, :]) &
                    (snap.rids[None] <= rid_hi[:, :, None, :]),
                    dim=-1)                                 # (B, K, n_max)
    cand = (box & alive[:, :, None] & snap.in_ring[None]) | \
        snap.always[None]
    cand = cand & snap.valid[None]
    return cand.reshape(B, K * n_max), alive


@dataclass(eq=False)
class CandidatePlan:
    """One query batch's certified plan, built once and consumed by
    whichever execution backend runs the batch (resident or paged).

    ``radii`` are the round-0 radii (a range query's own radii; a kNN
    batch's pivot-distance seeds) and ``growth`` the deterministic
    per-round multiplier (1 for range — there is only round 0; 2 for
    kNN).  The mask and routing are evaluated lazily on the device and
    cached, and so is their host copy.
    """

    kind: str                    # "range" | "knn"
    B: int                       # batch size
    k: int | None                # kNN k (clamped to live); None for range
    max_rounds: int              # schedule length
    growth: float                # radius multiplier per round
    radii: np.ndarray            # (B,) f64 round-0 radii
    _planner: "Planner" = field(repr=False, default=None)
    _qf: torch.Tensor = field(repr=False, default=None)
    _dev: tuple | None = field(repr=False, default=None)
    _mask_np: np.ndarray | None = field(repr=False, default=None)
    _routing_np: np.ndarray | None = field(repr=False, default=None)
    # cached compacted-gather decision: None = not evaluated yet,
    # (slots,) = dense gather indices, (None,) = union too large to pay
    _compact: tuple | None = field(repr=False, default=None)
    # page arrays the paged backend pinned for this plan's execution;
    # drained by the executor's release (finally), so an error mid-batch
    # cannot leak a batch's pins
    _pins: list = field(repr=False, default_factory=list)
    # seconds spent constructing the plan (the profile's "plan" stage)
    plan_s: float = 0.0

    @property
    def qf(self) -> torch.Tensor:
        """(B, d) f32 device queries (shared by every plan consumer)."""
        return self._qf

    def radius_at(self, t: int) -> np.ndarray:
        """(B,) f64 schedule radii for round ``t`` — known for every
        round the moment the plan exists (what prefetch relies on)."""
        return self.radii * (self.growth ** t)

    def _device(self) -> tuple:
        if self._dev is None:
            rf = torch.from_numpy(self.radii.astype(np.float32)).to(
                self._qf.device)
            self._dev = self._planner.ex._plan_arrays(self._qf, rf)
        return self._dev

    @property
    def mask_dev(self) -> torch.Tensor:
        """(B, P) bool device candidate mask at round 0."""
        return self._device()[0]

    @property
    def routing_dev(self) -> torch.Tensor:
        """(B, K) bool device TriPrune cluster routing at round 0."""
        return self._device()[1]

    @property
    def mask(self) -> np.ndarray:
        """Host copy of :attr:`mask_dev` (materialized once)."""
        if self._mask_np is None:
            self._mask_np = self.mask_dev.cpu().numpy()
            self._planner.ex._count_sync()
        return self._mask_np

    @property
    def routing(self) -> np.ndarray:
        """Host copy of :attr:`routing_dev` (materialized once)."""
        if self._routing_np is None:
            self._routing_np = self.routing_dev.cpu().numpy()
            self._planner.ex._count_sync()
        return self._routing_np

    def compact_slots(self) -> np.ndarray | None:
        """Sorted flat slot ids of the *union* certified candidate set at
        round-0 radii, or None when compaction cannot pay (union >
        ``_COMPACT_MAX_FRAC`` of the slots).  The resident backend
        gathers exactly these rows into a power-of-two bucket and runs
        the ball prefilter over the dense array; every slot not listed
        is a non-candidate for every query of the batch."""
        if self._compact is None:
            mask = self.mask
            slots = np.nonzero(mask.any(axis=0))[0]
            limit = int(mask.shape[1] * _COMPACT_MAX_FRAC)
            self._compact = (None,) if slots.size > limit else (slots,)
        return self._compact[0]

    def subset(self, idx: np.ndarray, planner: "Planner | None" = None,
               device=None) -> "CandidatePlan":
        """The plan restricted to queries ``idx`` — what the router
        dispatches to a replica.  A subset is a view, not a rebuild: it
        does not bump the planner's ``built`` counter, so one plan per
        batch still holds.

        Plan rows are functions of their own query alone, so slicing the
        batch axis keeps certification exact.  Host copies already
        materialized are sliced; device arrays (``_dev``) and the
        compacted-gather decision are not carried — the receiving
        executor re-evaluates them on its own device, with ``device``
        placing the sliced queries there first — and page pins start
        from an empty ledger of the subset's own.  ``planner`` rebinds
        the subset to the replica executor that will run it."""
        idx = np.asarray(idx, np.int64)
        qf = self._qf[torch.from_numpy(idx).to(self._qf.device)]
        if device is not None:
            qf = qf.to(device)
        return CandidatePlan(
            kind=self.kind, B=len(idx), k=self.k,
            max_rounds=self.max_rounds, growth=self.growth,
            radii=self.radii[idx],
            _planner=planner if planner is not None else self._planner,
            _qf=qf,
            _mask_np=None if self._mask_np is None else self._mask_np[idx],
            _routing_np=None if self._routing_np is None
            else self._routing_np[idx],
            plan_s=self.plan_s)


class Planner:
    """Builds :class:`CandidatePlan`s for one executor.

    ``built`` counts plan constructions: exactly one per query batch,
    with per-round schedule evaluations going through
    :meth:`eval_mask` instead of rebuilding anything.
    """

    def __init__(self, executor):
        # weak: the executor owns its planner (see QueryExecutor)
        self.ex = weakref.proxy(executor)
        self.built = 0

    def _queries(self, Q64: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(Q64, np.float32)).to(self.ex.snap.device)

    def plan_range(self, Q64: np.ndarray, r64: np.ndarray) -> CandidatePlan:
        """Single-round plan at the queries' own radii."""
        self.built += 1
        t0 = time.perf_counter()
        with span("planner.plan_range", {"B": int(Q64.shape[0])}):
            plan = CandidatePlan(
                kind="range", B=Q64.shape[0], k=None, max_rounds=1,
                growth=1.0, radii=np.array(r64, np.float64),
                _planner=self, _qf=self._queries(Q64))
        plan.plan_s = time.perf_counter() - t0
        _obs.count("planner.plans_built")
        return plan

    def plan_knn(self, Q64: np.ndarray, k_eff: int,
                 max_rounds: int) -> CandidatePlan:
        """Growing-radius plan seeded at the nearest live pivot.

        Pivots are data rows, so the seed ball is non-empty and doubling
        reaches the k-th ball in O(log) rounds.  Clusters with no live
        slots (deleted out, or the inert padding a sharded snapshot
        carries) hold stale or zero pivot rows — they are masked so they
        cannot collapse the seed below any real point's distance.  The
        query→pivot distances come from the executor (one ``pdist``
        launch, or one a shard).
        """
        self.built += 1
        t0 = time.perf_counter()
        with span("planner.plan_knn",
                  {"B": int(Q64.shape[0]), "k": int(k_eff)}):
            s = self.ex.snap
            qf = self._queries(Q64)
            K, n_max, m = s.rids.shape
            dq = self.ex._pivot_dists(qf).cpu().numpy()
            self.ex._count_sync()
            live_k = s.valid_np.reshape(K, n_max).any(axis=1)   # (K,)
            dqm = np.where(np.repeat(live_k, m)[None], dq, np.inf)
            r0 = dqm.min(axis=1).astype(np.float64) * (1.0 + _SEED_REL) \
                + _BALL_ABS
            plan = CandidatePlan(
                kind="knn", B=Q64.shape[0], k=int(k_eff),
                max_rounds=int(max_rounds), growth=2.0, radii=r0,
                _planner=self, _qf=qf)
        plan.plan_s = time.perf_counter() - t0
        _obs.count("planner.plans_built")
        return plan

    def eval_mask(self, qf: torch.Tensor, radii: np.ndarray) -> np.ndarray:
        """(B, P) host candidate mask at explicit per-query radii — the
        paged backend's per-round schedule evaluation."""
        rf = torch.from_numpy(np.asarray(radii, np.float32)).to(qf.device)
        cand, _ = self.ex._plan_arrays(qf, rf)
        cand = cand.cpu().numpy()
        self.ex._count_sync()
        _obs.count("planner.round_evals")
        return cand


__all__ = ["CandidatePlan", "Planner", "plan_arrays"]
