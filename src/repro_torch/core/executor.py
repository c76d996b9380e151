"""Plan *execution* over a resident snapshot, and exact host refinement.

Port of ``repro/core/executor.py``, resident backend only.  The planner
(``planner.py``) builds one :class:`CandidatePlan` per query batch and
``_ResidentBackend`` executes it with the kernels over the snapshot's
device rows:

  * range: the fused L2-ball prefilter (``range_filter``) applied to the
    plan's device mask — by default (``REPRO_COMPACT=on``) over the
    plan's compacted candidate gather, the union certified candidate
    rows gathered once into a power-of-two bucket, so filter bytes
    scale with TriPrune's survivors instead of padded slots;
  * kNN: the certified growing-radius schedule driven from the host,
    one round at a time (the reference's ``_knn_host_rounds``): a
    ``pdist`` distance matrix over every slot, the plan math per round,
    and ``torch.topk`` for the k-th distance.

Exactness contract: results are bit-identical to the host ``LIMSIndex``
— the plan's masks are a certified superset of the candidates, kNN
rounds certify only once the k-th ball provably fits inside the round
radius minus the guard band, and the final refinement recomputes f64
distances on the host.

Left for later slices: the paged backend, the sharded executor, the
compiled device kNN loop, the reduced-precision plane and the profiling
spans (``last_profile`` stays None).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..kernels import ops
from ..kernels.dispatch import compact_enabled
from .metrics import dist_one_to_many
from .planner import (_BALL_ABS, _R_REL, _SEED_REL, CandidatePlan, Planner,
                      plan_arrays)
from .snapshot import LIMSSnapshot

# padding rows for bucketed kernel launches: far outside any ball, large
# but finite (their squared norm is +inf, never NaN)
_FAR = ops.FAR


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


class _ResidentBackend:
    """In-memory execution: kernels over the snapshot's device rows."""

    name = "resident"

    def __init__(self, ex: "QueryExecutor"):
        self.ex = ex

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
        independent of which rows share a launch, bucket padding sits
        at 1e30 outside every ball, and slots outside the union are
        non-candidates for the whole batch in both paths."""
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
                sub = torch.cat([sub, torch.full(
                    (bucket - slots.size, s.d), _FAR, dtype=sub.dtype,
                    device=sub.device)])
            ball, _ = ops.range_filter(
                plan.qf, sub, rf * (1.0 + _R_REL) + _BALL_ABS + eps)
            ball = ball[:, :slots.size].cpu().numpy().astype(bool)
            ex._count_sync()
            hits[:, slots] = cand[:, slots] & ball
        ex.last_compact = {"slots": int(slots.size), "bucket": int(bucket),
                           "n_slots": int(s.n_slots)}
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


class QueryExecutor:
    """Single-device plan execution + exact host refinement.  Runs on
    the snapshot's device."""

    def __init__(self, snapshot: LIMSSnapshot):
        self.snap = snapshot
        self.planner = Planner(self)
        self.backend = _ResidentBackend(self)
        # {slots, bucket, n_slots} of the most recent range batch that
        # took the compacted-gather path (None when the full array
        # streamed)
        self.last_compact: dict | None = None
        # {backend, k, rounds, host_syncs, driver} of the most recent
        # kNN batch
        self.last_knn: dict | None = None
        self.last_driver: str | None = None
        # the reference's QueryProfile is not ported: stays None
        self.last_profile = None
        # per-thread sync counter, as in the reference
        self._tls = threading.local()

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
        frows, eps = s.filter_rows()
        ball, _ = ops.range_filter(qf, frows.reshape(s.n_slots, s.d),
                                   rf * (1.0 + _R_REL) + _BALL_ABS + eps)
        return ball.to(torch.bool)

    def _filter_dists(self, qf) -> tuple[torch.Tensor, float]:
        """(B, P) f32 squared distances to every slot on the filter
        plane (inf where invalid), plus the plane's margin eps."""
        s = self.snap
        frows, eps = s.filter_rows()
        d2 = ops.pdist(qf, frows.reshape(s.n_slots, s.d))
        inf = torch.full_like(d2, float("inf"))
        return torch.where(s.valid.reshape(-1)[None], d2, inf), eps

    def _refine_rows(self, idx: np.ndarray) -> np.ndarray:
        """f64 rows for flat slot ids."""
        return self.snap.rows_np[idx]

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
        s = self.snap
        hit = self.backend.range_hits(plan)
        out = []
        for b in range(Q.shape[0]):
            idx = np.nonzero(hit[b])[0]
            ids = s.gids_np[idx]
            d_true = dist_one_to_many(Q[b], self._refine_rows(idx), "l2")
            keep = d_true <= plan.radii[b]
            out.append((ids[keep], d_true[keep]))
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
        final, rounds = self.backend.knn_candidates(plan)
        self.last_knn = {"backend": self.backend.name, "k": plan.k,
                         "rounds": rounds,
                         "host_syncs": self._tls.syncs,
                         "driver": self.last_driver}
        return self._refine_topk(Q, final, plan.k)

    def _refine_topk(self, Q, final: np.ndarray, k_eff: int):
        """Exact f64 refinement of the certified candidate sets:
        ``final`` is a superset of the closed k-th ball per query, so
        the stable distance sort selects the host index's k results."""
        s = self.snap
        B = Q.shape[0]
        ids_out = np.empty((B, k_eff), np.int64)
        d_out = np.empty((B, k_eff))
        for b in range(B):
            idx = np.nonzero(final[b])[0]
            d_true = dist_one_to_many(Q[b], self._refine_rows(idx), "l2")
            sel = np.argsort(d_true, kind="stable")[:k_eff]
            ids_out[b] = s.gids_np[idx[sel]]
            d_out[b] = d_true[sel]
        return ids_out, d_out

    def knn_query(self, q, k: int):
        """Single-query convenience wrapper over the batch engine."""
        ids, dists = self.knn_query_batch(np.asarray(q)[None], k)
        return ids[0], dists[0]


__all__ = ["QueryExecutor"]
