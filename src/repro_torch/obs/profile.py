"""QueryProfile: the structured record of one served batch's cost.

Port of ``repro/obs/profile.py``, copied.

The paper's headline metric is per-query cost — page accesses above
all, then candidates refined and distance computations — and the open
research directions (continuous rebalance, DIMS-style cost-based
distributed routing) need that cost measured *per served batch*, not
inferred from benchmarks.  Every executed batch therefore yields one
:class:`QueryProfile`:

* **IO** — unique pages the batch touched and pages/query (0 for the
  resident tier, real page-extent IO for the paged tier);
* **pruning power** — candidates certified per query and clusters the
  certified set touches per query (out of K), i.e. how hard TriPrune +
  the ring box actually pruned *this* batch — the signal the
  curse-of-dimensionality results say must be measured per query;
* **rounds / syncs** — growing-radius rounds and device→host syncs
  (the plan/execute acceptance metrics, now continuously recorded);
* **per-stage latency** — plan construction, backend execution, exact
  refinement, and the total.

Profiles land in a bounded ring (``REPRO_OBS_PROFILES`` records,
default 256 — a serving window, not a log) and feed the registry's
``profile.*`` histograms, so exporters see both the recent records and
the long-run distributions.  Recording is gated on ``REPRO_OBS`` like
every obs path; the executor builds the record only when enabled.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

from . import registry as _reg
from .registry import _int_knob

# every field a complete profile must carry (the completeness test
# asserts these are present and non-None across resident / paged /
# sharded configs)
REQUIRED_FIELDS = (
    "kind", "batch", "backend", "storage", "n_shards", "rounds",
    "host_syncs", "pages", "pages_per_query", "candidates_per_query",
    "clusters_per_query", "n_clusters", "stages", "total_s",
)
REQUIRED_STAGES = ("plan", "execute", "refine")


@dataclass
class QueryProfile:
    """One served batch's cost record (see module doc)."""

    kind: str                    # "range" | "knn"
    batch: int                   # queries in the batch
    k: int | None                # kNN k (None for range)
    backend: str                 # "resident" | "paged"
    driver: str | None           # kNN driver (loop|rounds|paged); None range
    storage: str                 # "resident" | "paged"
    n_shards: int
    rounds: int                  # growing-radius rounds (1 for range)
    host_syncs: int              # device→host materializations
    pages: int                   # unique pages touched (0 resident)
    pages_per_query: float       # the paper's IO metric
    candidates_per_query: float  # certified candidate rows / query
    clusters_per_query: float    # clusters the certified set spans / query
    n_clusters: int              # K, for interpreting the pruning power
    stages: dict = field(default_factory=dict)   # stage → seconds
    total_s: float = 0.0
    # observed rank-model error as a fraction of the certified bound E
    # (host-sampled over this batch's certified in-ring candidates; None
    # when the batch had none — optional, NOT in REQUIRED_FIELDS)
    rank_err_ratio: float | None = None

    def as_dict(self) -> dict:
        return {
            "kind": self.kind, "batch": self.batch, "k": self.k,
            "backend": self.backend, "driver": self.driver,
            "storage": self.storage, "n_shards": self.n_shards,
            "rounds": self.rounds, "host_syncs": self.host_syncs,
            "pages": self.pages,
            "pages_per_query": round(self.pages_per_query, 3),
            "candidates_per_query": round(self.candidates_per_query, 2),
            "clusters_per_query": round(self.clusters_per_query, 2),
            "n_clusters": self.n_clusters,
            "rank_err_ratio": (round(self.rank_err_ratio, 4)
                               if self.rank_err_ratio is not None else None),
            "stages_ms": {k: round(v * 1e3, 3)
                          for k, v in self.stages.items()},
            "total_ms": round(self.total_s * 1e3, 3),
        }

    def missing(self) -> list:
        """Required fields that are absent/None (empty when complete)."""
        out = [f for f in REQUIRED_FIELDS if getattr(self, f, None) is None]
        out += [f"stages.{s}" for s in REQUIRED_STAGES
                if s not in self.stages]
        return out


_LOCK = threading.Lock()
_PROFILES: deque | None = None


def profile_cap() -> int:
    """Profile ring capacity (``REPRO_OBS_PROFILES``)."""
    return _int_knob("REPRO_OBS_PROFILES", 256)


def record_profile(p: QueryProfile) -> None:
    """Append one batch's profile to the ring and fold its scalars into
    the registry's ``profile.*`` metrics (no-op when obs is off — but
    the executor already skips *building* the record then)."""
    global _PROFILES
    if _reg._MODE == "off":
        return
    with _LOCK:
        if _PROFILES is None:
            _PROFILES = deque(maxlen=profile_cap())
        _PROFILES.append(p)
    r = _reg.REGISTRY
    r.counter("profile.batches").inc()
    r.counter("profile.queries").inc(p.batch)
    r.counter("profile.pages").inc(p.pages)
    r.histogram("profile.pages_per_query").observe(p.pages_per_query)
    r.histogram("profile.candidates_per_query").observe(
        p.candidates_per_query)
    r.histogram("profile.clusters_per_query").observe(p.clusters_per_query)
    r.histogram("profile.rounds").observe(p.rounds)
    r.histogram("profile.host_syncs").observe(p.host_syncs)
    r.histogram("profile.total_s").observe(p.total_s)
    if p.rank_err_ratio is not None:
        r.histogram("profile.rank_err_ratio").observe(p.rank_err_ratio)
    for stage, dt in p.stages.items():
        r.histogram(f"profile.stage.{stage}_s").observe(dt)


def profiles(n: int | None = None) -> list:
    """The most recent ``n`` profiles (all retained when None),
    oldest first."""
    with _LOCK:
        out = list(_PROFILES) if _PROFILES is not None else []
    return out if n is None else out[-n:]


def last_profile() -> QueryProfile | None:
    with _LOCK:
        if _PROFILES:
            return _PROFILES[-1]
    return None


def clear_profiles() -> None:
    global _PROFILES
    with _LOCK:
        _PROFILES = None


__all__ = ["QueryProfile", "REQUIRED_FIELDS", "REQUIRED_STAGES",
           "clear_profiles", "last_profile", "profile_cap", "profiles",
           "record_profile"]
