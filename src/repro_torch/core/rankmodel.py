"""Rank prediction models + exponential search correction.

``RP``: a polynomial regression model (Def. 6) fit by least squares on
{(x, rank(x))} where rank(x) = |{x' < x}| (Def. 5). The paper's defaults
are degree 20 for the distance→rank models and degree 1 for the
LIMS-value→position models. Degree-20 monomial Vandermonde systems are
numerically hopeless, so we fit in the Chebyshev basis on x normalized to
[-1, 1] — the *model class* (degree-g polynomials) is identical to the
paper's; only the basis used by the solver differs.

Exactness never depends on model quality: every prediction is corrected by
exponential search over the underlying sorted array (O(log err) probes,
err = |predicted − true rank|). The number of probes is the honest "CPU
cost" of the learned index and is what the LIMS vs N-LIMS ablation
measures (N-LIMS = plain binary search from scratch, O(log n) probes).

Copied from ``repro/core/rankmodel.py``: results must match it bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PolyRankModel:
    """rank(x) ≈ chebval((x-lo)/(hi-lo)*2-1, coef); clipped to [0, n]."""
    coef: np.ndarray
    lo: float
    hi: float
    n: int

    @staticmethod
    def fit(sorted_x: np.ndarray, degree: int = 20) -> "PolyRankModel":
        import warnings
        x = np.asarray(sorted_x, dtype=np.float64)
        n = len(x)
        if n == 0:
            return PolyRankModel(np.zeros(1), 0.0, 1.0, 0)
        lo, hi = float(x[0]), float(x[-1])
        # constant model for single-element and all-equal columns: a
        # high-degree fit on <2 distinct abscissae is ill-conditioned
        # noise, and rank(anything) is 0 here anyway
        if hi <= lo:
            return PolyRankModel(np.zeros(1), lo, lo + 1.0, n)
        # rank with ties-low semantics: first occurrence index
        ranks = np.searchsorted(x, x, side="left").astype(np.float64)
        # keep the system comfortably over-determined, and never ask for
        # more degrees of freedom than there are distinct values (ties
        # collapse rows: a near-constant column would otherwise feed an
        # ill-conditioned high-degree Vandermonde to lstsq)
        n_distinct = 1 + int(np.count_nonzero(np.diff(x) > 0))
        deg = int(min(degree, max(1, n // 8), max(1, n_distinct - 1), 64))
        t = (x - lo) / (hi - lo) * 2.0 - 1.0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # least-squares in Chebyshev basis (same polynomial model class)
            coef = np.polynomial.chebyshev.chebfit(t, ranks, deg)
        if not np.all(np.isfinite(coef)):
            # explicit linear fallback: the exact ramp rank ≈ (n'-1)(t+1)/2
            # through the column's endpoints — predictions stay finite and
            # exponential search corrects the rest
            r_hi = float(ranks[-1])
            coef = np.array([r_hi / 2.0, r_hi / 2.0])
        return PolyRankModel(coef, lo, hi, n)

    def predict(self, x) -> np.ndarray:
        t = (np.asarray(x, dtype=np.float64) - self.lo) / (self.hi - self.lo) * 2.0 - 1.0
        t = np.clip(t, -1.0, 1.0)
        r = np.polynomial.chebyshev.chebval(t, self.coef)
        return np.clip(np.rint(r), 0, max(self.n - 1, 0)).astype(np.int64)

    def predict_scalar(self, x: float) -> int:
        """Fast scalar Clenshaw evaluation (pure Python floats). Model
        inference on the query path is O(degree) multiplies — this is the
        O(1)-vs-O(log n) CPU story of the paper's ablation."""
        t = (x - self.lo) / (self.hi - self.lo) * 2.0 - 1.0
        t = -1.0 if t < -1.0 else (1.0 if t > 1.0 else t)
        c = getattr(self, "_coef_list", None)
        if c is None:
            # coefficients high→low, constant term last
            c = self._coef_list = [float(v) for v in self.coef[::-1]]
        b1 = 0.0
        b2 = 0.0
        t2 = 2.0 * t
        for ck in c[:-1]:                  # Clenshaw recurrence, high→low
            b1, b2 = ck + t2 * b1 - b2, b1
        r = c[-1] + t * b1 - b2
        n1 = self.n - 1 if self.n > 0 else 0
        r = int(r + 0.5) if r > 0 else 0
        return n1 if r > n1 else r

    def nbytes(self) -> int:
        return self.coef.nbytes + 8 * 3


@dataclass
class SearchStats:
    probes: int = 0
    corrections: int = 0

    def add(self, probes: int) -> None:
        self.probes += probes
        self.corrections += 1


def exponential_search(arr, x: float, guess: int,
                       side: str = "left",
                       stats: SearchStats | None = None) -> int:
    """Position of ``x`` in sorted ``arr`` starting from a model ``guess``.

    side='left'  → first index i with arr[i] >= x   (== rank(x), Def. 5)
    side='right' → first index i with arr[i] >  x

    Doubling bracket expansion from the guess, then binary search within
    the bracket: O(log err) total probes, counted in ``stats``. Hot path:
    pure-Python comparisons on a list-like ``arr`` (no numpy scalars).
    """
    n = len(arr)
    if n == 0:
        return 0
    g = 0 if guess < 0 else (n - 1 if guess > n - 1 else int(guess))
    probes = 1
    left = side == "left"
    v = arr[g]
    at_or_after = (v >= x) if left else (v > x)
    step = 1
    if at_or_after:
        hi = g
        lo = g - 1
        while lo >= 0:
            probes += 1
            v = arr[lo]
            if not ((v >= x) if left else (v > x)):
                break
            hi = lo
            step <<= 1
            lo = g - step
        if lo < -1:
            lo = -1
        lo_i, hi_i = lo + 1, hi
    else:
        lo = g
        hi = g + 1
        while hi < n:
            probes += 1
            v = arr[hi]
            if (v >= x) if left else (v > x):
                break
            lo = hi
            step <<= 1
            hi = g + step
        if hi > n:
            hi = n
        lo_i, hi_i = lo + 1, hi
    while lo_i < hi_i:
        mid = (lo_i + hi_i) >> 1
        probes += 1
        v = arr[mid]
        if (v >= x) if left else (v > x):
            hi_i = mid
        else:
            lo_i = mid + 1
    if stats is not None:
        stats.add(probes)
    return lo_i


def binary_search(arr, x: float, side: str = "left",
                  stats: SearchStats | None = None) -> int:
    """Plain binary search (the N-LIMS baseline path): O(log n) probes."""
    lo, hi = 0, len(arr)
    probes = 0
    left = side == "left"
    while lo < hi:
        mid = (lo + hi) >> 1
        probes += 1
        v = arr[mid]
        if (v >= x) if left else (v > x):
            hi = mid
        else:
            lo = mid + 1
    if stats is not None:
        stats.add(probes)
    return lo
