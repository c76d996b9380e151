"""Dataset generators following the paper's §6.1.1 recipes.

No network access: Color-Histogram and Forest-Cover-Type are replaced by
distribution-matched synthetic stand-ins (marked `*_like`); GaussMix,
Skewed and Signature follow the paper's published generators verbatim
(scaled by the caller to the CPU budget).

Copied from ``repro/data/datasets.py``: results must match it bitwise.
"""
from __future__ import annotations

import numpy as np

ALPHABET = 26
SIG_LEN = 65


def gauss_mix(n: int, d: int, n_components: int = 150, std: float = 0.05,
              seed: int = 0) -> np.ndarray:
    """iDistance-style GaussMix: `n_components` normals, sigma=0.05,
    uniform-random means, values normalized to [0, 1]."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.0, 1.0, size=(n_components, d))
    comp = rng.integers(0, n_components, size=n)
    x = means[comp] + rng.normal(0.0, std, size=(n, d))
    return np.clip(x, 0.0, 1.0).astype(np.float64)


def skewed(n: int, d: int, seed: int = 0) -> np.ndarray:
    """RSMI-style Skewed: uniform data with dim i raised to power i+1
    ((x1, x2^2, ..., xd^d)); L1 norm is the paper's metric for it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(n, d))
    powers = np.arange(1, d + 1, dtype=np.float64)
    return np.power(x, powers[None, :])


def signature(n_anchors: int = 25, per_anchor: int = 4000,
              seed: int = 0) -> np.ndarray:
    """Signature dataset: 65-letter strings; each anchor spawns a cluster by
    mutating x ~ U[1,30] positions to random other letters. Returns (n, 65)
    int8-encoded strings for the edit metric."""
    rng = np.random.default_rng(seed)
    anchors = rng.integers(0, ALPHABET, size=(n_anchors, SIG_LEN))
    out = np.empty((n_anchors * per_anchor, SIG_LEN), dtype=np.int8)
    row = 0
    for a in anchors:
        for _ in range(per_anchor):
            s = a.copy()
            x = int(rng.integers(1, 31))
            pos = rng.choice(SIG_LEN, size=x, replace=False)
            # change to *other* random letters
            shift = rng.integers(1, ALPHABET, size=x)
            s[pos] = (s[pos] + shift) % ALPHABET
            out[row] = s
            row += 1
    return out


def color_histogram_like(n: int = 50_000, d: int = 32, seed: int = 0) -> np.ndarray:
    """Stand-in for the ImageNet color-histogram features: sparse-ish,
    positively skewed, correlated mixture in 32-d, rows on the simplex."""
    rng = np.random.default_rng(seed)
    k = 40
    centers = rng.dirichlet(np.full(d, 0.4), size=k)
    comp = rng.integers(0, k, size=n)
    noise = rng.gamma(0.8, 0.02, size=(n, d))
    x = centers[comp] * rng.uniform(0.5, 1.5, size=(n, 1)) + noise
    x /= x.sum(axis=1, keepdims=True)
    return x.astype(np.float64)


def forest_like(n: int = 60_000, seed: int = 0) -> np.ndarray:
    """Stand-in for 6 quantitative Forest-Cover-Type variables: correlated,
    mixed-scale cartographic measurements, normalized to [0, 1]."""
    rng = np.random.default_rng(seed)
    elev = rng.normal(0.55, 0.18, size=n)
    slope = np.abs(rng.normal(0.25, 0.12, size=n)) + 0.1 * elev
    aspect = rng.uniform(0, 1, size=n)
    h_dist = np.abs(rng.normal(0.3, 0.2, size=n)) + 0.2 * slope
    v_dist = h_dist * rng.uniform(0.2, 0.8, size=n)
    shade = 0.6 * aspect + 0.4 * rng.uniform(0, 1, size=n)
    x = np.stack([elev, aspect, slope, h_dist, v_dist, shade], axis=1)
    x -= x.min(axis=0)
    x /= np.maximum(x.max(axis=0), 1e-9)
    return x


def dataset_by_name(name: str, n: int, d: int = 8, seed: int = 0):
    """(data, metric) factory used by benchmarks."""
    if name == "gaussmix":
        return gauss_mix(n, d, seed=seed), "l2"
    if name == "skewed":
        return skewed(n, d, seed=seed), "l1"
    if name == "signature":
        per = max(1, n // 25)
        return signature(25, per, seed=seed), "edit"
    if name == "colorhist":
        return color_histogram_like(n, seed=seed), "l2"
    if name == "forest":
        return forest_like(n, seed=seed), "l2"
    raise ValueError(name)
