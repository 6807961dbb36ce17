"""The paper's four input-array distributions (§5): random, sorted,
reverse-sorted, and 'local'.

'local' is interpreted as a *value-clustered* (gaussian) distribution —
the case where the paper's equal-width range partitioning collapses
(their local-distribution speedups stall at ~10%, §6.2): most values fall
inside a few value buckets, so a few processors receive almost everything.
The sampled-splitter (beyond-paper) method stays balanced on it, which
benchmarks demonstrate side by side.
"""

from __future__ import annotations

import numpy as np

DISTRIBUTIONS = ("random", "sorted", "reversed", "local")

# Beyond-paper: duplicate-heavy traffic (a handful of distinct values with a
# zipf-like mass).  Every splitter rule collapses on the dominant value —
# only capacity autotuning (DESIGN.md §4) survives it — so the engine tests
# and benchmarks include it alongside the paper's four.
ALL_DISTRIBUTIONS = DISTRIBUTIONS + ("dupes",)

# Paper sizes: 10..60 MB of int32 → 2.62M..15.73M elements.
PAPER_SIZES_MB = (10, 20, 30, 40, 50, 60)


def elements_for_mb(mb: int) -> int:
    return mb * (1 << 20) // 4


def key_space_max(dtype) -> int:
    """Largest generated key value for ``dtype``.

    Integer dtypes use their own representable max (capped at the int64
    max, the generation dtype) so "different integer array types" really
    exercises different key widths; float dtypes keep the paper's int32
    key space (every paper experiment sorts integer keys — float32 just
    stores them).
    """
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.integer):
        return int(min(np.iinfo(dt).max, np.iinfo(np.int64).max))
    return int(np.iinfo(np.int32).max)


def make_array(dist: str, n: int, seed: int = 0, dtype=np.int32) -> np.ndarray:
    """Generate one paper-grid input array, scaled to ``dtype``'s key space.

    For the default int32 this is bit-identical to the historical
    generator; narrower/wider integer dtypes draw from their own
    representable range so values never wrap through the final cast.
    """
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    vmax = key_space_max(dt)
    if dist == "random":
        x = rng.integers(0, vmax, n, dtype=np.int64)
    elif dist == "sorted":
        x = np.sort(rng.integers(0, vmax, n, dtype=np.int64))
    elif dist == "reversed":
        x = np.sort(rng.integers(0, vmax, n, dtype=np.int64))[::-1]
    elif dist == "dupes":
        # 16 distinct values, zipf-weighted: the most frequent value carries
        # ~a third of the array, so one bucket holds ≫ n/P regardless of the
        # splitter rule.
        vals = rng.integers(0, vmax, 16, dtype=np.int64)
        w = 1.0 / np.arange(1, 17)
        x = rng.choice(vals, size=n, p=w / w.sum())
    elif dist == "local":
        # tight gaussian cluster in the middle of the key space + a thin
        # uniform tail so min/max span the full range (worst case for
        # equal-width splitters: the span is huge, the mass is narrow).
        # The cluster width scales with the key space; for very narrow
        # dtypes (int8) it degenerates toward the dupes class, which is the
        # honest physical limit of "local" on a 127-value space.
        center = vmax // 2
        sigma = max(1.0, 1e5 * (vmax / np.iinfo(np.int32).max))
        x = rng.normal(center, sigma, n).astype(np.int64)
        k = max(n // 1000, 2)
        idx = rng.integers(0, n, k)
        x[idx] = rng.integers(0, vmax, k, dtype=np.int64)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.clip(x, 0, vmax).astype(dt)
