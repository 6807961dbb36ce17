"""Plain NumPy reference of the OHHC sort: a sort request's answer is its
keys in ascending order, every key kept, in the request's own dtype.

``control`` breaks the configuration's one guarantee, exactness: it sorts
the keys as float32 (the nearest precision below 32-bit integers), which
rounds every key above 2^24 to 24 significant bits.
"""

from __future__ import annotations

import numpy as np


def sort(x: np.ndarray) -> np.ndarray:
    return np.sort(x, kind="stable")


def control(x: np.ndarray) -> np.ndarray:
    return np.sort(x.astype(np.float32)).astype(x.dtype)


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Positions at which an answer differs from the reference; every
    position where the length or the dtype differs."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.size, want.size)
    return int(np.count_nonzero(got != want))
