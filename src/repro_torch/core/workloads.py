"""Host-side arithmetic behind the engine's operations, copied from the
JAX package's ``repro.core.workloads`` so the port imports nothing of it.

* ``host_bucket_ids`` — the Array Division Procedure's equal-width bucket
  rule (§3.1) evaluated exactly in numpy unsigned arithmetic.  The port's
  ``core.engine._paper_ids`` must agree with it bit for bit.
* ``topk_cut`` — the top-k skip rule: the smallest prefix of buckets whose
  cumulative count covers ``k``; every bucket past the cut is wholly past
  rank ``k`` and is never sorted.
* ``host_top_k`` — the host executor: bucket, cut, sort only the kept
  prefix, slice the head.
* ``check_sorted`` — ascending check.
* ``merge_sorted_arrays`` — the O(n+m) streaming-merge gather
  (``searchsorted`` positions + boolean-mask scatter).

Plain numpy, no torch.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "WORKLOAD_OPS",
    "TopKTooLarge",
    "host_bucket_ids",
    "topk_cut",
    "host_top_k",
    "check_sorted",
    "merge_sorted_arrays",
]

# The engine's operation axis.
WORKLOAD_OPS = ("sort", "top_k", "pairs_pytree", "merge")


class TopKTooLarge(ValueError):
    """``top_k(keys, k)`` was asked for more elements than exist."""


def host_bucket_ids(x: np.ndarray, num_buckets: int) -> np.ndarray:
    """Exact equal-width bucket ids, matching the simulated kernel's rule.

    Integer dtypes use the same unsigned-wraparound arithmetic as the
    traced path (`width = (hi - lo) // P + 1` in uint32/uint64), so the
    histogram computed here is exactly the histogram the kernel will
    scatter — the contract the top-k planner relies on.  Floats use the
    same float32/float64 safe-width rule.
    """
    x = np.asarray(x).ravel()
    if x.size == 0:
        return np.zeros(0, dtype=np.int64)
    lo, hi = x.min(), x.max()
    if np.issubdtype(x.dtype, np.integer):
        u = np.uint64 if x.dtype.itemsize == 8 else np.uint32
        # two's-complement wraparound is the exactness mechanism here
        # (signed span via unsigned subtraction), not an error
        with np.errstate(over="ignore"):
            lo_u = lo.astype(u)
            width = (hi.astype(u) - lo_u) // u(num_buckets) + u(1)
            ids = ((x.astype(u) - lo_u) // width).astype(np.int64)
    else:
        f = np.float64 if x.dtype == np.float64 else np.float32
        lo_f = lo.astype(f)
        width = (hi.astype(f) - lo_f) / f(num_buckets)
        if not width > 0:
            width = f(1.0)
        ids = np.floor((x.astype(f) - lo_f) / width).astype(np.int64)
    return np.clip(ids, 0, num_buckets - 1)


def topk_cut(counts: np.ndarray, k: int) -> tuple[int, int]:
    """Top-k skip rule: ``(keep, skipped)`` bucket counts for rank ``k``.

    ``keep`` is the smallest prefix length with ``sum(counts[:keep]) >= k``;
    the remaining ``skipped`` buckets hold only values past rank ``k`` (the
    equal-width rule orders buckets by value range) and need never be
    sorted.
    """
    counts = np.asarray(counts)
    c = np.cumsum(counts)
    keep = int(np.searchsorted(c, max(int(k), 1), side="left")) + 1
    keep = min(keep, counts.size)
    return keep, counts.size - keep


def host_top_k(
    x: np.ndarray, k: int, num_buckets: int
) -> tuple[np.ndarray, dict]:
    """Host top-k executor: bucket, cut, sort only the kept prefix.

    Returns ``(head, info)`` where ``head == np.sort(x)[:k]`` exactly and
    ``info`` reports the skip accounting (kept/skipped buckets, kept
    element count).
    """
    x = np.asarray(x).ravel()
    k = int(k)
    if k <= 0:
        return x[:0].copy(), {
            "keep_buckets": 0,
            "skipped_buckets": num_buckets,
            "kept_count": 0,
        }
    ids = host_bucket_ids(x, num_buckets)
    counts = np.bincount(ids, minlength=num_buckets)
    keep, skipped = topk_cut(counts, k)
    kept = x[ids < keep]
    head = np.sort(kept)[:k]
    return head, {
        "keep_buckets": keep,
        "skipped_buckets": skipped,
        "kept_count": int(kept.size),
    }


def check_sorted(buf: np.ndarray) -> bool:
    """True when ``buf`` is ascending (ties allowed)."""
    buf = np.asarray(buf).ravel()
    if buf.size <= 1:
        return True
    return bool(np.all(buf[:-1] <= buf[1:]))


def merge_sorted_arrays(
    sorted_buf: np.ndarray, new_sorted: np.ndarray, *, check: bool = False
) -> np.ndarray:
    """Merge two ascending arrays in O(n + m) — no re-sort.

    Every element of ``new_sorted`` lands at ``searchsorted(buf, v,
    'right') + rank`` (ties insert after existing equals, keeping the merge
    stable in the buffer-first sense), and the buffer elements fill the
    remaining slots in order.  With ``check=True`` both inputs are
    validated ascending (O(n + m)).
    """
    a = np.asarray(sorted_buf).ravel()
    b = np.asarray(new_sorted).ravel()
    if a.dtype != b.dtype:
        raise ValueError(
            f"merge_sorted: dtype mismatch — buffer {a.dtype} vs new {b.dtype}"
        )
    if check:
        if not check_sorted(a):
            raise ValueError("merge_sorted: sorted_buf is not ascending")
        if not check_sorted(b):
            raise ValueError("merge_sorted: new keys are not ascending")
    if b.size == 0:
        return a.copy()
    if a.size == 0:
        return b.copy()
    out = np.empty(a.size + b.size, dtype=a.dtype)
    pos_b = np.searchsorted(a, b, side="right") + np.arange(b.size)
    mask = np.zeros(out.size, dtype=bool)
    mask[pos_b] = True
    out[mask] = b
    out[~mask] = a
    return out
