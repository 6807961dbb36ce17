"""Host-side bucket arithmetic, copied from the JAX package's
``repro.core.workloads`` so the port imports nothing of it.

* ``host_bucket_ids`` — the Array Division Procedure's equal-width bucket
  rule (§3.1) evaluated exactly in numpy unsigned arithmetic.  The port's
  ``core.engine._paper_ids`` must agree with it bit for bit.
* ``check_sorted`` — ascending check.

Plain numpy, no torch.
"""

from __future__ import annotations

import numpy as np

__all__ = ["host_bucket_ids", "check_sorted"]


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


def check_sorted(buf: np.ndarray) -> bool:
    """True when ``buf`` is ascending (ties allowed)."""
    buf = np.asarray(buf).ravel()
    if buf.size <= 1:
        return True
    return bool(np.all(buf[:-1] <= buf[1:]))
