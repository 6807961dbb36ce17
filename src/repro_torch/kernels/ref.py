"""Plain-torch oracles for the port's kernels (the library-call targets).

Counterparts of ``repro.kernels.ref``.  They use PyTorch's own sort and
are never on the port's request path: tests and ``chip_smoke.py`` hold the
kernels and their plain versions against them.
"""

from __future__ import annotations

import torch


def ref_sort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1).values


def ref_sort_pairs(keys: torch.Tensor, vals: torch.Tensor):
    """Stable sort of (key, payload) pairs by key."""
    order = torch.sort(keys, stable=True).indices
    return keys[order], vals[order]


def ref_merge(a: torch.Tensor, b: torch.Tensor):
    """Merge two sorted arrays → (lo, hi) sorted halves of the union."""
    m = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
    n = a.shape[-1]
    return m[..., :n], m[..., n:]


def ref_bucket_count_rank(ids: torch.Tensor, num_buckets: int):
    """Counts and stable in-bucket ranks by the one-hot exclusive cumsum."""
    onehot = (ids[:, None] == torch.arange(num_buckets, device=ids.device)).to(
        torch.int32
    )
    counts = onehot.sum(dim=0, dtype=torch.int32)
    excl = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    ranks = (excl * onehot).sum(dim=1, dtype=torch.int32)
    return counts, ranks
