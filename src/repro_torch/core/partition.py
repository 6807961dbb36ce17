"""Array Division Procedure (§3.1) in torch: bucket ids, scatter, gather.

Counterpart of ``repro.core.partition``.  Element ``v`` goes to bucket
``⌊(v − min) / SubDivider⌋``; buckets are value ranges, so sorting each
and concatenating them in bucket order is sorted with no merge step.  The
histogram and the stable in-bucket ranks that place every key come from
the ``bucket_count_rank`` kernel (``ops.bucket_count_rank``); the scatter
and gather around it are plain tensor indexing, as they were plain XLA in
the reference.

Keys here are the port's key dtypes (``repro_torch.dtypes``): unsigned
caller keys arrive already mapped onto their signed twins.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import dtypes
from repro_torch.kernels import ops

max_sentinel = dtypes.max_sentinel
min_sentinel = dtypes.min_sentinel


def default_capacity(n: int, num_buckets: int) -> int:
    """The legacy fixed bucket capacity: ``2·ceil(n/P)`` rounded up to 8."""
    cap = int(-(-2 * n // num_buckets))
    cap += (-cap) % 8
    return cap


def pack_segments(
    keys,
    seg_lens,
    row_len: int,
    *,
    fill_value=None,
    align: str = "left",
) -> np.ndarray:
    """Pack ``B`` concatenated variable-length segments into a ``(B, row_len)``
    dense matrix (host numpy; a copy of the reference's helper).

    ``align='left'`` places each segment at the row start (the sort
    layout); ``align='right'`` right-aligns it.  ``fill_value`` defaults to
    the dtype max so left-aligned pad tails sort to the end.
    """
    keys = np.asarray(keys).ravel()
    lens = np.asarray(seg_lens, dtype=np.int64).ravel()
    if (lens < 0).any():
        raise ValueError("pack_segments: negative segment length")
    if int(lens.sum()) != keys.size:
        raise ValueError(
            f"pack_segments: seg_lens sum to {int(lens.sum())} "
            f"but keys has {keys.size} elements"
        )
    if lens.size and int(lens.max()) > row_len:
        raise ValueError(
            f"pack_segments: longest segment ({int(lens.max())}) "
            f"exceeds row_len ({row_len})"
        )
    if fill_value is None:
        fill_value = (
            np.iinfo(keys.dtype).max
            if np.issubdtype(keys.dtype, np.integer)
            else np.inf
        )
    out = np.full((lens.size, row_len), fill_value, keys.dtype)
    pos = np.arange(row_len)[None, :]
    if align == "left":
        mask = pos < lens[:, None]
    elif align == "right":
        mask = pos >= row_len - lens[:, None]
    else:
        raise ValueError(f"pack_segments: unknown align {align!r}")
    out[mask] = keys
    return out


def unpack_segments(padded, seg_lens) -> list[np.ndarray]:
    """Inverse of :func:`pack_segments` (left-aligned): row prefixes as copies."""
    padded = np.asarray(padded)
    lens = np.asarray(seg_lens, dtype=np.int64).ravel()
    if padded.shape[0] != lens.size:
        raise ValueError(
            f"unpack_segments: {padded.shape[0]} rows vs {lens.size} lengths"
        )
    return [padded[i, : int(n)].copy() for i, n in enumerate(lens)]


def paper_bucket_ids(x: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """§3.1 equal-width value-range bucket ids in ``[0, num_buckets)``.

    Float-based, like the reference's: not exact for integer keys above
    2^24, and computed on the port's keys (for mapped unsigned keys the
    float rounding can differ from the caller's).  The engine's sim path
    uses the exact integer rule ``engine._paper_ids`` instead.
    """
    ftype = torch.float64 if x.dtype == torch.int64 else torch.float32
    lo = x.min().to(ftype)
    hi = x.max().to(ftype)
    width = (hi - lo) / num_buckets
    safe_width = torch.where(width > 0, width, torch.ones_like(width))
    ids = torch.floor((x.to(ftype) - lo) / safe_width).to(torch.int32)
    return torch.clamp(ids, 0, num_buckets - 1)


def sampled_splitters(x: torch.Tensor, num_buckets: int, *, oversample: int = 32) -> torch.Tensor:
    """``num_buckets − 1`` splitters from a strided oversampled sample."""
    x = x.reshape(-1)
    n = x.shape[0]
    s = min(n, max(num_buckets * oversample, num_buckets))
    stride = -(-n // s)
    sample = torch.sort(x[::stride]).values
    pos = (torch.arange(1, num_buckets, device=x.device) * sample.shape[0]) // num_buckets
    return sample[pos]


def splitter_bucket_ids(x: torch.Tensor, splitters: torch.Tensor) -> torch.Tensor:
    """Bucket ids via searchsorted on sorted splitters (len = buckets − 1)."""
    return torch.searchsorted(splitters, x, right=True).to(torch.int32)


def bucket_counts(bucket_ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Histogram of bucket ids, shape (num_buckets,) int32."""
    return ops.bucket_count_rank(bucket_ids.to(torch.int32), num_buckets)[0]


def bucket_ranks(bucket_ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """rank[i] = #{j < i : bucket_ids[j] == bucket_ids[i]} (stable)."""
    return ops.bucket_count_rank(bucket_ids.to(torch.int32), num_buckets)[1]


def scatter_to_buckets(
    x: torch.Tensor,
    bucket_ids: torch.Tensor,
    num_buckets: int,
    capacity: int,
    *,
    fill_value=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter elements into a dense (num_buckets, capacity) buffer.

    Returns (buckets, counts).  Elements beyond ``capacity`` in a bucket go
    to one drop slot past the end; ``counts`` is CLIPPED to capacity, so
    overflow shows as ``counts.sum() < x.numel()`` (the engine escalates).
    ``fill_value`` defaults to the dtype max so padded tails sort to the end.
    """
    x = x.reshape(-1)
    if fill_value is None:
        fill_value = max_sentinel(x.dtype)
    counts, ranks = ops.bucket_count_rank(bucket_ids.to(torch.int32), num_buckets)
    counts = torch.clamp(counts, max=capacity)
    keep = ranks < capacity
    flat_idx = torch.where(
        keep,
        bucket_ids.to(torch.int64) * capacity + ranks,
        num_buckets * capacity,
    )
    out = torch.full((num_buckets * capacity + 1,), fill_value, dtype=x.dtype, device=x.device)
    out[flat_idx] = x
    return out[:-1].view(num_buckets, capacity), counts


def scatter_rows_to_buckets(
    x: torch.Tensor,
    bucket_ids: torch.Tensor,
    num_buckets: int,
    capacity: int,
    *,
    fill_value=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`scatter_to_buckets` of every row of a ``(R, n)`` batch.

    Returns ``(R, num_buckets, capacity)`` buckets and ``(R, num_buckets)``
    counts.  Row ``r``'s ids are offset by ``r·num_buckets`` so one
    count/rank launch serves many rows; a launch takes at most
    ``ops.MAX_BUCKETS`` buckets, so the rows go in groups of that many.
    """
    rows, n = x.shape
    per = max(1, ops.MAX_BUCKETS // num_buckets)
    offset = (torch.arange(rows, device=x.device, dtype=torch.int32) % per) * num_buckets
    ids = bucket_ids.to(torch.int32) + offset[:, None]
    parts = [
        scatter_to_buckets(
            x[g : g + per], ids[g : g + per].reshape(-1),
            min(per, rows - g) * num_buckets, capacity, fill_value=fill_value,
        )
        for g in range(0, rows, per)
    ]
    buckets = torch.cat([b for b, _ in parts]).view(rows, num_buckets, capacity)
    counts = torch.cat([c for _, c in parts]).view(rows, num_buckets)
    return buckets, counts


def unscatter(buckets: torch.Tensor, counts: torch.Tensor, total: int) -> torch.Tensor:
    """Concatenate bucket prefixes (bucket order) into a flat array of ``total``.

    Buckets are range-partitioned and each is sorted, so the result is
    globally sorted — §3.1's merge-free gather.  ``(..., B, capacity)``
    buckets with ``(..., B)`` counts gather every leading row at once into
    ``(..., total)``.
    """
    *lead, num_buckets, capacity = buckets.shape
    counts = counts.reshape(-1, num_buckets).to(torch.int64)
    rows = counts.shape[0]
    offsets = torch.cumsum(counts, dim=-1) - counts
    offsets += torch.arange(rows, device=buckets.device)[:, None] * total
    pos_in_bucket = torch.arange(capacity, device=buckets.device)
    valid = pos_in_bucket < counts[..., None]
    dest = torch.where(valid, offsets[..., None] + pos_in_bucket, rows * total)
    out = torch.zeros(rows * total + 1, dtype=buckets.dtype, device=buckets.device)
    out[dest.reshape(-1)] = buckets.reshape(-1)
    return out[:-1].view(*lead, total)


# Exact host-side twin of the engine's integer equal-width rule.
from repro_torch.core.workloads import host_bucket_ids  # noqa: E402,F401
