"""Bucket histogram + stable in-bucket ranks: the CUDA kernel plus its
plain torch version.

Counterpart of ``repro.kernels.partition_kernel`` (Pallas TPU), the hot
spot of the Array Division Procedure (§3.1): given per-element bucket ids,

* ``counts[b]`` — population of bucket ``b``, and
* ``ranks[i]``  — #{j < i : ids[j] == ids[i]} (stable scatter offsets).

The TPU kernel walks its tiles in order and carries running counts from
tile to tile.  The CUDA kernel (``csrc/partition.cu``) cannot rely on any
block order, so it runs three passes: per-block histograms, a scan over
blocks per bucket, and a stable in-block rank.  The plain version is the
reference's one-hot exclusive cumsum, taken over chunks of ids with the
running counts carried between chunks, so it never holds an ``n x B``
matrix.  An id outside ``[0, B)`` is not counted and gets rank 0.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, bitonic

# Bucket count the kernel's shared memory takes (eight warps' running
# counts of 4 bytes each: 128 KiB).
MAX_BUCKETS = 4096

_PLAIN_CHUNK = 1 << 16


def _validate(ids: torch.Tensor, num_buckets: int) -> None:
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be flat int32, got {tuple(ids.shape)} {ids.dtype}")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"num_buckets={num_buckets} outside [1, {MAX_BUCKETS}]")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ids on {ids.device}, neither cpu nor cuda")


def bucket_count_rank_plain(ids: torch.Tensor, num_buckets: int):
    """Plain version of :func:`bucket_count_rank` (any device)."""
    _validate(ids, num_buckets)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    ranks = torch.empty(ids.shape[0], dtype=torch.int32, device=ids.device)
    cols = torch.arange(num_buckets, dtype=torch.int32, device=ids.device)
    for start in range(0, ids.shape[0], _PLAIN_CHUNK):
        onehot = (ids[start : start + _PLAIN_CHUNK, None] == cols).to(torch.int32)
        excl = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
        ranks[start : start + _PLAIN_CHUNK] = ((excl + counts) * onehot).sum(
            dim=1, dtype=torch.int32
        )
        counts += onehot.sum(dim=0, dtype=torch.int32)
    return counts, ranks


def bucket_count_rank(ids: torch.Tensor, num_buckets: int, *, debug: bool = False):
    """Histogram + stable ranks for flat int32 ``ids`` in ``[0, num_buckets)``.

    ``n == 0`` short-circuits to empty results.  ``debug=True`` checks the
    id range on the host first and raises on an id outside it.
    """
    _validate(ids, num_buckets)
    n = ids.shape[0]
    if n == 0:
        return (
            torch.zeros(num_buckets, dtype=torch.int32, device=ids.device),
            torch.zeros(0, dtype=torch.int32, device=ids.device),
        )
    if debug:
        bad = (ids < 0) | (ids >= num_buckets)
        if bool(bad.any()):
            offenders = ids[bad][:8].cpu().tolist()
            raise ValueError(f"bucket ids out of range [0, {num_buckets}): {offenders!r}")
    if ids.device.type == "cpu":
        return bucket_count_rank_plain(ids, num_buckets)
    if not ids.is_contiguous():
        raise ValueError("bucket_count_rank: ids must be contiguous")
    lib = _build.load("partition")
    tile = lib.rt_bcr_tile()
    nblk = -(-n // tile)
    counts = torch.empty(num_buckets, dtype=torch.int32, device=ids.device)
    ranks = torch.empty(n, dtype=torch.int32, device=ids.device)
    scratch = torch.empty(num_buckets * nblk, dtype=torch.int32, device=ids.device)
    code = lib.rt_bucket_count_rank(
        ids.data_ptr(),
        n,
        num_buckets,
        counts.data_ptr(),
        ranks.data_ptr(),
        scratch.data_ptr(),
        bitonic.stream_handle(),
    )
    _build.check(lib, code, "bucket_count_rank")
    bucket_count_rank.launches += 1
    return counts, ranks


bucket_count_rank.launches = 0
