"""Bucket histogram + stable in-bucket ranks: the CUDA kernel plus its
plain torch version.

Counterpart of ``repro.kernels.partition_kernel`` (Pallas TPU), the hot
spot of the Array Division Procedure (§3.1): given per-element bucket ids,

* ``counts[b]`` — population of bucket ``b``, and
* ``ranks[i]``  — #{j < i : ids[j] == ids[i]} (stable scatter offsets).

The TPU kernel walks its tiles in order and carries running counts from
tile to tile.  The CUDA kernel (``csrc/partition.cu``) cannot rely on any
block order, so it is one pass that takes its tiles in order from an
atomic counter and chains the running counts from tile to tile by
decoupled look-back: each id is read once and each rank written once.
The plain version is the reference's one-hot exclusive cumsum, taken over
chunks of ids with the running counts carried between chunks, so it never
holds an ``n x B`` matrix.  An id outside ``[0, B)`` is not counted and gets rank 0.
The wrapper's work is the custom operator ``repro_torch::bucket_count_rank``
(``_count_rank_op``), so a fake-tensor trace counts it as one op.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launches, bitonic

# Bucket count the kernel takes: its shared memory holds sixteen warps'
# 16-bit running counts and the tile's counts, 144 KiB at 4,096.
MAX_BUCKETS = 4096
# The kernel's status words hold a count in 30 bits, so one launch takes
# at most this many ids.
MAX_KERNEL_IDS = (1 << 30) - 1

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
    rows = torch.arange(num_buckets, dtype=torch.int32, device=ids.device)[:, None]
    for start in range(0, ids.shape[0], _PLAIN_CHUNK):
        # (bucket, id) one-hot, so the cumsum runs along contiguous rows
        onehot = (ids[None, start : start + _PLAIN_CHUNK] == rows).to(torch.int32)
        excl = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
        ranks[start : start + _PLAIN_CHUNK] = ((excl + counts[:, None]) * onehot).sum(
            dim=0, dtype=torch.int32
        )
        counts += onehot.sum(dim=1, dtype=torch.int32)
    return counts, ranks


def carry_chunks(ids: torch.Tensor, num_buckets: int, count_rank, chunk: int):
    """``count_rank(ids, num_buckets)`` as one stable pass over ``ids``,
    made of calls on consecutive chunks of at most ``chunk`` ids.

    Each chunk's ranks gain the counts of the chunks before it (for ids in
    range only: an id outside ``[0, num_buckets)`` keeps rank 0 and is not
    counted), and the counts are summed.  ``n <= chunk`` is one call."""
    n = ids.shape[0]
    if n <= chunk:
        return count_rank(ids, num_buckets)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    ranks = torch.empty(n, dtype=torch.int32, device=ids.device)
    for start in range(0, n, chunk):
        part = ids[start : start + chunk]
        c, r = count_rank(part, num_buckets)
        if start:
            before = counts.index_select(0, part.clamp(0, num_buckets - 1))
            r += torch.where((part >= 0) & (part < num_buckets), before, 0)
        ranks[start : start + chunk] = r
        counts += c
    return counts, ranks


def _launch(ids: torch.Tensor, num_buckets: int):
    """One launch of the kernel over at most ``MAX_KERNEL_IDS`` ids."""
    n = ids.shape[0]
    lib = _build.load("partition")
    tile = lib.rt_bcr_tile(num_buckets)
    nblk = -(-n // tile)
    counts = torch.empty(num_buckets, dtype=torch.int32, device=ids.device)
    ranks = torch.empty(n, dtype=torch.int32, device=ids.device)
    # one status word a (tile, bucket), then the tile counter
    scratch = torch.empty(num_buckets * nblk + 1, dtype=torch.int32, device=ids.device)
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
    _launches.count(bucket_count_rank)
    return counts, ranks


def bucket_count_rank(ids: torch.Tensor, num_buckets: int, *, debug: bool = False):
    """Histogram + stable ranks for flat int32 ``ids`` in ``[0, num_buckets)``.

    ``n == 0`` short-circuits to empty results.  ``debug=True`` checks the
    id range on the host first and raises on an id outside it.  On the card
    more than ``MAX_KERNEL_IDS`` ids take one launch a chunk of that many,
    the counts carried between them (:func:`carry_chunks`).
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
    return _count_rank_op(ids, num_buckets)


bucket_count_rank.launches = 0


@torch.library.custom_op("repro_torch::bucket_count_rank", mutates_args=())
def _count_rank_op(ids: torch.Tensor, num_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The wrapper's work as one operator: the plain version on a CPU
    tensor, the kernel on a CUDA one.  Under a fake-tensor trace its fake
    implementation stands in, so a trace sees one op with its operands and
    results, launches nothing and never expands into the plain version."""
    if ids.device.type == "cpu":
        return bucket_count_rank_plain(ids, num_buckets)
    if not ids.is_contiguous():
        raise ValueError("bucket_count_rank: ids must be contiguous")
    return carry_chunks(ids, num_buckets, _launch, MAX_KERNEL_IDS)


@_count_rank_op.register_fake
def _(ids: torch.Tensor, num_buckets: int):
    return ids.new_empty(num_buckets), ids.new_empty(ids.shape)
