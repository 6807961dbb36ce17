"""Public wrappers that compose the port's kernels.

Counterpart of ``repro.kernels.ops``.  ``local_sort`` takes ``(..., n)``
and sorts the last axis, which stands in for the reference's
``jax.vmap(local_sort)`` over bucket rows: pad to the shape bucket with the
dtype max → sort every tile of every row in one launch → merge-splitting
network across tiles (odd-even transposition over sorted blocks with the
two-tile bitonic merge as the comparator, correct for any number of tiles
in ``num_tiles`` alternating half-passes).  ``local_sort_pairs`` is the
``(key, payload)`` sort of one tile on the tagged pair kernel.  On CUDA
tensors every step is a hand-written kernel; on CPU tensors the kernels'
plain versions run.
"""

from __future__ import annotations

import torch

from repro_torch import dtypes
from repro_torch.kernels import bitonic
from repro_torch.kernels.partition_kernel import MAX_BUCKETS, bucket_count_rank as _bcr

# The reference sized its tile (2**19 keys) for TPU VMEM.  The port keeps
# the same tile, so the multi-tile merge runs at the same request sizes:
# a bucket row that pads past 2**19 keys.
MAX_TILE = 1 << 19
MIN_TILE = bitonic.LANES  # 128


def _next_pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


def bucketed_length(n: int, *, min_size: int = MIN_TILE) -> int:
    """Power-of-two shape bucket for ``n`` (≥ ``min_size``).

    The shared shape-bucketing rule: the kernels pad to this length, and
    ``repro_torch.core.engine.SortEngine`` keys its executor cache on it.
    """
    return max(_next_pow2(max(n, 1)), min_size)


def local_sort(x: torch.Tensor) -> torch.Tensor:
    """Sort the last axis of ``x`` with the bitonic kernels.  Same shape.

    Pads to the shape bucket with the dtype max, so the pad tail sorts to
    the end and slicing ``[..., :n]`` recovers the sorted input.
    """
    n = x.shape[-1]
    if n <= 1:
        return x
    lead = x.shape[:-1]
    rows = x.reshape(-1, n)
    r = rows.shape[0]
    n_pad = bucketed_length(n)
    xp = torch.full((r, n_pad), dtypes.max_sentinel(x.dtype), dtype=x.dtype, device=x.device)
    xp[:, :n] = rows
    if n_pad <= MAX_TILE:
        out = bitonic.sort_tile(xp)
    else:
        num_tiles = n_pad // MAX_TILE
        tiles = bitonic.sort_tile(xp.view(r * num_tiles, MAX_TILE)).view(r, num_tiles, MAX_TILE)
        # ``num_tiles`` alternating half-passes (even, odd, even, …) sort
        # any arrangement of sorted blocks; each half-pass merges all its
        # pairs, in every row, in one launch.
        for p in range(num_tiles):
            bitonic.merge_tile_pairs(tiles, p % 2)
        out = tiles.view(r, n_pad)
    return out[:, :n].reshape(*lead, n)


def local_sort_pairs(keys: torch.Tensor, vals: torch.Tensor, *, n_valid=None):
    """Sort 1-D ``(key, payload)`` pairs by key.  Single-tile sizes (≤ MAX_TILE).

    Sentinel-safe: the pad slots and every position at or past ``n_valid``
    (default ``len(keys)``) carry a validity tag that breaks key ties, so
    real elements whose keys equal the dtype-max pad sentinel keep their
    payloads ahead of the zero-payload pad tail.
    """
    n = keys.shape[0]
    n_pad = bucketed_length(n)
    if n_pad > MAX_TILE:
        raise ValueError(f"local_sort_pairs supports n ≤ {MAX_TILE}, got {n}")
    if n_valid is None:
        n_valid = n
    kp = torch.full((n_pad,), dtypes.max_sentinel(keys.dtype), dtype=keys.dtype, device=keys.device)
    kp[:n] = keys
    vp = torch.zeros((n_pad,), dtype=vals.dtype, device=vals.device)
    vp[:n] = vals
    tags = (torch.arange(n_pad, device=keys.device) >= n_valid).to(torch.uint8)
    ks, vs = bitonic.sort_pairs_tile_tagged(kp, tags, vp)
    return ks[:n], vs[:n]


def bucket_count_rank(ids: torch.Tensor, num_buckets: int, *, debug: bool = False):
    """Histogram + stable in-bucket ranks (see ``partition_kernel``)."""
    return _bcr(ids, num_buckets, debug=debug)


def make_local_sort():
    """The ``local_sort=`` argument of the core sorts: the bitonic kernels."""
    return local_sort
