"""Distributed sort over ranks: the port of ``repro.core.dist_sort``.

Public API
----------
``dist_sort(x, mesh=..., axis_names=..., method=...)`` — globally sort an
array whose leading axis is sharded over the mesh dims ``axis_names``.
Every rank of the mesh calls it with the same ``x``, takes its own shard
(shard *i* is the rank at flat position *i* along ``axis_names``,
row-major), and gets back one shard of the reference's output: its
``(num_shards · capacity,)`` values, sorted with the dtype-max (or +inf)
fill at the tail, and its valid count.  Shard *i* holds only keys ≤ every
key of shard *i+1*, so the valid prefixes in shard order are the sorted
array (DESIGN.md §2).

Methods
-------
* ``'sample'``  — balanced splitters from an all-gathered sample, then one
  fused ``all_to_all``.
* ``'paper'``   — §3.1 equal-width range splitters from the global min and
  max (a MIN and a MAX ``all_reduce``), then the same exchange.
* ``'hier'``    — one ``all_to_all`` across the slow outer (pod) dim, then
  one inside each pod: the paper's "cross the optical tier once".
* ``'valiant'`` — a round-robin interleave first (one more ``all_to_all``,
  which gives every rank a stratified sample of the whole array), then the
  sampled exchange: pre-sorted input no longer sends a whole shard to one
  rank, so ``capacity_factor≈2`` suffices where the direct route needs ≈P.

The kernels on this path are the port's: ``partition.scatter_to_buckets``
counts and ranks every key with K1 (``ops.bucket_count_rank``), and the
received rows are sorted by ``ops.make_local_sort()`` (K2 tiles, K3 past
2^19 keys a row).  Bucket buffers have a static ``capacity``; overflow
drops keys and shows in the counts (``sum(counts) < n``), which the engine
escalates.

Keys of an unsigned caller dtype run as their signed twins
(``repro_torch.dtypes``).  The ``paper`` edges are computed in the
caller's domain, in float32 as the reference computes them, and converted
back to the caller's integer type as XLA converts (truncation toward zero,
saturating, NaN to 0), then mapped onto the key domain: edges computed on
the mapped keys would round differently and move keys between shards.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import dtypes
from repro_torch.core import partition
from repro_torch.kernels import ops
from repro_torch.runtime import ranks

METHODS = ("sample", "paper", "valiant", "hier")


def _capacity(capacity_factor: float, n: int, buckets: int) -> int:
    cap = int(capacity_factor * -(-n // buckets))
    return cap + (-cap) % 8


def _local_splitters(local: torch.Tensor, num_shards: int, group, oversample: int) -> torch.Tensor:
    """Global splitters from an all-gathered per-shard sample."""
    n_local = local.shape[0]
    s = min(n_local, max(oversample, 1))
    stride = -(-n_local // s)  # ceil: sample must span the whole shard
    sample = local[::stride]
    gathered = sample.new_empty(sample.shape[0] * dist.get_world_size(group))
    ranks.all_gather(gathered, sample, group)
    gathered = torch.sort(gathered).values
    pos = (torch.arange(1, num_shards, device=local.device) * gathered.shape[0]) // num_shards
    return gathered[pos]


def _user_float32(keys: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """Port keys → the caller's values as float32, rounded as a conversion
    from the caller's dtype rounds."""
    return dtypes.to_user_tensor(keys, dtype).to(torch.float32)


def _saturating_keys(edges: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """float32 → the caller's integer ``dtype`` as XLA converts (toward
    zero, saturating at the type's bounds, NaN to 0), as port keys."""
    info, key_dt = np.iinfo(dtype), dtypes.key_dtype(dtype)
    high, low = edges >= float(info.max), edges <= float(info.min)
    mid = torch.where(high | low | edges.isnan(), 0.0, edges).trunc()
    keys = mid.to(getattr(torch, dtype.name))
    kinfo = np.iinfo(key_dt)  # the caller's bounds map onto the key type's
    if key_dt != dtype:  # unsigned: the map of ``dtypes.to_keys``
        keys = keys.view(getattr(torch, key_dt.name)) ^ int(kinfo.min)
    return torch.where(high, int(kinfo.max), torch.where(low, int(kinfo.min), keys))


def _paper_splitters(local: torch.Tensor, num_shards: int, group, dtype: np.dtype) -> torch.Tensor:
    """§3.1 equal-width ranges from the *global* min and max."""
    lo, hi = local.min().reshape(1), local.max().reshape(1)
    ranks.all_reduce(lo, dist.ReduceOp.MIN, group)
    ranks.all_reduce(hi, dist.ReduceOp.MAX, group)
    lo_f, hi_f = _user_float32(lo, dtype), _user_float32(hi, dtype)
    width = (hi_f - lo_f) / num_shards  # an inf pad gives inf − inf = NaN
    width = torch.where(width > 0, width, 1.0)
    edges = lo_f + width * torch.arange(1, num_shards, dtype=torch.float32, device=local.device)
    if np.issubdtype(dtype, np.integer):
        return _saturating_keys(edges, dtype)
    return edges.to(local.dtype)


def _bucket_exchange(local, splitters, num_shards: int, capacity: int, group):
    """Scatter into per-destination rows (K1) and run one fused all_to_all."""
    ids = partition.splitter_bucket_ids(local, splitters)
    buckets, counts = partition.scatter_to_buckets(
        local, ids, num_shards, capacity, fill_value=dtypes.max_sentinel(local.dtype)
    )
    # (num_shards, capacity): row d goes to group rank d
    recv = ranks.all_to_all(torch.empty_like(buckets), buckets, group)
    recv_counts = ranks.all_to_all(torch.empty_like(counts), counts, group)
    return recv, recv_counts


def _finalize(recv, recv_counts, local_sort):
    """Sort the received rows' concatenation; the padded tail sorts last."""
    return local_sort(recv.reshape(-1)), recv_counts.sum(dtype=torch.int32).reshape(1)


def dist_sort_keys(
    x_keys,
    dtype,
    *,
    mesh,
    axis_names: Sequence[str] = ("data",),
    method: str = "sample",
    capacity_factor: float = 2.0,
    oversample: int = 64,
    local_sort=None,
    device=None,
):
    """:func:`dist_sort` on port keys (``dtypes.to_keys`` of the caller's
    numpy array) of the caller's numpy ``dtype``.  Returns this rank's
    values as port keys and its count, on ``device`` (default: the mesh's)."""
    axis_names = tuple(axis_names)
    sizes = ranks.mesh_sizes(mesh)
    num_shards = 1
    for ax in axis_names:
        num_shards *= sizes[ax]
    n = x_keys.shape[0]
    if n % num_shards:
        raise ValueError(f"n={n} not divisible by shard count {num_shards}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method == "hier" and len(axis_names) < 2:
        raise ValueError("hier method needs (outer, inner) axes, e.g. ('pod','data')")
    n_local = n // num_shards
    i = ranks.shard_index(mesh, axis_names)
    local = torch.from_numpy(np.ascontiguousarray(x_keys[i * n_local : (i + 1) * n_local]))
    local = local.to(device if device is not None else ranks.mesh_device(mesh))
    local_sort = local_sort if local_sort is not None else ops.make_local_sort()
    if method == "hier":
        return _hier_impl(local, np.dtype(dtype), mesh=mesh, axis_names=axis_names,
                          sizes=tuple(sizes[a] for a in axis_names), capacity_factor=capacity_factor,
                          oversample=oversample, local_sort=local_sort)
    return _flat_impl(local, np.dtype(dtype), num_shards=num_shards,
                      capacity=_capacity(capacity_factor, n_local, num_shards), method=method,
                      oversample=oversample, group=ranks.axis_group(mesh, axis_names), local_sort=local_sort)


def dist_sort(
    x,
    *,
    mesh,
    axis_names: Sequence[str] = ("data",),
    method: str = "sample",
    capacity_factor: float = 2.0,
    oversample: int = 64,
    local_sort=None,
):
    """Globally sort ``x`` (sharded on its leading axis over ``axis_names``).

    ``x`` is the whole array, a numpy array, the same on every rank.
    Returns this rank's shard ``(values, count)``: ``values`` (of ``x``'s
    dtype, on the mesh's device) sorted with the fill at its tail,
    ``count`` a ``(1,)`` int32 tensor of its valid length.  Over all ranks, ``sum(count) == x.size``
    iff no bucket overflowed its capacity.
    """
    x = np.asarray(x).ravel()
    values, count = dist_sort_keys(
        dtypes.to_keys(x), x.dtype, mesh=mesh, axis_names=axis_names, method=method,
        capacity_factor=capacity_factor, oversample=oversample, local_sort=local_sort,
    )
    return dtypes.to_user_tensor(values, x.dtype), count


def _flat_impl(local, dtype, *, num_shards, capacity, method, oversample, group, local_sort):
    # Exchange runs over a single logical axis: when the shard spans several
    # mesh dims, ``group`` is their flattened group.
    if method == "valiant":
        # hop 1: round-robin interleave — rank d receives a stratified 1/P
        # sample from every source, destroying any value/order skew.
        per = local.shape[0] // num_shards
        head = local[: per * num_shards].reshape(num_shards, per)
        head = ranks.all_to_all(torch.empty_like(head), head, group).reshape(-1)
        # indivisible tail stays local (counted, never dropped)
        local = torch.cat([head, local[per * num_shards :]])
    if method == "paper":
        splitters = _paper_splitters(local, num_shards, group, dtype)
    else:
        splitters = _local_splitters(local, num_shards, group, oversample)
    recv, recv_counts = _bucket_exchange(local, splitters, num_shards, capacity, group)
    return _finalize(recv, recv_counts, local_sort)


def _hier_impl(local, dtype, *, mesh, axis_names, sizes, capacity_factor, oversample, local_sort):
    """Two-level exchange: global splitters, but traffic crosses the slow
    (outer/pod) dim exactly once, then fans out on the fast inner dims.

    Stage 1 (optical, once): bucket by destination *pod* and all_to_all over
    the pod dim.  Stage 2 (electrical): bucket by destination rank within
    the pod and all_to_all over the inner dims.  Equivalent result to the
    flat exchange; traffic on the slow tier is minimal and contiguous.
    """
    outer_ax, inner_ax = axis_names[0], axis_names[1:]
    outer_n = sizes[0]
    inner_n = 1
    for s in sizes[1:]:
        inner_n *= s
    num_shards = outer_n * inner_n
    n_local = local.shape[0]
    fill = dtypes.max_sentinel(local.dtype)

    splitters = _local_splitters(local, num_shards, ranks.axis_group(mesh, axis_names), oversample)
    # ---- stage 1: route to the destination pod (outer dim), one crossing.
    pod_splitters = splitters[inner_n - 1 :: inner_n]  # every inner_n-th → pod edges
    cap1 = _capacity(capacity_factor, n_local, outer_n)
    recv1, cnt1 = _bucket_exchange(local, pod_splitters, outer_n, cap1, mesh.get_group(outer_ax))
    # received rows concatenated; invalid slots hold the fill
    stage1 = recv1.reshape(-1)

    # ---- stage 2: inside the pod, route to the destination rank.
    my_pod = mesh.get_local_rank(outer_ax)
    inner_splitters = torch.cat([splitters, splitters[-1:]])[my_pod * inner_n : (my_pod + 1) * inner_n]
    inner_splitters = inner_splitters[: inner_n - 1]
    cap2 = _capacity(capacity_factor, stage1.shape[0], inner_n)
    ids = partition.splitter_bucket_ids(stage1, inner_splitters)
    # Fill slots from stage 1 carry the dtype max and would bucket to the
    # last rank: send them to a drop row (inner_n) so counts stay exact.
    pos = torch.arange(stage1.shape[0], device=stage1.device)
    is_valid = (pos % cap1) < cnt1[pos // cap1]
    ids = torch.where(is_valid, ids, inner_n)
    buckets, counts = partition.scatter_to_buckets(
        torch.where(is_valid, stage1, torch.tensor(fill, dtype=stage1.dtype, device=stage1.device)),
        ids, inner_n + 1, cap2, fill_value=fill,
    )
    buckets, counts = buckets[:inner_n], counts[:inner_n]
    inner = ranks.axis_group(mesh, inner_ax)
    recv2 = ranks.all_to_all(torch.empty_like(buckets), buckets, inner)
    cnt2 = ranks.all_to_all(torch.empty_like(counts), counts, inner)
    return _finalize(recv2, cnt2, local_sort)


def host_check_globally_sorted(values, counts) -> bool:
    """Host-side validation of the output contract: ``values`` the shards'
    values concatenated in shard order, ``counts`` their valid lengths."""
    values = np.asarray(values)
    counts = np.asarray(counts).ravel()
    shards = np.split(values, counts.size)
    prev_max = None
    for shard, c in zip(shards, counts):
        valid = np.sort(shard)[: int(c)]  # shard is sorted with fill at tail
        if not np.all(valid[:-1] <= valid[1:]):
            return False
        if prev_max is not None and valid.size and prev_max > valid[0]:
            return False
        if valid.size:
            prev_max = valid[-1]
    return True
