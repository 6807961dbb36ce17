"""Collective tricks for the slow (inter-pod) tier, over a mesh's groups.

The port's copy of ``repro.runtime.collectives``.  The paper's scheduling
insight — do the heavy lifting on the cheap electrical links, cross the
optical tier once — maps to two primitives, each called by every rank of
the mesh on its own tensor (where the reference calls them inside
``shard_map``):

* ``hierarchical_psum``: reduce-scatter inside the pod (fast dim), ONE
  all-reduce across pods on the 1/|fast|-sized shard, all-gather inside
  the pod.  Inter-pod bytes drop from the full tensor to
  full tensor / |fast|.
* ``int8_psum``: QSGD-style quantise → integer sum → dequantise, for
  gradient reductions where 4× fewer bytes beat the quantisation noise
  (pair with error feedback from ``repro_torch.optim.compression``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.runtime import ranks


def int8_psum(x: torch.Tensor, axis_name: str, *, mesh) -> torch.Tensor:
    """Quantised sum over the mesh dim ``axis_name``: int32 accumulation,
    one float32 scale (the MAX of the ranks' scales)."""
    group = mesh.get_group(axis_name)
    xf = x.to(torch.float32)
    scale = (xf.abs().max() / 127.0 + 1e-12).reshape(1)
    # every participant must use the SAME scale → max-reduce the scales
    ranks.all_reduce(scale, dist.ReduceOp.MAX, group)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    summed = ranks.all_reduce(q, dist.ReduceOp.SUM, group)
    return (summed.to(torch.float32) * scale).to(x.dtype)


def hierarchical_psum(x: torch.Tensor, *, fast_axis: str, slow_axis: str, mesh) -> torch.Tensor:
    """Sum over (fast × slow) with minimal slow-dim traffic.

    reduce_scatter(fast) → all_reduce(slow) on the shard → all_gather(fast).
    Equivalent to a sum over both dims, but the slow tier carries 1/|fast|
    of the bytes — the paper's optical-tier economy.  A leading dim that
    |fast| does not divide falls back to one flat sum over both dims.
    """
    n_fast = ranks.mesh_sizes(mesh)[fast_axis]
    lead = x.shape[0]
    if lead % n_fast:
        # fall back for indivisible leading dims
        dims = sorted((fast_axis, slow_axis), key=mesh.mesh_dim_names.index)
        return ranks.all_reduce(x.clone(), dist.ReduceOp.SUM, ranks.axis_group(mesh, dims))
    fast = mesh.get_group(fast_axis)
    shard = x.new_empty((lead // n_fast, *x.shape[1:]))
    ranks.reduce_scatter(shard, x, fast)
    ranks.all_reduce(shard, dist.ReduceOp.SUM, mesh.get_group(slow_axis))
    return ranks.all_gather(torch.empty_like(x), shard, fast)
