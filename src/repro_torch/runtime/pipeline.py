"""Pipeline parallelism (GPipe) over a ``"pipe"`` mesh dim.

The port's copy of ``repro.runtime.pipeline``.  The layer stack is split
into S stages (stage s owns layers [s·L/S, (s+1)·L/S)); a microbatched
forward streams activations stage to stage, one ``send``/``recv`` to the
next rank each tick (nearest-neighbour: on the paper's topology these are
the cheap electrical hops).  With M microbatches and S stages the bubble
fraction is (S−1)/(M+S−1).

Every rank of the mesh calls :func:`pipeline_forward`; the ranks along the
pipe dim are the stages, and each group of them along the other dims runs
its own pipeline.  Forward only, as the reference's, for any per-layer
block function of signature ``(params_l, x) → x``.  The reference's
``ppermute`` also carries the last stage's activations round to stage 0,
which ignores them; here only stages below the last send.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime import ranks


def pipeline_forward(stacked_params, x: torch.Tensor, block_fn, *, mesh, pipe_axis: str = "pipe"):
    """Run ``(M, mb, …)`` microbatches through an L-layer stack split over
    the pipe dim.  Returns the ``(M, mb, …)`` outputs on every rank.

    stacked_params: tree with leading layer axis L, L % n_stages == 0
    (every rank passes the whole stack and keeps its stage's layers).
    """
    n_stages = ranks.mesh_sizes(mesh)[pipe_axis]
    L = tree_leaves(stacked_params)[0].shape[0]
    assert L % n_stages == 0, (L, n_stages)
    M = x.shape[0]
    per = L // n_stages
    stage = mesh.get_local_rank(pipe_axis)
    group = mesh.get_group(pipe_axis)
    peers = dist.get_process_group_ranks(group)  # global ranks in stage order
    params = tree_map(lambda a: a[stage * per : (stage + 1) * per], stacked_params)
    layers = [tree_map(lambda a, i=i: a[i], params) for i in range(per)]

    def run_stage(h):
        for p in layers:
            h = block_fn(p, h)
        return h

    out = torch.zeros_like(x)
    buf = torch.zeros_like(x[0])
    for t in range(M + n_stages - 1):
        # stage s works on microbatch t − s when 0 ≤ t − s < M
        mb_idx = t - stage
        active = 0 <= mb_idx < M
        y = run_stage(x[min(t, M - 1)] if stage == 0 else buf) if active else buf
        if active and stage == n_stages - 1:
            out[mb_idx] = y  # the last stage emits finished microbatches
        # stream to the next stage (nearest-neighbour hop)
        send = y if stage < n_stages - 1 else None
        recv = torch.empty_like(buf) if stage > 0 else None
        ranks.exchange(send, peers[stage + 1] if send is not None else None,
                       recv, peers[stage - 1] if recv is not None else None)
        if recv is not None:
            buf = recv
    # only the last stage holds real outputs; a sum over the dim gives them to all
    if stage != n_stages - 1:
        out.zero_()
    return ranks.all_reduce(out, dist.ReduceOp.SUM, group)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
