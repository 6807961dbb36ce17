"""Gradient compression for the data-parallel reduction: per-tensor int8
quantisation with error feedback.

The port's copy of ``repro.optim.compression``.  ``compress_grads`` is
the numerics model (quantise → dequantise with an error-feedback residual
carried in the train state).  ``torch.round`` rounds half to even, as
``jnp.round`` does.

Over a mesh the leaves are DTensors: each leaf is quantised on its local
shard with the scale of the whole leaf (its global max, one all-reduce of
every leaf's local max together), so the result is the reference's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import is_dtensor, tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor, amax: "torch.Tensor | None" = None):
    """``amax``: the largest |x| of the whole tensor, where ``x`` is a shard."""
    xf = x.to(torch.float32)
    scale = (xf.abs().max() if amax is None else amax) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_grads(grads, error_fb):
    """Quantise each gradient leaf with error feedback.

    Returns (decompressed_grads, new_error_fb).  ``error_fb`` is a tree
    like ``grads`` (float32) carrying the quantisation residual to the
    next step.
    """

    def one(g, e, amax=None):
        gf = g.to(torch.float32) + e
        q, s = quantize_int8(gf, amax)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), gf - deq

    gs, es = tree_leaves(grads), tree_leaves(error_fb)
    if is_dtensor(gs[0]):
        out = _compress_sharded(one, gs, es)
    else:
        out = [one(g, e) for g, e in zip(gs, es)]
    return tree_unflatten(grads, [o[0] for o in out]), tree_unflatten(grads, [o[1] for o in out])


def _compress_sharded(one, gs, es):
    """``one`` on each DTensor leaf's local shard, with the leaf's global max."""
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime import ranks

    mesh = gs[0].device_mesh
    gs = [g if g.placements == e.placements else g.redistribute(mesh, e.placements) for g, e in zip(gs, es)]
    amax = torch.stack([(g.to_local().to(torch.float32) + e.to_local()).abs().max() for g, e in zip(gs, es)])
    ranks.all_reduce(amax, dist.ReduceOp.MAX, ranks.axis_group(mesh, mesh.mesh_dim_names))
    out = []
    for g, e, a in zip(gs, es, amax):
        deq, fb = one(g.to_local(), e.to_local(), a)
        out.append((DTensor.from_local(deq, mesh, g.placements, run_check=False),
                    DTensor.from_local(fb, mesh, e.placements, run_check=False)))
    return out


def init_error_fb(grads_or_params):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_or_params)
