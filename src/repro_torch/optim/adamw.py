"""AdamW over trees of tensors: the port's copy of ``repro.optim.adamw``.

The reference's update is functional and jitted with its buffers donated,
so it never holds two copies of the parameters.  The port's counterpart
updates each leaf in place under ``torch.no_grad()``: parameters, ``m``
and ``v`` are written where they lie, and each gradient leaf's buffer is
reused for that leaf's step.  Peak memory therefore stays at parameters +
gradients + moments, plus one leaf.  ``opt_state_specs`` gives the
moments' ``Spec`` tree, which ``repro_torch.runtime.reshard_state`` lays
onto a mesh.

Over a mesh the leaves are DTensors.  AdamW is elementwise, so each leaf
is updated on its local shard (a gradient is first redistributed to its
parameter's placements); ``global_norm`` sums each leaf's local squares
once a shard, not once a replica, in one all-reduce.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.models.common import Spec, is_dtensor, local, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    first = tree_leaves(params)[0]
    count = torch.zeros((), dtype=torch.int32, device=first.device)
    if is_dtensor(first):  # replicated on the parameters' mesh
        from repro_torch.models.common import mesh_zeros

        count = mesh_zeros(first.device_mesh, torch.int32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "count": count}


def replicas(x) -> int:
    """How many ranks of its mesh hold each shard of the DTensor ``x``."""
    sizes = [n for n, p in zip(x.device_mesh.mesh.shape, x.placements) if p.is_replicate()]
    return math.prod(sizes)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together.  Over DTensors each leaf's local
    sum of squares is divided by its replica count (a power of two on a
    power-of-two mesh, so exactly) and one all-reduce over the mesh adds
    them: a replicated leaf counts once.  Returns a plain tensor, the same
    on every rank."""
    leaves = tree_leaves(tree)
    if not is_dtensor(leaves[0]):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))
    from repro_torch.runtime import ranks

    mesh = leaves[0].device_mesh
    total = sum(torch.sum(torch.square(local(x).to(torch.float32))) / replicas(x) for x in leaves)
    ranks.all_reduce(total, dist.ReduceOp.SUM, ranks.axis_group(mesh, mesh.mesh_dim_names))
    return torch.sqrt(total)


def adamw_update(params, grads, state: dict, lr: torch.Tensor, cfg: AdamWConfig = AdamWConfig()) -> dict:
    """One AdamW step, in place: ``params``, ``state["m"]``, ``state["v"]``
    and ``state["count"]`` are updated where they lie.  The gradients are
    consumed: each float32 gradient leaf holds its update afterwards.
    Returns the metrics ``grad_norm`` and ``clip_scale``."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = local(lr)
        local(state["count"]).add_(1)
        count = local(state["count"]).to(torch.float32)
        b1c = 1.0 - cfg.b1 ** count
        b2c = 1.0 - cfg.b2 ** count
        flat = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]))
        for p, g, m, v in flat:
            if is_dtensor(p):
                if g.placements != p.placements:
                    g = g.redistribute(p.device_mesh, p.placements)
                p, g, m, v = local(p), local(g), local(m), local(v)
            # g is this leaf's only scratch: g·scale, then the step
            g = g.to(torch.float32).contiguous().mul_(scale)
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            denom = torch.div(v, b2c).sqrt_().add_(cfg.eps)
            step = torch.div(m, b1c, out=g).div_(denom)
            del denom
            p32 = p.to(torch.float32)
            step.add_(p32, alpha=cfg.weight_decay)
            if p32 is p:
                p.sub_(step.mul_(lr))
            else:
                p.copy_(p32.sub_(step.mul_(lr)))
    return {"grad_norm": gnorm, "clip_scale": scale}


def opt_state_specs(param_specs):
    """m/v shard exactly like their parameters; count is replicated."""
    return {"m": param_specs, "v": param_specs, "count": Spec()}
