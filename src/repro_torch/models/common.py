"""Shared model utilities: init, sharding rules, the layer loop.

The port's copy of ``repro.models.common``.  There is no mesh, so
``shard`` is the identity and ``AxisRules`` only carries the reference's
fields (its ``PartitionSpec`` helpers wait for the dist path).  Layer
parameters keep the reference's stacked leading-L layout, and are built
stacked (``dense_init(..., lead=(L,))``) so that no per-layer copies are
ever held beside the stack; the reference's ``maybe_scan`` is a Python
loop over that leading axis (``unstack`` for the parameters, ``layer``
for one entry of a stacked cache).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Logical → mesh axis mapping, as in the reference.  Without a mesh
    no field changes a result; the rules ride along so the model API keeps
    the reference's signatures."""

    batch: tuple[str, ...] | None = ("pod", "data")
    fsdp: str | None = "data"
    tensor: str | None = "model"
    heads: "str | None | object" = "_default"
    seq: str | None = None
    kv_seq: str | None = None
    enabled: bool = True


NO_SHARD = AxisRules(batch=None, fsdp=None, tensor=None, enabled=False)


def shard(x: torch.Tensor, rules: AxisRules, *axes) -> torch.Tensor:
    """The reference's sharding constraint; the identity without a mesh."""
    return x


# ----------------------------------------------------------------- init
def dense_init(
    gen: torch.Generator,
    shape: Sequence[int],
    in_axis=0,
    dtype=torch.float32,
    *,
    lead: tuple[int, ...] = (),
) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, std = fan_in^-½, made on
    ``gen``'s device from ``gen``.

    ``lead`` prepends stacked axes (one layer each): the fan-in comes from
    ``shape`` alone, and the stack is drawn in place at once.
    """
    fan_in = shape[in_axis] if isinstance(in_axis, int) else math.prod(shape[a] for a in in_axis)
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty((*lead, *shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


def const_init(value: float, shape: Sequence[int], dtype, device, *, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """A constant parameter (norm scales, biases), stacked like ``dense_init``."""
    return torch.full((*lead, *shape), value, dtype=dtype, device=device)


def put(dst: torch.Tensor, src: torch.Tensor, start: int) -> None:
    """Write ``src`` into ``dst`` at ``start`` along the sequence axis (1),
    in place, the start clamped so the block fits, as the reference's
    ``dynamic_update_slice`` clamps it."""
    n = src.shape[1]
    start = min(max(start, 0), dst.shape[1] - n)
    dst.narrow(1, start, n).copy_(src)


# ----------------------------------------------------------------- trees
def tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> object:
    """``tree``'s structure with ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda a: a[i], tree)


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, from one ``torch.unbind`` of
    each leaf.  Under autograd the backward of ``unbind`` is one ``stack``
    a leaf, where ``layer``'s ``a[i]`` would write a zero tensor the size
    of the whole stack for every layer."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[i] for p in parts]) for i in range(n)]
