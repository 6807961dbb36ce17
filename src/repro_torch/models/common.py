"""Shared model utilities: init, sharding rules, the layer loop.

The port's copy of ``repro.models.common``.  There is no mesh, so
``shard`` is the identity.  ``AxisRules.spec`` gives the reference's
``PartitionSpec`` as a ``Spec`` (a tuple of mesh-axis entries), which the
dry-run (``repro_torch.launch``) sanitizes and divides shapes by.  Layer
parameters keep the reference's stacked leading-L layout, and are built
stacked (``dense_init(..., lead=(L,))``) so that no per-layer copies are
ever held beside the stack; the reference's ``maybe_scan`` is a Python
loop over that leading axis (``unstack`` for the parameters, ``layer``
for one entry of a stacked cache).

Inside ``shapes_only()`` every ``dense_init`` and ``const_init`` makes a
meta tensor and draws nothing: the port's ``jax.eval_shape`` of an init.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Sequence

import torch


class Spec(tuple):
    """The port's ``PartitionSpec``: one entry a dimension, each a mesh axis
    name, ``None`` (replicated) or a tuple of axis names.  A tuple, so it
    equals the reference's spec read as a tuple; a leaf of a spec tree.
    Entries are canonical as ``PartitionSpec`` makes them: a list is a
    tuple, a one-axis tuple its axis, an empty one ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Logical → mesh axis mapping, as in the reference.  Without a mesh
    no field changes a result; the rules ride along so the model API keeps
    the reference's signatures.

    batch:  activation batch dim (tuple of mesh axes, e.g. ('pod','data'))
    fsdp:   weight shard axis (ZeRO-3 style)
    tensor: tensor-parallel axis (heads / ffn / experts / vocab)
    heads:  attention-head activation axis (defaults to tensor; None with
            ``seq`` set for sequence parallelism when head counts don't
            divide the TP axis)
    seq:    sequence activation axis (SP / context parallelism)
    kv_seq: KV-cache sequence axis

    ``seq_shards`` is the port's own: the devices a sequence is split over
    in a per-device trace under SP (``repro_torch.launch.dryrun``), where
    attention gathers K/V to the whole sequence (``gather_seq``).  It is 1
    in every real run.
    """

    batch: tuple[str, ...] | None = ("pod", "data")
    fsdp: str | None = "data"
    tensor: str | None = "model"
    heads: "str | None | object" = "_default"
    seq: str | None = None
    kv_seq: str | None = None
    enabled: bool = True
    seq_shards: int = 1

    def spec(self, *axes) -> Spec:
        """Spec from logical names:
        'batch'|'fsdp'|'tensor'|'heads'|'seq'|'kv_seq'|None|raw-mesh-axis."""
        named = {
            "batch": self.batch,
            "fsdp": self.fsdp,
            "tensor": self.tensor,
            "heads": self.tensor if self.heads == "_default" else self.heads,
            "seq": self.seq,
            "kv_seq": self.kv_seq,
        }
        out = [named[a] if a in named else a for a in axes]  # a raw mesh axis passes through
        # a mesh axis may appear at most once per spec: first occurrence
        # wins (SP mode maps seq→model, so tensor entries later in the same
        # spec must drop to replicated).
        seen: set = set()
        dedup = []
        for e in out:
            names = (e,) if isinstance(e, str) else tuple(e or ())
            if any(n in seen for n in names):
                dedup.append(None)
            else:
                seen.update(names)
                dedup.append(e)
        return Spec(*dedup)


NO_SHARD = AxisRules(batch=None, fsdp=None, tensor=None, enabled=False)


def shard(x: torch.Tensor, rules: AxisRules, *axes) -> torch.Tensor:
    """The reference's sharding constraint; the identity without a mesh."""
    return x


def gather_seq(x: torch.Tensor, rules: AxisRules) -> torch.Tensor:
    """K or V (B, S, heads, dim) all-gathered over the sequence's shards
    before attention: the identity in a real run (``seq_shards`` = 1); in a
    per-device trace under SP, the slice repeated to the whole sequence's
    length, which the trace counts as the gathered tensor."""
    n = rules.seq_shards
    return x if n == 1 else x.repeat(1, n, *([1] * (x.dim() - 2)))


# ------------------------------------------------------------ spec trees
def spec_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over every ``Spec`` leaf of ``specs`` and the
    matching leaves of ``trees`` (dicts, tuples and lists, as ``tree_map``);
    a leaf of ``specs`` that is not a ``Spec`` stays as it is."""
    if isinstance(specs, Spec):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: spec_map(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    if isinstance(specs, (tuple, list)):
        return type(specs)(spec_map(fn, v, *(t[i] for t in trees)) for i, v in enumerate(specs))
    return specs


def spec_items(specs, path: tuple = ()) -> list:
    """(path, Spec) for every ``Spec`` leaf of a spec tree, in
    ``tree_leaves`` order; a path is the tuple of its keys as strings."""
    if isinstance(specs, Spec):
        return [(path, specs)]
    if isinstance(specs, (dict, tuple, list)):
        items = specs.items() if isinstance(specs, dict) else enumerate(specs)
        return [leaf for k, v in items for leaf in spec_items(v, path + (str(k),))]
    return []


def prepend_none_spec(specs):
    """Layer-stacked params get an unsharded leading axis."""
    return spec_map(lambda s: Spec(None, *s), specs)


# ------------------------------------------------------------ shapes only
_SHAPES_ONLY = threading.local()


@contextlib.contextmanager
def shapes_only():
    """Within it, ``dense_init`` and ``const_init`` make meta tensors (the
    shape and dtype, no storage) and draw nothing from the generator."""
    before = getattr(_SHAPES_ONLY, "on", False)
    _SHAPES_ONLY.on = True
    try:
        yield
    finally:
        _SHAPES_ONLY.on = before


def init_device(device) -> torch.device:
    """Where an init makes a tensor: ``device``, or the meta device inside
    ``shapes_only()``."""
    return torch.device("meta") if getattr(_SHAPES_ONLY, "on", False) else torch.device(device)


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
    device = init_device(gen.device)
    if device.type == "meta":
        return torch.empty((*lead, *shape), dtype=dtype, device=device)
    w = torch.empty((*lead, *shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


def const_init(value: float, shape: Sequence[int], dtype, device, *, lead: tuple[int, ...] = ()) -> torch.Tensor:
    """A constant parameter (norm scales, biases), stacked like ``dense_init``."""
    return torch.full((*lead, *shape), value, dtype=dtype, device=init_device(device))


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
