"""Shared model utilities: init, sharding rules, the layer loop.

The port's copy of ``repro.models.common``.  ``AxisRules.spec`` gives
the reference's ``PartitionSpec`` as a ``Spec`` (a tuple of mesh-axis
entries), which the dry-run (``repro_torch.launch``) sanitizes and
divides shapes by.  Layer
parameters keep the reference's stacked leading-L layout, and are built
stacked (``dense_init(..., lead=(L,))``) so that no per-layer copies are
ever held beside the stack; the reference's ``maybe_scan`` is a Python
loop over that leading axis (``unstack`` for the parameters, ``layer``
for one entry of a stacked cache).

Inside ``shapes_only()`` every ``dense_init`` and ``const_init`` makes a
meta tensor and draws nothing: the port's ``jax.eval_shape`` of an init.

The mesh (the reference's ``compat.set_mesh`` and GSPMD, on DTensor):
``set_mesh`` makes a ``DeviceMesh`` ambient (one process a device, see
``repro_torch.runtime.ranks``).  Under it, with ``rules.enabled``, the
model's activations and parameters are DTensors: ``shard`` redistributes
one to ``rules.spec(*axes)`` (``with_sharding_constraint``), and
``region`` runs a body on each rank's local shards between stated
placements (``shard_map``, through ``local_map``).  Each op's placements
are stated by its caller; nothing is left to DTensor's own propagation,
whose search took more than 25 s for one einsum of a weight sharded on
two dims of a (2, 2, 2) mesh (torch 2.13, CPU).
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


# ----------------------------------------------------------------- the mesh
_MESH = [None]  # process-wide: autograd's device threads recompute remat bodies


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh within the block:
    the reference's ``compat.set_mesh``."""
    before = _MESH[0]
    _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = before


def get_ambient_mesh():
    """The mesh installed by :func:`set_mesh`, or ``None`` outside one."""
    return _MESH[0]


def mesh_for(rules: AxisRules):
    """The ambient mesh when ``rules`` shard under it, else ``None``."""
    return _MESH[0] if rules.enabled else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage), or the tensor itself."""
    return x.to_local() if is_dtensor(x) else x


def placements(spec, mesh) -> list:
    """A ``Spec`` as DTensor placements on ``mesh``: ``Shard(dim)`` on every
    mesh dim that the spec's entry for ``dim`` names, ``Replicate()`` on the
    others.  A dim split over several mesh dims takes them major to minor,
    as ``PartitionSpec`` does, so their order must be the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for dim, entry in enumerate(spec or ()):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def fit_spec(spec, shape, mesh) -> Spec:
    """``spec`` with the mesh axes that do not divide their dim dropped
    (the reference's ``sanitize_specs`` for one tensor)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, entries):
        axes = spec_axes(e)
        out.append(e if axes and d % math.prod(sizes[a] for a in axes) == 0 else None)
    return Spec(*out)


def shard(x: torch.Tensor, rules: AxisRules, *axes) -> torch.Tensor:
    """The reference's sharding constraint: under an ambient mesh with
    ``rules.enabled``, ``x`` (a DTensor) redistributed to
    ``rules.spec(*axes)``; the identity otherwise.  A plain tensor under
    such a mesh raises: it would run unsharded in silence."""
    mesh = mesh_for(rules)
    if mesh is None:
        return x
    if not is_dtensor(x):
        raise TypeError(
            f"shard{axes}: a plain tensor {tuple(x.shape)} under a mesh; distribute it first "
            "(jit_train_step distributes the state and the batch by their specs)"
        )
    return x.redistribute(mesh, placements(fit_spec(rules.spec(*axes), x.shape, mesh), mesh))


def axes_of(x, mesh) -> Spec:
    """The ``Spec`` of a DTensor's Shard placements (mesh axis names a dim)."""
    from torch.distributed.tensor import Shard

    entries = [[] for _ in range(x.dim())]
    for name, p in zip(mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
    return Spec(*entries)


def tp_spec(w, rules: AxisRules, mesh) -> Spec:
    """A weight's ``Spec`` with only its tensor-axis entry kept: the
    placement a region computes it in, gathered over FSDP and replicated
    over the batch axes (the reference's weights inside a GSPMD matmul)."""
    return Spec(*(rules.tensor if rules.tensor in spec_axes(e) else None for e in axes_of(w, mesh)))


def on_tensor_axis(w, rules: AxisRules, mesh) -> bool:
    """Whether the weight ``w`` is split over the tensor axis."""
    return any(e is not None for e in tp_spec(w, rules, mesh))


def region(fn, args, in_specs, out_specs, *, partial=(), mesh=None):
    """``fn(*local args)`` on every rank's local shards: the reference's
    ``shard_map`` through ``local_map``.

    ``in_specs`` gives a ``Spec`` for each DTensor argument (the argument
    is redistributed to it first) and ``None`` for any other, which passes
    as it is.  ``out_specs`` gives each output's ``Spec``; an output is
    moreover a partial sum over the mesh axes ``partial`` (a tuple of axis
    names for every output, or a list of such tuples, one an output).  On a mesh dim
    where every output is replicated, a replicated argument's gradient is
    replicated; where the outputs are split or partial, it is a partial
    sum (each rank computed its share of it), as the transpose of
    ``shard_map`` sums the cotangents of an unmentioned axis.  A region
    whose outputs disagree on a dim would need both, and raises while
    autograd records (without it, as in prefill, no gradient is made).
    Every gradient leaves the region reduced into its argument's layout,
    in the argument's dtype (``_ReduceGrad``).  A DTensor argument already
    laid out as its spec reaches ``fn`` as its own local shard, so ``fn``
    may write it in place (a cache entry)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = mesh or _MESH[0]
    names = mesh.mesh_dim_names
    outs = [placements(s, mesh) for s in out_specs]
    partial = partial if isinstance(partial, list) else [partial] * len(outs)
    for o, axes in zip(outs, partial):
        for i, name in enumerate(names):
            if name in axes:
                o[i] = Partial()
    split = []
    for i in range(mesh.ndim):
        kinds = {o[i].is_replicate() for o in outs}
        if len(kinds) > 1 and torch.is_grad_enabled():
            raise ValueError(f"region outputs disagree on mesh dim {names[i]!r}: some replicated, some not")
        split.append(False in kinds)
    ins, grads = [], []
    for spec in in_specs:
        if spec is None:
            ins.append(None)
            grads.append(None)
            continue
        pl = placements(spec, mesh)
        ins.append(tuple(pl))
        grads.append(tuple(Partial() if p.is_replicate() and split[i] else p for i, p in enumerate(pl)))
    args = [_enter(a, pl, mesh) if pl is not None and is_dtensor(a) else a for a, pl in zip(args, ins)]
    fn_local = local_map(
        fn,
        out_placements=tuple(outs) if len(outs) > 1 else outs[0],  # a list is one output's placements
        in_placements=tuple(ins),
        in_grad_placements=tuple(grads),
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    return fn_local(*args)


class _ReduceGrad(torch.autograd.Function):
    """The identity on a DTensor whose backward reduces a partial-sum
    gradient into ``placements`` (the argument's layout before the region
    gathered it) right there: in float32 for a narrow dtype, and before a
    cast's backward rounds the partial sums one by one (a bf16 parameter
    cast to float32 for a region: its gradient summed over the ranks in
    float32 and rounded once, as the reference's)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g, None
        if g.dtype.itemsize < 4:  # partial sums of a narrow dtype are added in float32
            return g.to(torch.float32).redistribute(ctx.mesh, ctx.placements).to(g.dtype), None
        return g.redistribute(ctx.mesh, ctx.placements), None


def relaid(x, pl, mesh):
    """The DTensor ``x`` redistributed to the placements ``pl``, or ``x``
    itself where it lies so already."""
    return x if tuple(x.placements) == tuple(pl) else x.redistribute(mesh, pl)


def _enter(x, pl, mesh):
    """A region's argument laid out as ``pl``; its gradient comes back
    reduced into ``x``'s own layout (``_ReduceGrad``)."""
    before = tuple(x.placements)
    x = relaid(x, pl, mesh)
    return _ReduceGrad.apply(x, before) if x.requires_grad else x


def tp_region(body, x, weights, rules: AxisRules, mesh, extra=(), inputs=(), whole=False):
    """``body(x, *weights, *inputs)`` for a column- then row-parallel block
    (the MLP, attention, cross-attention, the shared experts): ``x`` as it
    lies, each weight gathered over FSDP with its tensor-axis split kept
    (MLA's latent projections have none), each of ``inputs`` (a
    ``(tensor, Spec)`` pair: M-RoPE's positions, the encoder output) laid
    out as its ``Spec``.  The output is laid out as ``x`` and is a
    partial sum over the tensor axis when any weight is split there;
    ``extra`` gives the ``Spec`` of each further output (K and V, or the
    latent, for prefill's cache), none a partial sum.

    The weights are taken whole, and each rank computes every head or
    column of its own rows, where ``whole`` is set (attention under
    ``heads=None``: the heads and the KV heads may not split alike) or
    where the tensor axis already splits ``x`` (sequence parallelism: one
    mesh axis cannot split both the rows and the weights).

    Callers cast the weights to the dtype the body computes in before the
    region, as the reference casts before its matmul: the gradients' sums
    over the ranks are then taken in that dtype and rounded to the
    parameter's once (a bf16 parameter in a float32 model)."""
    spec = axes_of(x, mesh)
    whole = whole or rules.tensor in spec_axes(spec)
    wspecs = [Spec() if whole else tp_spec(w, rules, mesh) for w in weights]
    split = any(e is not None for s in wspecs for e in s)
    args = (x, *weights, *(t for t, _ in inputs))
    specs = (spec, *wspecs, *(s for _, s in inputs))
    return region(body, args, specs, (spec, *extra), partial=[(rules.tensor,) if split else (), *[()] * len(extra)],
                  mesh=mesh)


def spec_axes(spec) -> tuple[str, ...]:
    """Every mesh axis a ``Spec`` (or one entry of it) names, in order."""
    entries = (spec,) if isinstance(spec, str) or spec is None else spec
    return tuple(a for e in entries for a in ((e,) if isinstance(e, str) else (e or ())))


def heads_whole(rules: AxisRules) -> bool:
    """Whether attention takes its weights whole: ``heads=None`` (the
    reference's ``rules_for`` where the heads or the KV heads do not divide
    the tensor axis), so no rank keeps a share of the heads."""
    return rules.spec("heads")[0] is None


def seq_split(x, mesh):
    """(the mesh axes that split the DTensor ``x``'s sequence dim (1), this
    rank's position along them, their process group): ``((), 0, None)``
    where the dim is whole.  A region's body under sequence parallelism
    starts its chunk at that position times its local length."""
    from repro_torch.runtime.ranks import axis_group, shard_index

    axes = spec_axes(axes_of(x, mesh)[1])
    if not axes:
        return (), 0, None
    return axes, shard_index(mesh, axes), axis_group(mesh, axes)


def replicated(x, mesh=None):
    """``x`` (a DTensor) replicated on every mesh dim: the explicit gather
    before an op that needs the whole tensor (a data-dependent index, a
    reduction over a sharded dim)."""
    from torch.distributed.tensor import Replicate

    mesh = mesh or _MESH[0]
    return x.redistribute(mesh, [Replicate()] * mesh.ndim)


def distribute(x: torch.Tensor, spec, mesh):
    """A plain tensor that every rank holds alike, as a DTensor laid out by
    ``spec`` on ``mesh``: each rank keeps its own shard and nothing is
    sent.  A shard is a copy, so ``x`` can be freed; a replicated leaf is
    ``x`` itself (the step takes its state over, as the reference's
    donated buffers).  A dim its mesh axes do not divide evenly goes
    through ``distribute_tensor`` (rank 0's data is sent)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.runtime.ranks import mesh_device

    pl = placements(spec, mesh)
    x = x.to(mesh_device(mesh))
    part = x
    for i, p in enumerate(pl):
        n = mesh.mesh.shape[i]
        if p.is_shard() and n > 1:
            if part.shape[p.dim] % n:
                return distribute_tensor(x, mesh, pl)
            part = part.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    part = part.contiguous() if part is x else part.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(part, mesh, pl, run_check=False)


def lay_out(tree, specs, mesh):
    """``tree`` laid out on ``mesh`` by the ``Spec`` tree ``specs`` (a
    ``None`` spec replicates): a plain leaf, the same on every rank, is cut
    to this rank's shard (``distribute``); a DTensor is redistributed where
    its placements differ."""

    def put(x, spec):
        return relaid(x, placements(spec, mesh), mesh) if is_dtensor(x) else distribute(x, spec, mesh)

    if specs is None or isinstance(specs, Spec):
        return put(tree, specs)
    if isinstance(specs, dict):
        return {k: lay_out(tree[k], v, mesh) for k, v in specs.items()}
    return type(specs)(lay_out(t, s, mesh) for t, s in zip(tree, specs))


def mesh_zeros(mesh, dtype=torch.float32):
    """A replicated 0-d zero on ``mesh`` (an accumulator that meets DTensors)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.runtime.ranks import mesh_device

    z = torch.zeros((), dtype=dtype, device=mesh_device(mesh))
    return DTensor.from_local(z, mesh, [Replicate()] * mesh.ndim, run_check=False)


def batch_shards(rules: AxisRules, mesh) -> int:
    """Into how many pieces the batch axes cut the batch."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return math.prod(sizes[a] for a in (rules.batch or ()))


def local_rules(rules: AxisRules) -> AxisRules:
    """The rules a region's body runs under: its placements already hold
    the reference's constraints, so ``shard`` is the identity there."""
    return dataclasses.replace(rules, enabled=False)


# ------------------------------------------------- collectives inside a region
# A region's body runs on plain local tensors; these join a mesh axis's
# group there, with gradients (the reference's psum, all_gather and
# psum_scatter inside shard_map).  They go through the c10d calls of
# ``runtime.ranks``, which gloo carries for CUDA tensors too.
class _SumOver(torch.autograd.Function):
    """The group's sum on every rank; the gradient is summed likewise
    (each rank's sum feeds its own further computation)."""

    @staticmethod
    def forward(ctx, x, group):
        from repro_torch.runtime import ranks

        ctx.group = group
        return ranks.all_reduce(x.clone(), torch.distributed.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime import ranks

        return ranks.all_reduce(g.clone(), torch.distributed.ReduceOp.SUM, ctx.group), None


class _GatherDim(torch.autograd.Function):
    """The group's shards concatenated along ``dim`` in rank order; the
    gradient is summed over the group and each rank keeps its own block."""

    @staticmethod
    def forward(ctx, x, dim, group):
        from repro_torch.runtime.ranks import gather_along

        ctx.dim, ctx.group = dim, group
        return gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


class _ScatterSumDim(torch.autograd.Function):
    """The group's sum, each rank keeping its block of ``dim``; the
    gradient is gathered along ``dim``."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime.ranks import gather_along

        return gather_along(g, ctx.dim, ctx.group), None, None


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    from repro_torch.runtime import ranks

    xm = x.movedim(dim, 0)
    out = xm.new_empty((xm.shape[0] // torch.distributed.get_world_size(group), *xm.shape[1:]))
    return ranks.reduce_scatter(out, xm, group).movedim(0, dim)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (an all-reduce), inside a region's body."""
    return _SumOver.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s shards along ``dim`` all-gathered over ``group``, inside a
    region's body: the sequence's entry into a region under SP."""
    return _GatherDim.apply(x, dim, group)


def scatter_sum_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x``'s partial sums over ``group`` reduce-scattered along ``dim``,
    inside a region's body: the sequence's exit from a region under SP."""
    return _ScatterSumDim.apply(x, dim, group)


def gather_seq(x: torch.Tensor, rules: AxisRules) -> torch.Tensor:
    """K or V (B, S, heads, dim) all-gathered over the sequence's shards
    before attention in a per-device trace under SP (``seq_shards`` > 1):
    the slice repeated to the whole sequence's length, which the trace
    counts as the gathered tensor.  The identity otherwise: a real run
    under SP gathers inside the attention region (``gather_dim``)."""
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
    """Layer ``i`` of a stacked tree: views, so writes reach the stack.  A
    DTensor leaf (a cache laid out on a mesh, its leading axis never
    split) gives the DTensor of its local shard's entry ``i``: nothing is
    gathered, and a write into that entry's shard reaches the stack's."""
    return tree_map(lambda a: _entry(a, i) if is_dtensor(a) else a[i], tree)


def _entry(x, i: int):
    from torch.distributed.tensor import Shard

    if any(p.is_shard(0) for p in x.placements):
        raise ValueError(f"layer(): the stacked axis of a {tuple(x.shape)} DTensor is split ({x.placements})")
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in x.placements]
    return as_dtensor(x.to_local()[i], x, pl, x.shape[1:])


def as_dtensor(local_t: torch.Tensor, like, pl=None, shape=None):
    """``local_t`` as the local shard of a DTensor on ``like``'s mesh, laid
    out as ``pl`` (default ``like``'s placements) with the global
    ``shape`` (default ``like``'s): a view of ``local_t``, nothing sent."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(like.shape if shape is None else shape)
    stride = tuple(math.prod(shape[d + 1 :]) for d in range(len(shape)))
    return DTensor.from_local(local_t, like.device_mesh, like.placements if pl is None else pl, run_check=False,
                              shape=shape, stride=stride)


def clone(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x``; of a DTensor, its local shard copied, laid out alike."""
    return as_dtensor(local(x).clone(), x) if is_dtensor(x) else torch.clone(x)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered to the plain tensor every rank holds alike (the
    reference's unsharded result for its caller); a tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def last_position(x: torch.Tensor) -> torch.Tensor:
    """``x[:, -1:]``; of a DTensor, taken on its local shard after the
    sequence dim (1), where it is split (SP), is gathered."""
    if not is_dtensor(x):
        return x[:, -1:]
    from torch.distributed.tensor import Replicate

    x = relaid(x, [Replicate() if p.is_shard(1) else p for p in x.placements], x.device_mesh)
    return as_dtensor(local(x)[:, -1:], x, shape=(x.shape[0], 1, *x.shape[2:]))


# --------------------------------------------------- a cache split over kv_seq
def seq_shard(x) -> tuple[tuple[str, ...], int, int]:
    """(the mesh axes that split ``x``'s sequence dim (1), this rank's first
    position, the whole length) of a cache leaf (B, S, ...): no axes, 0
    and S for a plain tensor or a dim not split (``AxisRules.kv_seq``)."""
    if not is_dtensor(x):
        return (), 0, x.shape[1]
    from repro_torch.runtime.ranks import shard_index

    axes = spec_axes(axes_of(x, x.device_mesh)[1])
    return axes, shard_index(x.device_mesh, axes) * local(x).shape[1], x.shape[1]


def put_owned(dst: torch.Tensor, src: torch.Tensor, start: int, lo: int, total: int) -> None:
    """``put`` of ``src`` at ``start`` into a sequence of ``total``
    positions of which the local ``dst`` holds ``lo`` onwards: the start
    clamped as ``put`` clamps it, and only the positions this shard owns
    written."""
    n = src.shape[1]
    start = min(max(start, 0), total - n)
    a, b = max(start, lo), min(start + n, lo + dst.shape[1])
    if a < b:
        dst.narrow(1, a - lo, b - a).copy_(src.narrow(1, a - start, b - a).to(dst.dtype))


def lse_combine(out: torch.Tensor, lse: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Attention over a sequence split over the mesh ``axes``, from each
    shard's ``(out (B, Sq, H, hd), lse (B, Sq, H))`` of its own keys
    (``attention_with_lse``): ``Σ exp(lse_i − lse*)·out_i / Σ exp(lse_i −
    lse*)``, in float32.  One all-gather of the shards' (out, lse) over
    the axes' group; every rank combines them in shard order, so the
    group holds the same bits.  A shard with no valid key has ``lse``
    near −1e30 and weighs nothing."""
    from repro_torch.runtime.ranks import axis_group, gather_along

    part = torch.cat([out.to(torch.float32), lse.to(torch.float32)[..., None]], -1)
    n = math.prod(mesh.mesh.shape[mesh.mesh_dim_names.index(a)] for a in axes)
    parts = gather_along(part[None], 0, axis_group(mesh, axes)).view(n, *part.shape)
    o, l = parts[..., :-1], parts[..., -1]
    w = torch.exp(l - l.amax(0))
    return (o * w[..., None]).sum(0) / w.sum(0)[..., None]


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, from one ``torch.unbind`` of
    each leaf.  Under autograd the backward of ``unbind`` is one ``stack``
    a leaf, where ``layer``'s ``a[i]`` would write a zero tensor the size
    of the whole stack for every layer."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[i] for p in parts]) for i in range(n)]
