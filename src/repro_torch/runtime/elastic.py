"""Elastic scaling: rebuild the mesh after a pod loss, reshard the state.

The port's copy of ``repro.runtime.elastic``.  Checkpoints store
*logical* arrays (``repro_torch.ckpt``), so any surviving population of
ranks that can still hold the model restores and continues.
``elastic_mesh`` picks the largest (pods', data, model) grid that fits the
live ranks; ``reshard_state`` distributes a restored state tree onto it
with the same ``Spec`` tree (specs are logical: they survive mesh size
changes as long as axis names remain), as DTensors.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.models.common import Spec
from repro_torch.runtime import ranks


def elastic_mesh(target_shape: tuple[int, ...], axis_names: tuple[str, ...], devices=None, *, device_type="cuda"):
    """Largest mesh of ``axis_names`` that fits the live ranks ``devices``
    (default every rank of the world), shrinking the FIRST axis (pods)
    first — losing a pod shrinks the pod axis, never the intra-pod
    topology.  Every rank of the world calls it; ``device_type`` is
    ``"cuda"`` or ``"cpu"``."""
    devices = list(devices if devices is not None else range(dist.get_world_size()))
    shape = list(target_shape)
    while math.prod(shape) > len(devices) and shape[0] > 1:
        shape[0] -= 1
    if math.prod(shape) > len(devices):
        raise ValueError(
            f"cannot fit mesh {target_shape} (even at pod=1) on {len(devices)} devices"
        )
    return ranks.make_mesh(shape, axis_names, device_type, ranks=devices)


def _placements(spec, mesh):
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for dim, entry in enumerate(spec or ()):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            # DTensor shards one dim over several mesh dims major to minor
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in idx:
            placements[i] = Shard(dim)
    return placements


def reshard_state(state, spec_tree, mesh):
    """Distribute every leaf onto ``mesh`` with its ``Spec`` (a ``None``
    spec replicates): ``Shard(dim)`` on each mesh dim a spec entry names,
    ``Replicate()`` on the others.  Returns the tree of DTensors; every
    rank of the mesh calls it with the same state (rank 0's data is sent)."""
    from torch.distributed.tensor import distribute_tensor

    def put(x, spec):
        return distribute_tensor(x.to(ranks.mesh_device(mesh)), mesh, _placements(spec, mesh))

    def walk(tree, specs):
        if specs is None or isinstance(specs, Spec):
            return put(tree, specs)
        if isinstance(specs, dict):
            return {k: walk(tree[k], v) for k, v in specs.items()}
        return type(specs)(walk(t, s) for t, s in zip(tree, specs))

    return walk(state, spec_tree)
