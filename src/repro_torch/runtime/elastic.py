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

from repro_torch.models.common import lay_out
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


def reshard_state(state, spec_tree, mesh):
    """Lay every leaf onto ``mesh`` with its ``Spec`` (a ``None`` spec
    replicates): ``Shard(dim)`` on each mesh dim a spec entry names,
    ``Replicate()`` on the others.  Returns the tree of DTensors; every
    rank of the mesh calls it with the same state (a restored checkpoint)
    and keeps its own shard.  A leaf that is a DTensor already is
    redistributed.  The same layout as ``jit_train_step``'s
    (``models.common.lay_out``)."""
    return lay_out(state, spec_tree, mesh)
