"""Production meshes, as shapes: the port's copy of ``repro.launch.mesh``.

The reference builds its meshes from fake XLA host devices; the port's
counterpart is a ``MeshSpec``, the mesh's shape and axis names alone.  No
process group is made: the dry-run (``repro_torch.launch.dryrun``)
divides shapes by a mesh's axes and traces one device's share.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A device mesh's shape and axis names (major to minor)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """(16,16)=256 devices single pod; (2,16,16)=512 devices across 2 pods.

    The ``pod`` axis is the OTIS "optical" tier of the paper's topology.
    """
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def make_smoke_mesh(devices=None) -> MeshSpec:
    """A 1-D ``data`` mesh over ``devices`` (a count or a list; default the
    visible cards, or the host alone where there is none)."""
    if devices is None:
        n = max(torch.cuda.device_count(), 1)
    else:
        n = devices if isinstance(devices, int) else len(devices)
    return MeshSpec((n,), ("data",))
