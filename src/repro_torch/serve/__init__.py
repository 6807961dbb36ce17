"""repro_torch.serve — the sortd service and its fleet over the port's
``SortEngine`` (DESIGN.md §8, §10).

The port's copy of ``repro.serve`` without ``ServeEngine``/``Request``,
which wait for the model layer.
"""

from repro_torch.serve.fleet import ChaosConfig, FleetConfig, FleetDown, SortdFleet
from repro_torch.serve.sortd import QueueFull, Sortd, SortdConfig, WorkerKilled, affinity_key

__all__ = [
    "Sortd",
    "SortdConfig",
    "QueueFull",
    "WorkerKilled",
    "affinity_key",
    "SortdFleet",
    "FleetConfig",
    "ChaosConfig",
    "FleetDown",
]
