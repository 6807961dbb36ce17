"""repro_torch.serve — the model server (``ServeEngine``), and the sortd
service and its fleet over the port's ``SortEngine`` (DESIGN.md §8, §10).

The port's copy of ``repro.serve``.
"""

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fleet import ChaosConfig, FleetConfig, FleetDown, SortdFleet
from repro_torch.serve.sortd import QueueFull, Sortd, SortdConfig, WorkerKilled, affinity_key

__all__ = [
    "ServeEngine",
    "Request",
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
