"""repro_torch.serve.fleet — multi-worker sortd serving (DESIGN.md §10).

N :class:`~repro_torch.serve.sortd.Sortd` workers behind one admission layer:
(dtype, bucket)-affinity routing with watermark work stealing, heartbeat
health checking with drain-and-readmit failover, deterministic chaos
injection, and fleet-wide observability.  Load generation lives in
:mod:`repro_torch.serve.fleet.loadgen` (bench/test-facing, not exported here).
"""

from repro_torch.serve.fleet.fleet import (
    ChaosConfig,
    FleetConfig,
    FleetDown,
    SortdFleet,
    write_json,
)
from repro_torch.serve.fleet.health import HealthMonitor, WorkerState
from repro_torch.serve.fleet.routing import AffinityRouter, RouteDecision, rendezvous_worker

__all__ = [
    "SortdFleet",
    "FleetConfig",
    "ChaosConfig",
    "FleetDown",
    "AffinityRouter",
    "RouteDecision",
    "rendezvous_worker",
    "HealthMonitor",
    "WorkerState",
    "write_json",
]
