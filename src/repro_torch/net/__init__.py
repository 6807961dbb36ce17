"""repro_torch.net — event-driven OHHC link simulator (DESIGN.md §6), the
port's copy of ``repro.net`` (pure Python; it imports only the port).

Moves the schedule's messages over the actual electrical/optical link
graph: BFS routing, per-link occupancy and contention, fault injection
with reroute-or-fail semantics, and trace-validated Theorem-3/6 round
accounting.
"""

from repro_torch.net.faults import FaultScenario, GatherImpossible, rebuild_degraded
from repro_torch.net.links import ELECTRICAL, OPTICAL, LinkClass, LinkModel
from repro_torch.net.report import case_report, netsim_report, to_markdown, write_json
from repro_torch.net.router import RouteError, Router
from repro_torch.net.sim import (
    MessageTrace,
    PhaseSpan,
    SimResult,
    critical_hop_count,
    simulate_gather,
    simulate_schedule,
)

__all__ = [
    "ELECTRICAL",
    "OPTICAL",
    "FaultScenario",
    "GatherImpossible",
    "LinkClass",
    "LinkModel",
    "MessageTrace",
    "PhaseSpan",
    "RouteError",
    "Router",
    "SimResult",
    "case_report",
    "critical_hop_count",
    "netsim_report",
    "rebuild_degraded",
    "simulate_gather",
    "simulate_schedule",
    "to_markdown",
    "write_json",
]
