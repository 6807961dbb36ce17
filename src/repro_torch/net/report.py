"""Simulated-vs-analytic validation reports for the OHHC netsim.

For every requested (d_h, variant) this module runs the gather three ways
and cross-checks them (DESIGN.md §6 validation methodology):

1. **unit model, barrier mode** — every hop costs one unit and rounds are
   BSP barriers (the paper's accounting): the measured makespan must equal
   the schedule's critical-path round count ``2·d_h + 3`` exactly;
2. **unit model, dependency mode** — nodes forward as soon as their wait
   count is met: full-variant makespan still ``2·d_h + 3`` rounds; the
   **half** variant finishes in ``2·d_h + 2`` — one round of slack, a
   reproduction finding (its optical-hole nodes ``local ≥ G`` receive no
   optical payload, so the first D-round never waits for Phase C);
3. **default byte model** — measured makespan vs the analytic
   store-and-forward sum ``model_comm_time_s(..., roundtrip=False)``:
   exact in barrier mode, ≤ analytic in dependency mode;
4. **one optical fault** — ``FaultScenario.optical_link_down(g)``: the
   gather must still complete (every chunk reaches the master) with a
   reported slowdown and reroute/contention counters.

Output is a plain dict (JSON-safe), with ``to_markdown`` for humans and
``write_json`` for the CI artifact.

The port's copy of ``repro.net.report``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import json
import math
import pathlib

from repro_torch.core.ohhc_sort import model_comm_time_s
from repro_torch.core.schedule import AccumulationSchedule
from repro_torch.core.topology import OHHCTopology

from repro_torch.net.faults import FaultScenario
from repro_torch.net.links import LinkModel
from repro_torch.net.router import Router
from repro_torch.net.sim import critical_hop_count, simulate_schedule

UNIT_US = 1.0


def _json_safe(d: dict) -> dict:
    """Strict-JSON view: non-finite floats (inf bandwidth) become strings."""
    return {
        k: (v if not isinstance(v, float) or math.isfinite(v) else str(v))
        for k, v in d.items()
    }


def case_report(
    d_h: int,
    variant: str,
    *,
    link_model: LinkModel | None = None,
    chunk_elems: int = 1024,
    itemsize: int = 4,
    fault_group: int = 1,
) -> dict:
    """One (d_h, variant) validation row; see module docstring for the axes."""
    link_model = link_model if link_model is not None else LinkModel()
    topo = OHHCTopology(d_h, variant)
    sched = AccumulationSchedule.build(topo)
    router = Router(topo)

    diam = router.verify_diameter()
    unit_lm = LinkModel.unit(UNIT_US)
    unit_barrier = simulate_schedule(
        sched, topo, link_model=unit_lm, router=router,
        chunk_sizes=chunk_elems, itemsize=itemsize, barrier=True,
    )
    unit_dep = simulate_schedule(
        sched, topo, link_model=unit_lm, router=router,
        chunk_sizes=chunk_elems, itemsize=itemsize,
    )
    barrier_rounds = critical_hop_count(unit_barrier, UNIT_US * 1e-6)
    dep_rounds = critical_hop_count(unit_dep, UNIT_US * 1e-6)

    healthy = simulate_schedule(
        sched, topo, link_model=link_model, router=router,
        chunk_sizes=chunk_elems, itemsize=itemsize, barrier=True,
    )
    analytic_s = model_comm_time_s(
        sched,
        [chunk_elems] * topo.total_procs,
        link_model.to_core(),
        itemsize=itemsize,
        roundtrip=False,
    )
    delta = (
        abs(healthy.total_time_s - analytic_s) / analytic_s
        if analytic_s > 0
        else 0.0
    )

    # Map into 1..G-1: group 0 has no OTIS uplink, so a modulo that lands
    # on 0 would silently simulate the healthy network as the "fault".
    scenario = FaultScenario.optical_link_down(
        1 + (fault_group - 1) % (topo.num_groups - 1)
    )
    faulted = simulate_schedule(
        sched, topo, link_model=link_model, router=scenario.router(topo),
        chunk_sizes=chunk_elems, itemsize=itemsize, barrier=True,
    )
    return {
        "d_h": d_h,
        "variant": variant,
        "total_procs": topo.total_procs,
        "diameter_measured": diam["measured"],
        "diameter_expected": diam["expected"],
        "eccentricity_radius": diam["radius"],
        "critical_rounds_schedule": sched.critical_path_rounds(),
        "critical_rounds_simulated": barrier_rounds,
        "dependency_rounds": dep_rounds,
        "dependency_slack_rounds": barrier_rounds - dep_rounds,
        "paper_step_count": sched.paper_step_count(),
        "tree_sends": sched.tree_send_count(),
        "sim_time_us": healthy.total_time_s * 1e6,
        "analytic_time_us": analytic_s * 1e6,
        "sim_vs_analytic_delta": delta,
        "contention_events": healthy.contention_events,
        "link_utilization": healthy.link_utilization,
        "master_elems": healthy.master_elems,
        "fault": {
            "scenario": scenario.name,
            "completed": faulted.master_elems == healthy.master_elems,
            "sim_time_us": faulted.total_time_s * 1e6,
            "slowdown": (
                faulted.total_time_s / healthy.total_time_s
                if healthy.total_time_s > 0
                else 1.0
            ),
            "rerouted_messages": faulted.rerouted_messages,
            "contention_events": faulted.contention_events,
        },
    }


def netsim_report(
    dims=(1, 2, 3),
    variants=("full", "half"),
    *,
    link_model: LinkModel | None = None,
    chunk_elems: int = 1024,
    itemsize: int = 4,
    fault_group: int = 1,
) -> dict:
    link_model = link_model if link_model is not None else LinkModel()
    cases = [
        case_report(
            d_h,
            variant,
            link_model=link_model,
            chunk_elems=chunk_elems,
            itemsize=itemsize,
            fault_group=fault_group,
        )
        for variant in variants
        for d_h in dims
    ]
    return {
        "chunk_elems": chunk_elems,
        "itemsize": itemsize,
        "link_model": {
            "electrical": _json_safe(vars(link_model.electrical)),
            "optical": _json_safe(vars(link_model.optical)),
        },
        "all_rounds_validated": all(
            c["critical_rounds_simulated"] == c["critical_rounds_schedule"]
            for c in cases
        ),
        "all_diameters_validated": all(
            c["diameter_measured"] == c["diameter_expected"] for c in cases
        ),
        "all_faults_completed": all(c["fault"]["completed"] for c in cases),
        "cases": cases,
    }


def to_markdown(report: dict) -> str:
    lines = [
        "# netsim — simulated vs analytic gather validation",
        "",
        f"chunk = {report['chunk_elems']} × {report['itemsize']} B, "
        f"rounds validated: {report['all_rounds_validated']}, "
        f"diameters validated: {report['all_diameters_validated']}, "
        f"faults completed: {report['all_faults_completed']}",
        "",
        "| d_h | variant | P | diam (meas/exp) | rounds (sim/sched) | "
        "sim µs | analytic µs | Δ | fault slowdown | reroutes |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in report["cases"]:
        lines.append(
            f"| {c['d_h']} | {c['variant']} | {c['total_procs']} "
            f"| {c['diameter_measured']}/{c['diameter_expected']} "
            f"| {c['critical_rounds_simulated']}/{c['critical_rounds_schedule']} "
            f"| {c['sim_time_us']:.1f} | {c['analytic_time_us']:.1f} "
            f"| {c['sim_vs_analytic_delta']:.2%} "
            f"| {c['fault']['slowdown']:.2f}x "
            f"| {c['fault']['rerouted_messages']} |"
        )
    return "\n".join(lines) + "\n"


def write_json(report: dict, path: "str | pathlib.Path") -> pathlib.Path:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(report, indent=2, sort_keys=True))
    return p
