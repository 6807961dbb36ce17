"""Event-driven execution of a gather schedule over the OHHC link graph.

This is the measured-timeline counterpart of the analytic models in
``repro_torch.core.ohhc_sort`` (DESIGN.md §6).  The input is any list of rounds
of :class:`repro_torch.core.schedule.Send` — ``AccumulationSchedule.rounds``
plugs in unchanged, as do the degraded schedules from ``repro_torch.net.faults``
— and the output is a :class:`SimResult` timeline with per-phase spans,
per-link-class utilization, and contention counters.

Semantics (deliberately *not* a per-round barrier):

* a message becomes ready when its **source node** has received every
  earlier-round message addressed to it (the paper's static
  WaitForSubArrays discipline — a node forwards once its wait count is
  met; messages to *other* nodes never gate it);
* each message carries the chunks its source has accumulated so far
  (element counts tracked exactly as ``simulate_chunk_counts``), and is
  **store-and-forward**: a route of h hops pays the full per-hop cost h
  times;
* each undirected link serves **one message at a time per direction**;
  a busy link queues the message and the wait is counted as contention
  (zero on the healthy schedule, whose rounds use disjoint links —
  nonzero exactly when faults force reroutes onto shared links).

Under ``LinkModel.unit()`` every hop costs one time unit, so
``total_time_s / unit`` equals the schedule's critical-path hop count —
the measured-timeline validation of Theorem 3 / Theorem 6 accounting that
``tests/test_netsim.py`` pins for every (d_h, variant).  ``barrier=True``
switches to the paper's BSP accounting (no round starts before the
previous round fully drains); the dependency default exposes a
reproduction finding: the **half** variant finishes in ``2·d_h + 2``
rounds, one under the paper's ``2·d_h + 3``, because its optical-hole
nodes (``local ≥ G``) receive no optical payload and forward early.

The port's copy of ``repro.net.sim``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

from repro_torch.core.schedule import AccumulationSchedule, Send
from repro_torch.core.topology import OHHCTopology

from repro_torch.net.links import ELECTRICAL, OPTICAL, LinkModel
from repro_torch.net.router import RouteError, Router, canonical_link

_EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class MessageTrace:
    """One delivered point-to-point message (possibly multi-hop)."""

    send: Send
    elems: int  # elements carried (accumulated chunks)
    nbytes: int
    start_s: float  # source became ready to transmit
    end_s: float  # last hop arrived at the destination
    hops: int
    wait_s: float  # total time spent queued on busy links
    rerouted: bool  # direct link dead → BFS alternative used


@dataclasses.dataclass(frozen=True)
class PhaseSpan:
    phase: str
    start_s: float
    end_s: float
    sends: int
    hops: int
    electrical_bytes: int
    optical_bytes: int
    contention_events: int


@dataclasses.dataclass(frozen=True)
class SimResult:
    total_time_s: float
    messages: int
    hops: int
    rerouted_messages: int
    contention_events: int
    contention_wait_s: float
    link_busy_s: dict  # kind -> summed busy seconds
    link_utilization: dict  # kind -> busy / (live links × makespan)
    max_link_busy_s: float  # hottest single directed link
    phases: tuple  # PhaseSpan, in execution order
    master_elems: int  # elements accumulated at the gather root
    traces: tuple  # MessageTrace, schedule (round, send) order

    def phase_by_name(self) -> dict:
        return {p.phase: p for p in self.phases}


def _as_rounds(schedule) -> Sequence[Sequence[Send]]:
    if isinstance(schedule, AccumulationSchedule):
        return schedule.rounds
    return schedule


def simulate_schedule(
    schedule,
    topo: OHHCTopology,
    *,
    link_model: LinkModel | None = None,
    router: Router | None = None,
    chunk_sizes: "Sequence[int] | int" = 1,
    itemsize: int = 4,
    master: tuple[int, int] = (0, 0),
    barrier: bool = False,
) -> SimResult:
    """Run ``schedule`` (rounds of ``Send``) and return the timeline.

    ``chunk_sizes`` is elements per processor (scalar = uniform), matching
    ``payload_bytes_per_round``; ``router`` carries fault state (default:
    healthy graph).  ``barrier=True`` uses per-round BSP barriers (the
    paper's accounting) instead of per-node wait-count dependencies.
    Raises :class:`RouteError` when a send's endpoints are disconnected —
    the "fail" half of reroute-or-fail.
    """
    link_model = link_model if link_model is not None else LinkModel()
    router = router if router is not None else Router(topo)
    rounds = _as_rounds(schedule)

    if isinstance(chunk_sizes, int):
        sizes = [chunk_sizes] * topo.total_procs
    else:
        sizes = list(chunk_sizes)
        if len(sizes) != topo.total_procs:
            raise ValueError(
                f"chunk_sizes has {len(sizes)} entries for {topo.total_procs} procs"
            )

    held = {gid: sizes[gid] for gid in range(topo.total_procs)}
    node_ready = {gid: 0.0 for gid in range(topo.total_procs)}
    link_free: dict[tuple[int, int, int], float] = {}  # (a, b, dir) -> time
    link_busy = {ELECTRICAL: 0.0, OPTICAL: 0.0}
    per_link_busy: dict[tuple[int, int, int], float] = {}

    traces: list[MessageTrace] = []
    phase_acc: dict[str, dict] = {}
    phase_order: list[str] = []
    contention_events = 0
    contention_wait = 0.0
    total_hops = 0
    rerouted_count = 0
    t_barrier = 0.0

    for rnd in rounds:
        # Stage payloads first: all sends in a round observe the counts
        # from previous rounds (same convention as simulate_chunk_counts).
        # Draining at read time keeps element conservation even for
        # schedules where one source appears twice in a round (possible in
        # rebuilt degraded schedules): the second send carries 0, never a
        # double-counted copy.
        staged = []
        for s in rnd:
            src = topo.global_id(*s.src)
            dst = topo.global_id(*s.dst)
            elems = held[src]
            held[src] = 0
            staged.append((s, src, dst, elems))

        # Event loop, chronological: each message advances hop by hop; a
        # hop that finds its link busy re-requests at the link's free time,
        # so links are granted first-come-first-served *in simulated time*
        # (never by processing order — a reservation can't block a message
        # that was ready while the link sat idle).  Ties break by first
        # request time, then message index, so runs are deterministic.
        msgs = []
        heap: list[tuple[float, float, int]] = []  # (event t, request t, idx)
        for i, (s, src, dst, elems) in enumerate(staged):
            start = max(node_ready[src], t_barrier) if barrier else node_ready[src]
            direct = router.link_kind(src, dst)
            if src == dst:
                hops, rerouted = [], False  # self-send: delivered in place
            elif direct is not None:
                hops = [(src, dst, direct)]
                rerouted = False
            else:
                hops = router.shortest_path(src, dst)  # raises RouteError
                rerouted = True
                rerouted_count += 1
            msgs.append(
                {
                    "s": s, "src": src, "dst": dst, "elems": elems,
                    "start": start, "hops": hops, "hop_i": 0, "t": start,
                    "wait": 0.0, "req": None, "rerouted": rerouted,
                }
            )
            heapq.heappush(heap, (start, start, i))
        arrivals = []  # (dst, arrival) applied after the round drains
        while heap:
            now, _, i = heapq.heappop(heap)
            m = msgs[i]
            if m["hop_i"] >= len(m["hops"]):  # zero-hop (src == dst)
                arrivals.append((m["dst"], m["t"]))
                continue
            u, v, kind = m["hops"][m["hop_i"]]
            a, b = canonical_link(u, v)
            key = (a, b, 0 if u == a else 1)
            free = link_free.get(key, 0.0)
            if free > now + _EPS:
                if m["req"] is None:
                    m["req"] = now  # first time this hop found the link busy
                heapq.heappush(heap, (free, m["req"], i))
                continue
            if m["req"] is not None:
                contention_events += 1
                m["wait"] += now - m["req"]
                m["req"] = None
            hop_t = link_model.hop_time_s(kind, m["elems"] * itemsize)
            m["t"] = now + hop_t
            link_free[key] = m["t"]
            link_busy[kind] += hop_t
            per_link_busy[key] = per_link_busy.get(key, 0.0) + hop_t
            m["hop_i"] += 1
            if m["hop_i"] < len(m["hops"]):
                heapq.heappush(heap, (m["t"], m["t"], i))
            else:
                arrivals.append((m["dst"], m["t"]))
        for m in msgs:
            s, elems, hops = m["s"], m["elems"], m["hops"]
            nbytes = elems * itemsize
            # Credit the payload to where the route actually *ends*, not
            # the schedule's declared destination — so master_elems
            # measures delivery (a routing bug misdelivers and the counts
            # drop) rather than restating the schedule's bookkeeping.
            landed = hops[-1][1] if hops else m["dst"]
            held[landed] += elems
            contention_wait += m["wait"]
            total_hops += len(hops)
            traces.append(
                MessageTrace(
                    send=s,
                    elems=elems,
                    nbytes=nbytes,
                    start_s=m["start"],
                    end_s=m["t"],
                    hops=len(hops),
                    wait_s=m["wait"],
                    rerouted=m["rerouted"],
                )
            )
            acc = phase_acc.setdefault(
                s.phase,
                {
                    "start": m["start"],
                    "end": m["t"],
                    "sends": 0,
                    "hops": 0,
                    "e_bytes": 0,
                    "o_bytes": 0,
                    "contention": 0,
                },
            )
            if s.phase not in phase_order:
                phase_order.append(s.phase)
            acc["start"] = min(acc["start"], m["start"])
            acc["end"] = max(acc["end"], m["t"])
            acc["sends"] += 1
            acc["hops"] += len(hops)
            for u, v, kind in hops:
                acc["e_bytes" if kind == ELECTRICAL else "o_bytes"] += nbytes
            if m["wait"] > _EPS:
                acc["contention"] += 1
        # A node may forward in a later round only after everything routed
        # to it in this round has landed.
        for dst, t in arrivals:
            node_ready[dst] = max(node_ready[dst], t)
        if barrier and arrivals:
            t_barrier = max(t_barrier, max(t for _, t in arrivals))

    makespan = max((tr.end_s for tr in traces), default=0.0)
    links_of_kind = {ELECTRICAL: 0, OPTICAL: 0}
    for kind in router.live_links().values():
        links_of_kind[kind] += 1
    utilization = {
        # busy link-seconds / available directed link-seconds of that class
        kind: (
            busy / (2 * links_of_kind[kind] * makespan)
            if makespan > 0 and links_of_kind[kind]
            else 0.0
        )
        for kind, busy in link_busy.items()
    }
    phases = tuple(
        PhaseSpan(
            phase=name,
            start_s=phase_acc[name]["start"],
            end_s=phase_acc[name]["end"],
            sends=phase_acc[name]["sends"],
            hops=phase_acc[name]["hops"],
            electrical_bytes=phase_acc[name]["e_bytes"],
            optical_bytes=phase_acc[name]["o_bytes"],
            contention_events=phase_acc[name]["contention"],
        )
        for name in phase_order
    )
    return SimResult(
        total_time_s=makespan,
        messages=len(traces),
        hops=total_hops,
        rerouted_messages=rerouted_count,
        contention_events=contention_events,
        contention_wait_s=contention_wait,
        link_busy_s=dict(link_busy),
        link_utilization=utilization,
        max_link_busy_s=max(per_link_busy.values(), default=0.0),
        phases=phases,
        master_elems=held[topo.global_id(*master)],
        traces=tuple(traces),
    )


def simulate_gather(
    topo: OHHCTopology,
    *,
    link_model: LinkModel | None = None,
    router: Router | None = None,
    chunk_sizes: "Sequence[int] | int" = 1,
    itemsize: int = 4,
    barrier: bool = False,
) -> SimResult:
    """Build the paper's accumulation schedule for ``topo`` and simulate it."""
    return simulate_schedule(
        AccumulationSchedule.build(topo),
        topo,
        link_model=link_model,
        router=router,
        chunk_sizes=chunk_sizes,
        itemsize=itemsize,
        barrier=barrier,
    )


def critical_hop_count(result: SimResult, unit_s: float) -> int:
    """Hop count of the measured critical path under a unit link model."""
    return round(result.total_time_s / unit_s)
