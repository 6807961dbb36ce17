"""Link/node fault injection and degraded-schedule rebuilding (DESIGN.md §6).

OTIS networks keep working when individual transpose links die — the
fault-tolerance/Hamiltonicity analysis of arXiv:1109.1706 is the scenario
axis this module opens for the OHHC.  Two complementary mechanisms:

* **Implicit reroute** — hand ``simulate_schedule`` a faulted
  :class:`Router`; any send whose direct link is dead is transparently
  routed over a BFS-shortest alternative (store-and-forward, contention
  counted).  ``RouteError`` propagates when no alternative exists — the
  "fail" half of reroute-or-fail.

* **Explicit degraded schedule** — :func:`rebuild_degraded` rewrites the
  schedule itself: every send with a dead direct link becomes a chain of
  single-hop relay ``Send``s (phase tagged ``<phase>+reroute``), each in
  its own round.  The rebuilt schedule runs on the faulted graph with
  **zero** simulator-level reroutes, which is how tests cross-check the
  two mechanisms.  Relay sends follow *accumulation* semantics like every
  other ``Send``: a relay node forwards **everything it holds** — its own
  not-yet-sent chunk and any payload parked there by earlier rounds rides
  along (payload coalescing, the same wait-count discipline the paper's
  gather uses).  Delivery totals match the implicit mode exactly; the
  per-message byte timeline intentionally differs (coalesced vs carried
  end-to-end), which is itself a modelling choice worth comparing.

Node faults: a failed *leaf* (a node that only ever sends) loses its data
— the gather completes degraded, and the loss is visible in
``SimResult.master_elems``.  A failed *internal* node of the accumulation
tree (any send's destination) makes the gather impossible as scheduled,
and :func:`rebuild_degraded` raises :class:`GatherImpossible` instead of
silently dropping a subtree.

The port's copy of ``repro.net.faults``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Sequence

from repro_torch.core.schedule import AccumulationSchedule, Send
from repro_torch.core.topology import OHHCTopology

from repro_torch.net.router import RouteError, Router

__all__ = [
    "GatherImpossible",
    "FaultScenario",
    "rebuild_degraded",
    "degraded_gather_rounds",
    "predicted_slowdown",
]


class GatherImpossible(RuntimeError):
    """The fault set breaks the accumulation tree beyond rerouting.

    ``nodes`` carries the offending *global ids* — the failed internal
    destinations, or the live nodes the fault set cut off from their
    scheduled destination — so callers can act on **which** part of the
    tree broke (the engine's fallback ladder, the fleet's worker mapping,
    tests) instead of parsing the message.
    """

    def __init__(self, message: str, *, nodes: Iterable[int] = ()):
        super().__init__(message)
        self.nodes = frozenset(int(n) for n in nodes)


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """A named set of dead links and nodes, in (group, local) addresses."""

    name: str = "healthy"
    failed_links: tuple = ()  # ((g, l), (g, l)) pairs, either order
    failed_nodes: tuple = ()  # (g, l) addresses

    @property
    def is_degraded(self) -> bool:
        """True when the scenario actually removes links or nodes."""
        return bool(self.failed_links or self.failed_nodes)

    def router(self, topo: OHHCTopology) -> Router:
        links = [
            (topo.global_id(*a), topo.global_id(*b)) for a, b in self.failed_links
        ]
        nodes = [topo.global_id(*n) for n in self.failed_nodes]
        return Router(topo, failed_links=links, failed_nodes=nodes)

    @classmethod
    def optical_link_down(cls, g: int) -> "FaultScenario":
        """The canonical scenario: group ``g``'s OTIS uplink (g,0)↔(0,g) dead."""
        if g == 0:
            # (0,0)↔(0,0) is the self-transpose hole, not a link — a "fault"
            # here would silently simulate the healthy network.
            raise ValueError("group 0 has no OTIS uplink to fail")
        return cls(
            name=f"optical_g{g}_down",
            failed_links=(((g, 0), (0, g)),),
        )

    @classmethod
    def worker_down(cls, w: int) -> "FaultScenario":
        """Serving-fleet vocabulary: fleet worker ``w`` ≡ OHHC group ``w``
        losing its hub node (g,0) — and with it, its OTIS uplink.

        This is the simulator-side twin of ``ChaosConfig`` killing fleet
        worker ``w`` (DESIGN.md §10): the group hub is an *internal*
        accumulation-tree destination, so ``rebuild_degraded`` raises
        :class:`GatherImpossible` — a dead worker cannot be routed around
        inside one gather, it must be drained and its work re-admitted,
        which is exactly the fleet's failover policy.  Contrast with
        :meth:`optical_link_down`, where only the uplink dies and relay
        chains reroute the gather.
        """
        if w < 0:
            raise ValueError("worker index must be >= 0")
        links = () if w == 0 else (((w, 0), (0, w)),)
        return cls(
            name=f"worker{w}_down",
            failed_links=links,
            failed_nodes=((w, 0),),
        )

    @classmethod
    def group_uplinks_down(cls, topo: OHHCTopology, g: int) -> "FaultScenario":
        """Every OTIS uplink of group ``g`` dead: the group stays
        electrically intact but optically islanded, so no payload can leave
        it — the canonical scenario :func:`rebuild_degraded` must refuse
        with the group's node set (it cannot be rerouted around)."""
        links = []
        for l in range(topo.procs_per_group):
            partner = topo.optical_partner(g, l)
            if partner is not None:
                links.append(((g, l), partner))
        if not links:
            raise ValueError(f"group {g} has no OTIS uplinks in this topology")
        return cls(name=f"uplinks_g{g}_down", failed_links=tuple(links))

    @classmethod
    def random_links(
        cls, topo: OHHCTopology, k: int, *, seed: int = 0
    ) -> "FaultScenario":
        """Seeded uniform draw of ``k`` dead links over the full (sorted)
        electrical+optical edge list — the k-link scenario axis the reference's
        ``bench_faults``, this port's tests and ``chip_smoke.py`` share.  Same
        ``(topo, k, seed)`` ⇒ same scenario, on any host."""
        edges = sorted(
            {(min(a, b), max(a, b)) for a, b in topo.electrical_edges()}
            | {(min(a, b), max(a, b)) for a, b in topo.optical_edges()}
        )
        if not 0 <= k <= len(edges):
            raise ValueError(
                f"k={k} outside [0, {len(edges)}] links of this topology"
            )
        chosen = random.Random(seed).sample(edges, k)
        return cls(
            name=f"klinks{k}_s{seed}",
            failed_links=tuple(
                (topo.addr(a), topo.addr(b)) for a, b in sorted(chosen)
            ),
        )


def rebuild_degraded(
    schedule: "AccumulationSchedule | Sequence[Sequence[Send]]",
    topo: OHHCTopology,
    router: Router,
) -> tuple[tuple[Send, ...], ...]:
    """Rewrite ``schedule`` so every send uses only live direct links.

    Healthy sends keep their rounds; a send whose direct link is dead is
    replaced by its BFS relay chain, each hop appended as its own round
    right after the original round (store-and-forward order preserved, and
    later rounds — which depend on the payload's arrival — stay later).
    Sends *from* a failed leaf node are dropped (data loss, reported by the
    simulator); a failed internal node raises :class:`GatherImpossible`.

    The impossible verdict is all-at-once, never partial: before any
    rewriting, every send is checked for a live route, and a fault set that
    strands *any* live sender (e.g. all of a group's uplinks dead) raises
    :class:`GatherImpossible` whose ``nodes`` is the full cut-off
    component — not a partial schedule, and not a one-send message for a
    many-node disconnection.
    """
    rounds = (
        schedule.rounds
        if isinstance(schedule, AccumulationSchedule)
        else schedule
    )
    failed = set(router.failed_nodes)
    if failed:
        internal = {
            topo.global_id(*s.dst) for rnd in rounds for s in rnd
        } & failed
        if internal:
            raise GatherImpossible(
                f"failed node(s) {sorted(internal)} are accumulation-tree "
                "destinations; the gather cannot complete as scheduled",
                nodes=internal,
            )

    # Routability pre-pass: find every send the fault set strands, and
    # raise ONCE with the union of their cut-off components.
    stranded: set[int] = set()
    examples: list[str] = []
    for rnd in rounds:
        for s in rnd:
            src = topo.global_id(*s.src)
            dst = topo.global_id(*s.dst)
            if src in failed or src == dst:
                continue
            if router.link_kind(src, dst) is not None:
                continue
            try:
                router.shortest_path(src, dst)
            except RouteError:
                # the whole component around src is what the faults islanded
                stranded |= router.component(src)
                if len(examples) < 3:
                    examples.append(f"{s.src}→{s.dst} ({s.phase})")
    if stranded:
        raise GatherImpossible(
            f"fault set cuts node(s) {sorted(stranded)} off from their "
            f"scheduled destination (e.g. {', '.join(examples)}); "
            "the gather cannot be rerouted",
            nodes=stranded,
        )

    out: list[tuple[Send, ...]] = []
    for rnd in rounds:
        direct: list[Send] = []
        relay_chains: list[list[Send]] = []
        for s in rnd:
            src = topo.global_id(*s.src)
            dst = topo.global_id(*s.dst)
            if src in failed:
                continue  # dead leaf: its payload is lost, gather degrades
            if src == dst or router.link_kind(src, dst) is not None:
                # self-sends deliver in place in the simulator; never let
                # one fall through to shortest_path's empty hop list (a
                # zero-hop "relay chain" would silently drop the send)
                direct.append(s)
                continue
            hops = router.shortest_path(src, dst)  # pre-pass proved it routes
            relay_chains.append(
                [
                    Send(topo.addr(u), topo.addr(v), kind, f"{s.phase}+reroute")
                    for u, v, kind in hops
                ]
            )
        if direct:
            out.append(tuple(direct))
        # Interleave relay hops as follow-on rounds: hop k of every chain
        # shares round slot k (chains are link-disjoint per hop or the
        # simulator's occupancy serialises them).
        depth = max((len(c) for c in relay_chains), default=0)
        for k in range(depth):
            out.append(tuple(c[k] for c in relay_chains if len(c) > k))
    return tuple(r for r in out if r)


def degraded_gather_rounds(
    topo: OHHCTopology, scenario: FaultScenario
) -> tuple[tuple[Send, ...], ...]:
    """Paper schedule → degraded rounds for ``scenario`` (convenience)."""
    return rebuild_degraded(
        AccumulationSchedule.build(topo), topo, scenario.router(topo)
    )


def predicted_slowdown(
    topo: OHHCTopology,
    scenario: FaultScenario,
    *,
    chunk_sizes: "int | Sequence[int]",
    itemsize: int = 4,
    link_model=None,
    barrier: bool = True,
) -> tuple[float, float, float]:
    """``(healthy_s, degraded_s, ratio)`` for one gather under ``scenario``.

    Both sides run the event-driven simulator (``repro_torch.net.sim``) over the
    same chunk sizes: the healthy side on the paper schedule, the degraded
    side on :func:`rebuild_degraded`'s rewrite with the scenario's faulted
    router.  ``barrier=True`` is the paper's BSP accounting — the number
    the engine quotes as *predicted* slowdown in ``SortPlan.reason``, and
    the one the reference's ``bench_faults`` gates the *measured*
    (dependency-mode, contention-aware) ratio against.  Raises :class:`GatherImpossible` when the
    scenario cannot gather at all.
    """
    from repro_torch.net.links import LinkModel
    from repro_torch.net.sim import simulate_gather, simulate_schedule

    lm = link_model if link_model is not None else LinkModel()
    healthy = simulate_gather(
        topo,
        link_model=lm,
        chunk_sizes=chunk_sizes,
        itemsize=itemsize,
        barrier=barrier,
    ).total_time_s
    router = scenario.router(topo)
    rounds = rebuild_degraded(AccumulationSchedule.build(topo), topo, router)
    degraded = simulate_schedule(
        rounds,
        topo,
        link_model=lm,
        router=router,
        chunk_sizes=chunk_sizes,
        itemsize=itemsize,
        barrier=barrier,
    ).total_time_s
    return healthy, degraded, degraded / healthy
