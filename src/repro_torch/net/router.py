"""BFS shortest-path routing over the OHHC link graph (DESIGN.md §6).

Builds the *link-level* adjacency from ``OHHCTopology.electrical_edges()``
/ ``optical_edges()`` (optionally minus failed links/nodes) and answers
routing queries for the event-driven simulator:

* ``shortest_path(src, dst)`` — hop list ``[(u, v, kind), ...]`` with each
  hop labelled electrical/optical, BFS (unit-weight) shortest;
* ``eccentricity`` / ``eccentricities`` / ``diameter`` — the graph-metric
  cross-checks: the healthy OHHC diameter must equal ``2·d_h + 3``
  (OTIS rule ``2·d(factor) + 1`` with HHC diameter ``d_h + 1``; the
  eccentricity-of-OTIS-nodes analysis of arXiv:1310.7376 motivates
  checking the whole eccentricity profile, not just its max);
* ``verify_diameter()`` — measured vs expected, used by tests and the
  netsim report.

Addresses are global ids (``topo.global_id``); links are canonical
``(min_gid, max_gid)`` tuples.

The port's copy of ``repro.net.router``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import collections
from typing import Iterable

from repro_torch.core.topology import OHHCTopology

from repro_torch.net.links import ELECTRICAL, OPTICAL


class RouteError(RuntimeError):
    """No route exists between two endpoints (disconnection after faults)."""


def canonical_link(a: int, b: int) -> tuple[int, int]:
    return (a, b) if a < b else (b, a)


class Router:
    """Adjacency + BFS routing, with optional failed links/nodes removed.

    ``failed_links`` is an iterable of gid pairs (either order);
    ``failed_nodes`` an iterable of gids.  A failed node keeps its id but
    loses every incident link (it becomes unreachable, and any route
    through it is forbidden).
    """

    def __init__(
        self,
        topo: OHHCTopology,
        *,
        failed_links: Iterable[tuple[int, int]] = (),
        failed_nodes: Iterable[int] = (),
    ):
        self.topo = topo
        self.failed_links = frozenset(canonical_link(*l) for l in failed_links)
        self.failed_nodes = frozenset(int(n) for n in failed_nodes)
        adj: dict[int, list[tuple[int, str]]] = {
            gid: [] for gid in range(topo.total_procs)
        }
        self._kinds: dict[tuple[int, int], str] = {}
        for kind, edges in (
            (ELECTRICAL, topo.electrical_edges()),
            (OPTICAL, topo.optical_edges()),
        ):
            for a, b in edges:
                if canonical_link(a, b) in self.failed_links:
                    continue
                if a in self.failed_nodes or b in self.failed_nodes:
                    continue
                adj[a].append((b, kind))
                adj[b].append((a, kind))
                self._kinds[canonical_link(a, b)] = kind
        self.adjacency = {g: tuple(sorted(ns)) for g, ns in adj.items()}
        self._bfs_cache: dict[int, tuple[dict[int, int], dict[int, int]]] = {}

    # ---- queries ------------------------------------------------------------
    def neighbors(self, gid: int) -> tuple[tuple[int, str], ...]:
        return self.adjacency[gid]

    def link_kind(self, a: int, b: int) -> str | None:
        """Link class of a live edge, or None when absent/failed."""
        return self._kinds.get(canonical_link(a, b))

    def live_links(self) -> dict[tuple[int, int], str]:
        return dict(self._kinds)

    def _bfs(self, src: int) -> tuple[dict[int, int], dict[int, int]]:
        cached = self._bfs_cache.get(src)
        if cached is not None:
            return cached
        dist, parent = {src: 0}, {src: src}
        q = collections.deque([src])
        while q:
            u = q.popleft()
            for v, _ in self.adjacency[u]:
                if v not in dist:
                    dist[v] = dist[u] + 1
                    parent[v] = u
                    q.append(v)
        self._bfs_cache[src] = (dist, parent)
        return dist, parent

    def distance(self, src: int, dst: int) -> int:
        dist, _ = self._bfs(src)
        if dst not in dist:
            raise RouteError(f"no route {src} → {dst}")
        return dist[dst]

    def shortest_path(self, src: int, dst: int) -> list[tuple[int, int, str]]:
        """Hop list [(u, v, kind), ...] along one BFS-shortest route."""
        if src == dst:
            return []
        dist, parent = self._bfs(src)
        if dst not in dist:
            raise RouteError(f"no route {src} → {dst}")
        hops: list[tuple[int, int, str]] = []
        v = dst
        while v != src:
            u = parent[v]
            hops.append((u, v, self._kinds[canonical_link(u, v)]))
            v = u
        hops.reverse()
        return hops

    def component(self, gid: int) -> frozenset:
        """Live nodes reachable from ``gid`` (itself included) — the island
        a fault set strands a sender on (``net.faults`` reports it whole)."""
        dist, _ = self._bfs(gid)
        return frozenset(dist)

    # ---- graph metrics ------------------------------------------------------
    def is_connected(self) -> bool:
        live = [g for g in self.adjacency if g not in self.failed_nodes]
        if not live:
            return True
        dist, _ = self._bfs(live[0])
        return all(g in dist for g in live)

    def eccentricity(self, gid: int) -> int:
        """Max BFS distance from ``gid`` over all *reachable* live nodes."""
        dist, _ = self._bfs(gid)
        live = {g for g in dist if g not in self.failed_nodes}
        return max(dist[g] for g in live)

    def eccentricities(self) -> dict[int, int]:
        return {
            gid: self.eccentricity(gid)
            for gid in self.adjacency
            if gid not in self.failed_nodes
        }

    def diameter(self) -> int:
        return max(self.eccentricities().values())

    def expected_diameter(self) -> int:
        """Healthy-OHHC closed form: 2·d_h + 3."""
        return 2 * self.topo.d_h + 3

    def verify_diameter(self) -> dict:
        """Measured vs closed-form diameter + the eccentricity profile."""
        eccs = self.eccentricities()
        measured = max(eccs.values())
        expected = self.expected_diameter()
        profile = collections.Counter(eccs.values())
        return {
            "measured": measured,
            "expected": expected,
            "ok": measured == expected and not self.failed_links
            and not self.failed_nodes,
            "radius": min(eccs.values()),
            "eccentricity_histogram": dict(sorted(profile.items())),
        }
