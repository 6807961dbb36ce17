"""Affinity routing with admission-side work stealing (DESIGN.md §10).

Pure decision logic — no threads, no queues — so every property the fleet
relies on is unit-testable without timing:

* **Affinity** (:func:`rendezvous_worker`): each ``(dtype, pow2 bucket)``
  key maps to one worker by rendezvous (highest-random-weight) hashing
  over the *live* worker set.  Same key ⇒ same worker ⇒ that worker's
  warm executor cache serves every flush of the key; and when a worker dies,
  only ITS keys move (the rendezvous minimal-disruption property — the
  other workers' caches stay hot), the fleet analog of the OTIS
  fault-tolerance claim that a failed element perturbs only its own
  routes.  Hashing is ``crc32`` over the printable key, never Python's
  salted ``hash``: placement must be stable across runs so tests and the
  perf gate see one routing, and across processes so a future multi-host
  fleet agrees on it.

* **Stealing** (:meth:`AffinityRouter.route`): affinity concentrates load
  by design, so it needs a safety valve.  When the affine worker's
  backlog reaches ``steal_watermark`` AND the least-loaded live worker's
  backlog times ``steal_margin`` is still below it, the request is routed
  there instead (`RouteDecision.stolen`) — the underloaded worker steals
  the job at admission.  The margin keeps a marginal imbalance from
  flapping traffic (and cold caches) back and forth; the watermark keeps
  stealing OFF entirely until affinity actually hurts.

The port's copy of ``repro.serve.fleet.routing``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping, Sequence

__all__ = ["AffinityRouter", "RouteDecision", "rendezvous_worker"]

AffinityKey = "tuple[str, int]"


def rendezvous_worker(key, workers: "Sequence[int]") -> int:
    """Highest-random-weight choice of worker for ``key`` — deterministic,
    uniform-ish, and minimally disrupted by membership changes."""
    if not workers:
        raise ValueError("no live workers to route to")
    token = f"{key[0]}/{key[1]}"
    return max(
        workers,
        key=lambda w: (zlib.crc32(f"{token}#{w}".encode()), w),
    )


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one request goes and why."""

    worker: int  # chosen worker id
    affine: int  # where affinity alone would have sent it
    stolen: bool  # True when the watermark tripped and the choice differs


class AffinityRouter:
    """Stateless-per-request router; the only state is a placement cache
    keyed on (affinity key, live-set) so the common path is one dict hit."""

    def __init__(self, *, steal_watermark: int = 8, steal_margin: int = 2):
        if steal_watermark < 1:
            raise ValueError("steal_watermark must be >= 1")
        if steal_margin < 1:
            raise ValueError("steal_margin must be >= 1")
        self.steal_watermark = steal_watermark
        self.steal_margin = steal_margin
        self._cache: dict = {}

    def route(
        self,
        key,
        live: "Sequence[int]",
        backlogs: "Mapping[int, int]",
    ) -> RouteDecision:
        """Pick a worker for ``key`` given per-worker backlogs.

        ``live`` must be ordered deterministically (the fleet passes a
        sorted tuple); ``backlogs`` is a snapshot — staleness only costs
        steal quality, never correctness.
        """
        live_t = tuple(live)
        cached = self._cache.get((key, live_t))
        if cached is None:
            cached = rendezvous_worker(key, live_t)
            if len(self._cache) > 4096:  # bounded: keys × live-sets is small
                self._cache.clear()
            self._cache[(key, live_t)] = cached
        affine = cached
        depth = backlogs.get(affine, 0)
        if depth >= self.steal_watermark and len(live_t) > 1:
            thief = min(live_t, key=lambda w: (backlogs.get(w, 0), w))
            if thief != affine and backlogs.get(thief, 0) * self.steal_margin <= depth:
                return RouteDecision(worker=thief, affine=affine, stolen=True)
        return RouteDecision(worker=affine, affine=affine, stolen=False)
