"""Worker health checking: liveness probes + heartbeat staleness
(DESIGN.md §10).

Two failure modes, two detectors, one verdict:

* **Crash** — the worker *thread* is gone (chaos ``kill()``, an escaped
  exception).  Detected by the liveness probe (``Thread.is_alive``)
  within one check interval; there is nothing to wait out.
* **Stall** — the thread is alive but stuck (chaos stall injection, a
  wedged engine call).  Detected by heartbeat staleness: workers beat via
  their tick hooks (per loop iteration and per flush), so a beat older
  than ``timeout_s`` means no scheduling progress.  ``timeout_s`` must
  exceed the worst single uninterruptible unit of work (one oversize
  direct sort) or a slow-but-healthy worker gets declared dead — that
  only costs duplicated work, never a wrong answer (the fleet's
  first-resolution-wins guard), but it is wasted capacity.

The monitor never *acts* on a worker — it calls ``on_dead(worker_id,
reason)`` exactly once per worker and lets the fleet own the drain, so
the policy (re-admission, routing eviction) stays in one place and the
monitor stays reusable.

The port's copy of ``repro.serve.fleet.health``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable

__all__ = ["HealthMonitor", "WorkerState"]


class WorkerState(enum.Enum):
    LIVE = "live"
    DEAD = "dead"


@dataclasses.dataclass
class _Probe:
    alive: "Callable[[], bool]"
    last_beat: "Callable[[], float]"
    dead: bool = False


class HealthMonitor:
    """Periodic prober; ``on_dead`` fires once per failed worker."""

    def __init__(
        self,
        *,
        interval_s: float = 0.05,
        timeout_s: float = 1.0,
        on_dead: "Callable[[int, str], None]",
    ):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._on_dead = on_dead
        self._probes: "dict[int, _Probe]" = {}
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def register(
        self,
        worker_id: int,
        *,
        alive: "Callable[[], bool]",
        last_beat: "Callable[[], float]",
    ) -> None:
        self._probes[worker_id] = _Probe(alive=alive, last_beat=last_beat)

    def start(self) -> "HealthMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="fleet-health", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def check_now(self) -> "list[tuple[int, str]]":
        """One synchronous probe pass (the deterministic test seam).

        Returns the ``(worker_id, reason)`` verdicts it issued.
        """
        now = time.monotonic()
        verdicts = []
        for wid, probe in list(self._probes.items()):
            if probe.dead:
                continue
            if not probe.alive():
                reason = "crashed"
            elif now - probe.last_beat() > self.timeout_s:
                reason = "heartbeat-timeout"
            else:
                continue
            probe.dead = True
            verdicts.append((wid, reason))
            self._on_dead(wid, reason)
        return verdicts

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_now()
