"""``SortdFleet`` — N sortd workers behind one admission layer, with
affinity routing, work stealing, health-checked failover, and chaos
injection (DESIGN.md §10).

The paper's pitch is that many cooperating processors beat one; the
serving translation is N :class:`~repro_torch.serve.sortd.Sortd` workers (each
with its OWN :class:`~repro_torch.core.engine.SortEngine` — per-worker executor/plan
cache isolation; one per device when a mesh exists, N threads on one
device otherwise) behind a single ``submit``.  What the fleet adds over
one bigger sortd:

* **Admission + routing**: ``submit`` is the shared admission point
  (bounded by ``max_inflight`` — ``QueueFull`` or blocking backpressure,
  same contract as sortd).  Routing is the client thread running
  :class:`~repro_torch.serve.fleet.routing.AffinityRouter` — no dispatcher
  thread, no extra hop on the hot path.  Affinity keeps each ``(dtype,
  pow2 bucket)`` on one warm worker; the steal watermark redirects
  admissions away from a backlogged worker.
* **Failover** (the Ghosh & Ghosh OTIS fault-tolerance regime as a
  serving property): the fleet tracks every admitted-but-unresolved job
  per worker; when the health monitor declares a worker dead (crashed
  thread or stale heartbeat), the worker is drained — its unresolved
  jobs re-admitted to survivors — so a dead worker costs latency, never
  an answer.  Resolution is first-wins: a stalled worker that recovers
  after its jobs were re-admitted just produces harmless duplicates
  (sorting is deterministic; the first ``set_result`` sticks).
* **Chaos** (:class:`ChaosConfig`): deterministic fault injection in the
  ``FaultScenario`` mold — ``kill_worker_after`` admissions crashes a
  worker mid-load via ``Sortd.kill()`` (futures dangle, exactly like a
  real crash), ``stall_worker_ms`` freezes one via its tick hook.
  ``ChaosConfig.scenario()`` names the matching simulator-side
  ``FaultScenario.worker_down`` so the fleet and ``net.faults`` speak one
  vocabulary.
* **Observability**: ``metrics()`` is per-worker (state, backlog,
  admitted/completed, busy fraction, embedded sortd metrics) plus
  fleet-wide (p50/p99 over the fleet latency window, steals, failovers,
  re-admissions, saturation, aggregate pad waste); ``report()`` +
  :func:`write_json` produce the JSON artifact, mirroring
  ``repro_torch.net.report``.

Throughput note: fleet workers default to ``idle_flush_s`` (see DESIGN.md
§10), which removes the single sortd's coalescing-deadline idle.  On one
card every worker launches on the current stream, so the workers' kernels
run one after another: the fleet's win there is scheduling, not parallel
compute.

The port's copy of ``repro.serve.fleet.fleet``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.engine import SortEngine
from repro_torch.net.faults import FaultScenario
from repro_torch.serve.fleet.health import HealthMonitor, WorkerState
from repro_torch.serve.fleet.routing import AffinityRouter
from repro_torch.serve.sortd import QueueFull, Sortd, SortdConfig, affinity_key

__all__ = ["SortdFleet", "FleetConfig", "ChaosConfig", "FleetDown", "write_json"]


class FleetDown(RuntimeError):
    """No live worker remains to serve or re-admit a job."""


def _default_worker_config() -> SortdConfig:
    # Smaller per-worker queue than a standalone sortd (the fleet's
    # max_inflight is the real admission bound; a full worker queue just
    # triggers overflow-stealing) + the fleet scheduling knobs: idle flush
    # on, ticks frequent enough to heartbeat.  block_on_full must stay
    # False — the fleet calls worker.submit under its admission lock.
    return SortdConfig(
        max_queue=256,
        max_bucket=1 << 12,
        idle_flush_s=1e-4,
        tick_interval_s=0.02,
        block_on_full=False,
    )


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-level knobs; per-worker knobs ride in ``worker_config``.

    workers:              worker count (one engine + one sortd each).
    steal_watermark:      affine backlog depth that arms admission-side
                          stealing (see routing module).
    steal_margin:         required load ratio before a steal fires.
    max_inflight:         fleet-wide admission bound (backpressure).
    block_on_full:        submit blocks (True) or raises QueueFull (False).
    heartbeat_interval_s: health probe period (and worker tick cap).
    heartbeat_timeout_s:  stale-heartbeat threshold — must exceed the
                          worst single direct sort or a slow worker is
                          declared dead (costing duplicate work only).
    latency_window:       fleet-wide sliding window for p50/p99.
    worker_config:        SortdConfig for every worker (block_on_full and
                          tick_interval_s are overridden by the fleet).
    """

    workers: int = 4
    steal_watermark: int = 8
    steal_margin: int = 2
    max_inflight: int = 4096
    block_on_full: bool = False
    heartbeat_interval_s: float = 0.02
    heartbeat_timeout_s: float = 1.0
    latency_window: int = 8192
    worker_config: SortdConfig = dataclasses.field(
        default_factory=_default_worker_config
    )


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection, ``FaultScenario``-style.

    kill_worker_after: fleet admission count at which the kill fires
                       (None disables).
    kill_worker:       victim index, or "busiest" = largest backlog at
                       trigger time (guarantees a non-trivial drain).
    stall_worker_ms:   one-shot stall length injected on the victim's
                       worker thread (0 disables).
    stall_worker:      stall victim index.
    stall_worker_after: admission count arming the stall.
    """

    name: str = "none"
    kill_worker_after: "int | None" = None
    kill_worker: "int | str" = "busiest"
    stall_worker_ms: float = 0.0
    stall_worker: int = 0
    stall_worker_after: int = 0

    def scenario(self, worker: int) -> FaultScenario:
        """The simulator-vocabulary twin of killing ``worker`` (shared
        naming with ``net.faults`` degraded-schedule scenarios)."""
        return FaultScenario.worker_down(worker)


class _Job:
    __slots__ = ("id", "keys", "key", "future", "t_submit", "worker",
                 "attempts", "resolved")

    def __init__(self, jid: int, keys: np.ndarray, key) -> None:
        self.id = jid
        self.keys = keys
        self.key = key
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.worker = -1
        self.attempts = 0
        self.resolved = False


class _Worker:
    __slots__ = ("wid", "engine", "sortd", "inflight", "admitted",
                 "completed", "steals_in", "state", "dead_reason",
                 "last_beat", "stall_ms_pending")

    def __init__(self, wid: int, engine: SortEngine, sortd: Sortd) -> None:
        self.wid = wid
        self.engine = engine
        self.sortd = sortd
        self.inflight: "dict[int, _Job]" = {}
        self.admitted = 0
        self.completed = 0
        self.steals_in = 0
        self.state = WorkerState.LIVE
        self.dead_reason: "str | None" = None
        self.last_beat = time.monotonic()
        self.stall_ms_pending = 0.0


class SortdFleet:
    """Use as a context manager or call ``close()`` yourself.

    >>> with SortdFleet(FleetConfig(workers=2)) as fleet:
    ...     fleet.sort(np.array([3, 1, 2], np.int32))
    array([1, 2, 3], dtype=int32)
    """

    def __init__(
        self,
        config: "FleetConfig | None" = None,
        *,
        engine_factory: "Callable[[int], SortEngine] | None" = None,
        chaos: "ChaosConfig | None" = None,
        start: bool = True,
    ):
        self.config = config if config is not None else FleetConfig()
        if self.config.workers < 1:
            raise ValueError("a fleet needs at least one worker")
        self.chaos = chaos
        self._lock = threading.RLock()
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._job_ids = itertools.count()
        self._router = AffinityRouter(
            steal_watermark=self.config.steal_watermark,
            steal_margin=self.config.steal_margin,
        )
        wcfg = dataclasses.replace(
            self.config.worker_config,
            block_on_full=False,
            tick_interval_s=self.config.heartbeat_interval_s,
        )
        factory = engine_factory if engine_factory is not None else (
            lambda wid: SortEngine()
        )
        self._workers: "list[_Worker]" = []
        for wid in range(self.config.workers):
            sortd = Sortd(factory(wid), wcfg, start=False)
            w = _Worker(wid, sortd.engine, sortd)
            sortd.add_tick_hook(lambda w=w: self._worker_tick(w))
            self._workers.append(w)
        self._live: "set[int]" = set(range(self.config.workers))
        self._monitor = HealthMonitor(
            interval_s=self.config.heartbeat_interval_s,
            timeout_s=self.config.heartbeat_timeout_s,
            on_dead=self._on_worker_dead,
        )
        for w in self._workers:
            self._monitor.register(
                w.wid,
                alive=(lambda w=w: w.sortd.worker_alive),
                last_beat=(lambda w=w: w.last_beat),
            )
        # metrics (under _lock)
        self._inflight_total = 0
        self._admitted = 0
        self._completed = 0
        self._failed = 0
        self._rejected = 0
        self._steals = 0
        self._failovers = 0
        self._readmitted = 0
        self._lat_s: "list[float]" = []
        self._t_start = time.monotonic()
        # chaos arming
        self._chaos_killed: "int | None" = None
        self._chaos_stalled: "int | None" = None
        # degraded serving (DESIGN.md §11)
        self._fault_scenario: "FaultScenario | None" = None
        self._fault_summary: "dict | None" = None
        if start:
            self.start()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "SortdFleet":
        for w in self._workers:
            w.sortd.start()
        self._monitor.start()
        return self

    def __enter__(self) -> "SortdFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drain every live worker, resolve every admitted job, stop.

        Jobs stranded on a crashed-but-not-yet-drained worker are served
        inline here — ``close`` never leaves an admitted future dangling.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._not_full.notify_all()
        self._monitor.stop()
        for w in self._workers:
            if w.state is WorkerState.LIVE:
                w.sortd.close()  # flush-drain; callbacks resolve our jobs
        # Final sweep: anything still unresolved (crashed worker backlog
        # that the monitor had not drained yet) is served inline.
        with self._lock:
            stranded = [
                j
                for w in self._workers
                for j in list(w.inflight.values())
                if not j.resolved
            ]
            for w in self._workers:
                w.inflight.clear()
        for job in stranded:
            try:
                out = self._workers[0].engine.sort(job.keys)
            except Exception as e:  # noqa: BLE001
                self._resolve(job, error=e)
            else:
                self._resolve(job, result=out)

    # ----------------------------------------------------------- admission
    def submit(self, keys) -> Future:
        """Route one request to a worker; the Future resolves to the
        sorted array (from the first worker to finish it, under chaos)."""
        arr = np.asarray(keys).ravel()
        key = affinity_key(arr)
        job = _Job(next(self._job_ids), arr, key)
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet is closed")
            while self._inflight_total >= self.config.max_inflight:
                if not self.config.block_on_full:
                    self._rejected += 1
                    raise QueueFull(
                        f"fleet at max_inflight ({self.config.max_inflight})"
                    )
                self._not_full.wait(0.1)
                if self._closed:
                    raise RuntimeError("fleet is closed")
            self._admitted += 1
            self._maybe_trigger_chaos()
            wid = self._pick_worker(key)
            self._place(job, wid, new=True)
        self._dispatch(job)
        return job.future

    def sort(self, keys, timeout: "float | None" = 60.0) -> np.ndarray:
        """Synchronous convenience wrapper: ``submit(keys).result()``."""
        return self.submit(keys).result(timeout=timeout)

    # ------------------------------------------------------------- workers
    def _worker_tick(self, w: _Worker) -> None:
        # Runs on w's worker thread: heartbeat + one-shot chaos stall.
        w.last_beat = time.monotonic()
        if w.stall_ms_pending > 0.0:
            stall, w.stall_ms_pending = w.stall_ms_pending, 0.0
            time.sleep(stall / 1e3)

    def _backlogs(self) -> "dict[int, int]":
        return {w.wid: len(w.inflight) for w in self._workers}

    def _pick_worker(self, key) -> int:
        # under _lock
        if not self._live:
            raise FleetDown("no live workers")
        decision = self._router.route(key, sorted(self._live), self._backlogs())
        if decision.stolen:
            self._steals += 1
            self._workers[decision.worker].steals_in += 1
        return decision.worker

    def _place(self, job: _Job, wid: int, *, new: bool) -> None:
        # under _lock
        w = self._workers[wid]
        job.worker = wid
        job.attempts += 1
        w.inflight[job.id] = job
        w.admitted += 1
        if new:
            self._inflight_total += 1

    def _dispatch(self, job: _Job) -> None:
        """Hand the placed job to its worker's sortd (outside the lock)."""
        w = self._workers[job.worker]
        try:
            wf = w.sortd.submit(job.keys)
        except QueueFull:
            self._overflow(job)
            return
        except RuntimeError:
            # closed/racing-dead worker: treat like a death drain for this job
            self._readmit_one(job, reason="worker-closed")
            return
        wf.add_done_callback(lambda f, job=job: self._job_done(job, f))

    def _overflow(self, job: _Job) -> None:
        """Worker queue full: spill to the least-loaded other live worker
        (overload stealing); all full ⇒ backpressure to the caller."""
        with self._lock:
            w = self._workers[job.worker]
            w.inflight.pop(job.id, None)
            candidates = [
                x for x in sorted(self._live)
                if x != job.worker and self._workers[x].sortd.backlog()
                < self.config.worker_config.max_queue
            ]
            if not candidates:
                self._rejected += 1
                self._inflight_total -= 1
                job.resolved = True
                self._not_full.notify_all()
                err: "Exception | None" = QueueFull(
                    "every live worker queue is at capacity"
                )
            else:
                err = None
                wid = min(candidates, key=lambda x: len(self._workers[x].inflight))
                if wid != job.worker:
                    self._steals += 1
                    self._workers[wid].steals_in += 1
                self._place(job, wid, new=False)
        if err is not None:
            try:
                job.future.set_exception(err)
            except InvalidStateError:
                pass
        else:
            self._dispatch(job)

    # ------------------------------------------------------------ completion
    def _resolve(self, job: _Job, *, result=None, error=None) -> None:
        """First resolution wins; later (duplicate) ones are no-ops."""
        with self._lock:
            if job.resolved:
                return
            job.resolved = True
            self._inflight_total -= 1
            w = self._workers[job.worker]
            w.inflight.pop(job.id, None)
            if error is None:
                self._completed += 1
                w.completed += 1
                lat = time.monotonic() - job.t_submit
                self._lat_s.append(lat)
                if len(self._lat_s) > self.config.latency_window:
                    del self._lat_s[: -self.config.latency_window]
            else:
                self._failed += 1
            self._not_full.notify_all()
        # outside the lock: client done-callbacks must not run under it
        try:
            if error is None:
                job.future.set_result(result)
            else:
                job.future.set_exception(error)
        except InvalidStateError:
            pass  # caller cancelled

    def _job_done(self, job: _Job, wf: Future) -> None:
        exc = wf.exception()
        if exc is not None:
            self._resolve(job, error=exc)
        else:
            self._resolve(job, result=wf.result())

    # -------------------------------------------------------------- failover
    def _on_worker_dead(self, wid: int, reason: str) -> None:
        """Health verdict: evict from routing, re-admit the backlog."""
        with self._lock:
            w = self._workers[wid]
            if w.state is not WorkerState.LIVE:
                return
            w.state = WorkerState.DEAD
            w.dead_reason = reason
            self._live.discard(wid)
            self._failovers += 1
            jobs = [j for j in w.inflight.values() if not j.resolved]
            w.inflight.clear()
            self._readmitted += len(jobs)
        for job in jobs:
            self._readmit_one(job, reason=reason)

    def _readmit_one(self, job: _Job, *, reason: str) -> None:
        with self._lock:
            if job.resolved:
                return
            try:
                wid = self._pick_worker(job.key)
            except FleetDown:
                wid = None
            if wid is not None:
                self._place(job, wid, new=False)
        if wid is None:
            self._resolve(
                job,
                error=FleetDown(
                    f"worker {job.worker} died ({reason}) with no live "
                    "worker left to re-admit to"
                ),
            )
        else:
            self._dispatch(job)

    # ---------------------------------------------------------------- faults
    def apply_fault_scenario(self, scenario: "FaultScenario | None") -> dict:
        """Map a simulator-side ``FaultScenario`` onto the live fleet
        (DESIGN.md §11) — the serving end of the ``net.faults`` vocabulary.

        Worker-hub node faults ``(w, 0)`` with ``w < workers`` become real
        worker deaths: the victim is crashed through the SAME
        ``Sortd.kill()`` path ``ChaosConfig`` uses, so the health monitor's
        drain-and-readmit failover serves its backlog (and chaos kills and
        simulated topology faults are literally one code path).  Every
        remaining link/node fault is the *residual* scenario, forwarded to
        each surviving worker's engine — subsequent flushes re-price their
        plans over the degraded topology, or fall back to the healthy host
        path when the residual gather is impossible.  ``None`` heals the
        engines (dead workers stay dead — failover is not undone).

        Returns (and records in ``report()``) a summary dict:
        ``{"scenario", "killed_workers", "residual_faults"}``.
        """
        killed: "list[int]" = []
        residual = scenario
        if scenario is not None:
            killed = sorted(
                g for g, l in scenario.failed_nodes
                if l == 0 and 0 <= g < self.config.workers
            )
            residual = self._residual_scenario(scenario, killed)
        for w in self._workers:
            if w.wid not in killed:
                w.sortd.set_fault_scenario(residual)
        for wid in killed:
            self.kill_worker(wid)
        summary = {
            "scenario": None if scenario is None else scenario.name,
            "killed_workers": killed,
            "residual_faults": 0 if residual is None else (
                len(residual.failed_links) + len(residual.failed_nodes)
            ),
        }
        with self._lock:
            self._fault_scenario = scenario
            self._fault_summary = None if scenario is None else summary
        return summary

    @staticmethod
    def _residual_scenario(
        scenario: FaultScenario, killed: "Sequence[int]"
    ) -> "FaultScenario | None":
        """The scenario minus the killed worker hubs and their links — what
        the *surviving* workers' engines must still serve under."""
        if not killed:
            return scenario if scenario.is_degraded else None
        hubs = {(w, 0) for w in killed}
        links = tuple(
            (a, b) for a, b in scenario.failed_links
            if tuple(a) not in hubs and tuple(b) not in hubs
        )
        nodes = tuple(n for n in scenario.failed_nodes if tuple(n) not in hubs)
        if not links and not nodes:
            return None
        return dataclasses.replace(
            scenario, failed_links=links, failed_nodes=nodes
        )

    # ---------------------------------------------------------------- chaos
    def _maybe_trigger_chaos(self) -> None:
        # under _lock, on the admitting client thread
        c = self.chaos
        if c is None:
            return
        if (
            c.kill_worker_after is not None
            and self._chaos_killed is None
            and self._admitted >= c.kill_worker_after
        ):
            victim = self._chaos_victim(c.kill_worker)
            if victim is not None:
                self._chaos_killed = victim
                # The kill goes through the FaultScenario mapping — chaos
                # and simulated topology faults are one code path (§11).
                self.apply_fault_scenario(c.scenario(victim))
        if (
            c.stall_worker_ms > 0.0
            and self._chaos_stalled is None
            and self._admitted >= c.stall_worker_after
        ):
            self._chaos_stalled = c.stall_worker
            self._workers[c.stall_worker].stall_ms_pending = c.stall_worker_ms

    def _chaos_victim(self, spec) -> "int | None":
        if spec == "busiest":
            live = sorted(self._live)
            if not live:
                return None
            return max(live, key=lambda wid: len(self._workers[wid].inflight))
        return int(spec) if int(spec) in self._live else None

    def kill_worker(self, wid: int) -> None:
        """Manual chaos: crash worker ``wid`` now (test surface)."""
        self._workers[wid].sortd.kill()

    def check_health_now(self) -> "list[tuple[int, str]]":
        """Synchronous health pass (deterministic test seam)."""
        return self._monitor.check_now()

    # -------------------------------------------------------------- metrics
    def live_workers(self) -> "list[int]":
        with self._lock:
            return sorted(self._live)

    def metrics(self) -> dict:
        """JSON-ready snapshot: fleet-wide + per-worker observability."""

        def pct(d, q):
            return float(np.percentile(np.asarray(d), q)) * 1e3 if d else 0.0

        now = time.monotonic()
        with self._lock:
            uptime = max(now - self._t_start, 1e-9)
            workers = {}
            pad_cells = valid_cells = 0
            busy_fracs = []
            for w in self._workers:
                sm = w.sortd.metrics()
                for b in sm["buckets"].values():
                    total = b["requests"]
                    # pad_waste is a ratio; recover cells via rows×bucket is
                    # lossy — aggregate the ratios weighted by requests.
                    pad_cells += b["pad_waste"] * total
                    valid_cells += (1.0 - b["pad_waste"]) * total
                busy = sm["busy_s"] / max(sm["uptime_s"], 1e-9)
                if w.state is WorkerState.LIVE:
                    busy_fracs.append(busy)
                workers[str(w.wid)] = {
                    "state": w.state.value,
                    "dead_reason": w.dead_reason,
                    "fault": getattr(w.engine.fault_scenario, "name", None),
                    "admitted": w.admitted,
                    "completed": w.completed,
                    "inflight": len(w.inflight),
                    "backlog": w.sortd.backlog(),
                    "steals_in": w.steals_in,
                    "busy_fraction": busy,
                    "sortd": sm,
                }
            return {
                "workers": workers,
                "fleet": {
                    "live_workers": sorted(self._live),
                    "admitted": self._admitted,
                    "completed": self._completed,
                    "failed": self._failed,
                    "rejected": self._rejected,
                    "inflight": self._inflight_total,
                    "steals": self._steals,
                    "failovers": self._failovers,
                    "readmitted": self._readmitted,
                    "fault_scenario": getattr(
                        self._fault_scenario, "name", None
                    ),
                    "latency_ms": {
                        "p50": pct(self._lat_s, 50),
                        "p99": pct(self._lat_s, 99),
                    },
                    "saturation": (
                        sum(busy_fracs) / len(busy_fracs) if busy_fracs else 0.0
                    ),
                    "pad_waste": (
                        pad_cells / (pad_cells + valid_cells)
                        if pad_cells + valid_cells
                        else 0.0
                    ),
                    "uptime_s": uptime,
                },
            }

    def report(self) -> dict:
        """The JSON artifact: metrics + config + chaos vocabulary, in the
        ``net.report`` mold (plain dict, ``write_json`` to persist)."""
        m = self.metrics()
        chaos: "dict | None" = None
        if self.chaos is not None:
            chaos = {
                "name": self.chaos.name,
                "kill_worker_after": self.chaos.kill_worker_after,
                "stall_worker_ms": self.chaos.stall_worker_ms,
                "killed_worker": self._chaos_killed,
                "stalled_worker": self._chaos_stalled,
            }
            if self._chaos_killed is not None:
                # shared vocabulary with the simulator's degraded schedules
                chaos["fault_scenario"] = self.chaos.scenario(
                    self._chaos_killed
                ).name
        return {
            "subsystem": "repro_torch.serve.fleet",
            "config": {
                "workers": self.config.workers,
                "steal_watermark": self.config.steal_watermark,
                "steal_margin": self.config.steal_margin,
                "max_inflight": self.config.max_inflight,
                "heartbeat_interval_s": self.config.heartbeat_interval_s,
                "heartbeat_timeout_s": self.config.heartbeat_timeout_s,
                "idle_flush_s": self.config.worker_config.idle_flush_s,
            },
            "chaos": chaos,
            "faults": self._fault_summary,
            **m,
        }


def write_json(report: dict, path) -> None:
    """Persist a fleet report (CI artifact), ``net.report`` style."""
    import json
    import pathlib

    pathlib.Path(path).write_text(json.dumps(report, indent=1) + "\n")
