"""sortd — adaptive micro-batching sort service over ``SortEngine``
(DESIGN.md §8).

The paper's evaluation is many concurrent sorts over one OHHC, and its
related work measures that the *mode of execution* — not the algorithm —
dominates throughput.  sortd is that layer for this repo: callers submit
individual sort requests; a single worker thread coalesces them into
micro-batches and serves each batch with ONE fused device call
(``SortEngine.sort_segments``), so P small requests cost one dispatch, one
transfer, and one warm-cache executable instead of P of each.

Mechanics:

* **Bounded request queue** (``SortdConfig.max_queue``): admission control.
  When full, ``submit`` either raises :class:`QueueFull` immediately or
  blocks (``block_on_full``) — backpressure propagates to producers instead
  of growing an unbounded backlog.
* **Adaptive coalescing**: requests bin by ``(dtype, pow2 shape bucket)`` —
  the same bucketing rule as the engine's warm executor cache
  (``repro_torch.kernels.ops.bucketed_length``), so every flush lands on an
  already-built executor.  Mixed dtypes are never coalesced (a fused
  batch is one device array), and rows only ever pad within their own
  bucket, which bounds per-batch pad waste below 50% + the deadline's
  short-row tail.
* **Max-wait deadline** (``max_wait_s``): a bin flushes when it reaches
  ``max_batch`` rows (reason ``full``) or when its *oldest* request has
  waited the deadline (reason ``deadline``) — latency is bounded even at
  one request per epoch, throughput is batched under load.  The adaptive
  part is exactly this pair: at low arrival rates the deadline dominates
  (batch of 1, latency ≈ max_wait), at high rates ``max_batch`` dominates
  (amortization without waiting).
* **Oversize fallback**: requests longer than ``max_bucket`` never coalesce
  (their pad waste would dominate a batch); they are served inline through
  the engine's own per-array dispatch (``SortEngine.sort`` — which may
  itself pick the host path for huge inputs).
* **Metrics**: per-request latency (p50/p99 over a sliding window) and
  pad-waste per shape bucket, flush-reason counters, queue depth highwater,
  rejected count — ``metrics()`` returns a JSON-ready dict; ``chip_smoke.py``'s
  serving phase reads it.

Threading contract: any number of producer threads may call ``submit``;
all engine/device work happens on the single worker thread, so the executor
cache and ``last_report`` see strictly serial traffic.

Fleet hooks (DESIGN.md §10): ``repro_torch.serve.fleet`` runs N of these
workers behind one admission layer, which needs three seams this module
owns:

* **Idle flush** (``SortdConfig.idle_flush_s``): the coalescing deadline
  (``max_wait_s``) buys batch size only while traffic is still arriving;
  when the request queue is *empty* — every producer is blocked on a
  Future — waiting out the full deadline is pure idle time (measured:
  30–50% of wall under closed-loop load).  With ``idle_flush_s`` set, a
  bin whose oldest request has waited that long flushes early (reason
  ``idle``) whenever the queue is empty; under sustained arrival the
  queue is non-empty and the full ``max_wait_s`` still governs.  Off
  (``None``) by default — standalone sortd behavior is unchanged.
* **Tick hooks** (``add_tick_hook``): callbacks run on the worker thread
  once per loop iteration and after every flush — the fleet's heartbeat
  (and chaos stall-injection) point.  ``tick_interval_s`` caps the idle
  queue wait so a traffic-less worker still ticks.
* **Crash simulation** (``kill()``): the worker thread aborts at its next
  tick *without* draining or flushing — queued requests are left as
  dangling futures, exactly what a real worker crash does.  The fleet's
  health checker detects the dead thread and re-admits the backlog from
  its own bookkeeping (:class:`WorkerKilled` is the internal control
  exception).  ``close()`` after a kill still joins cleanly; only the
  fleet layer guarantees the orphaned work is served.

The port's copy of ``repro.serve.sortd``: the same logic and arithmetic, with
its imports pointed at ``repro_torch``.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.core import workloads
from repro_torch.core.engine import SortEngine
from repro_torch.kernels import ops

__all__ = ["Sortd", "SortdConfig", "QueueFull", "WorkerKilled", "affinity_key"]


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the bounded queue is at capacity."""


class WorkerKilled(BaseException):
    """Control exception aborting the worker thread on ``kill()``.

    Derives from ``BaseException`` so the per-flush ``except Exception``
    guards can never swallow a chaos kill into a batch failure.
    """


def affinity_key(arr: np.ndarray) -> "tuple[str, int]":
    """The ``(dtype, pow2 shape bucket)`` coalescing/affinity key.

    One rule shared by the sortd bins, the engine's warm executor cache, and
    the fleet's affinity router — same key ⇒ same bin ⇒ same cached
    executor ⇒ (in a fleet) same worker.
    """
    return (str(arr.dtype), ops.bucketed_length(max(arr.size, 1)))


@dataclasses.dataclass(frozen=True)
class SortdConfig:
    """Tuning knobs for the micro-batching service.

    max_queue:      bounded request queue length (backpressure boundary).
    max_batch:      flush a bin when it holds this many rows.
    max_wait_s:     flush a bin when its oldest row has waited this long.
    max_bucket:     largest coalescible shape bucket; longer requests take
                    the direct per-array engine path.
    block_on_full:  submit blocks (True) or raises QueueFull (False).
    latency_window: per-bucket sliding-window size for the percentiles.
    idle_flush_s:   with the request queue EMPTY, flush a bin once its
                    oldest row has waited this long (reason ``idle``) —
                    waiting out max_wait_s with no traffic arriving is
                    pure idle time.  None (default) disables; must be
                    < max_wait_s to have any effect.
    tick_interval_s: upper bound on the idle queue wait so tick hooks
                    (fleet heartbeats) keep firing with no traffic.
                    None (default) lets an idle worker sleep until the
                    next request.
    """

    max_queue: int = 1024
    max_batch: int = 64
    max_wait_s: float = 0.005
    max_bucket: int = 1 << 15
    block_on_full: bool = False
    latency_window: int = 4096
    idle_flush_s: "float | None" = None
    tick_interval_s: "float | None" = None


@dataclasses.dataclass
class _Pending:
    keys: np.ndarray
    t_enqueue: float
    future: Future
    # Workload tag (DESIGN.md §12): "sort" coalesces as before; "merge"
    # carries the caller's already-sorted buffer and bins under its own
    # op-prefixed key, so merge and sort traffic on the same
    # (dtype, bucket) never share a batch.
    op: str = "sort"
    buf: "np.ndarray | None" = None


class _Stop:
    pass


class _Nudge:
    """Queue no-op: wakes the worker loop (kill/tick) without carrying work."""


_STOP = _Stop()
_NUDGE = _Nudge()


class _BucketStats:
    __slots__ = (
        "requests", "batches", "rows", "pad_cells", "valid_cells", "lat_s",
        "methods",
    )

    def __init__(self, window: int):
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.pad_cells = 0
        self.valid_cells = 0
        self.lat_s = collections.deque(maxlen=window)
        # flush count per executed plan method (e.g. bitonic vs
        # bitonic_pallas vs bitonic2op) — names the kernel the engine's
        # row-backend autotune actually ran for this bucket's traffic
        self.methods: dict[str, int] = {}


class Sortd:
    """The service.  Use as a context manager or call ``close()`` yourself.

    >>> with Sortd(SortEngine()) as sd:
    ...     fut = sd.submit(np.array([3, 1, 2], np.int32))
    ...     fut.result()
    array([1, 2, 3], dtype=int32)
    """

    def __init__(
        self,
        engine: SortEngine | None = None,
        config: SortdConfig | None = None,
        *,
        start: bool = True,
    ):
        self.engine = engine if engine is not None else SortEngine()
        self.config = config if config is not None else SortdConfig()
        self._queue: queue.Queue = queue.Queue(maxsize=self.config.max_queue)
        self._bins: dict[tuple[str, int], list[_Pending]] = {}
        self._lock = threading.Lock()  # guards metrics only
        # Serializes the closed-check-then-enqueue in submit() against
        # close(): without it a racing submit can enqueue after the worker
        # drained and exited, leaving a Future that never resolves.
        self._close_lock = threading.Lock()
        self._closed = False
        self._killed = False
        self._binned = 0  # rows currently sitting in bins (worker thread)
        self._thread: threading.Thread | None = None
        self._tick_hooks: list = []
        self._t_start = time.monotonic()
        self._busy_s = 0.0  # worker-thread cumulative flush/serve time
        # metrics (under _lock)
        self._completed = 0
        self._oversize_direct = 0
        self._rejected = 0
        self._failed = 0
        self._fault_name: "str | None" = None
        self._degraded_flushes = 0  # flushes served under an active fault
        self._flushes = {"full": 0, "deadline": 0, "idle": 0, "close": 0}
        self._max_queue_depth = 0
        self._buckets: dict[str, _BucketStats] = {}
        self._all_lat_s: collections.deque = collections.deque(
            maxlen=self.config.latency_window
        )
        if start:
            self.start()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "Sortd":
        """Start the worker thread (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="sortd-worker", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop accepting requests, flush everything queued, join the worker.

        Drain guarantee: every request whose ``submit`` returned before
        ``close`` was called gets served — its Future resolves — before
        ``close`` returns (the fleet's failover re-admission leans on this
        invariant).  The single exception is a worker aborted by ``kill()``
        (chaos crash simulation): its backlog is intentionally left
        dangling, and only the fleet layer re-admits it.
        """
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            # Under the close lock: every submit that passed its closed-check
            # has already enqueued, so its item sits before this sentinel and
            # the worker's final drain serves it.  The put must not block
            # forever on a full queue whose worker crashed — poll liveness.
            if self._thread is not None:
                while True:
                    try:
                        self._queue.put(_STOP, timeout=0.1)
                        break
                    except queue.Full:
                        if not self._thread.is_alive():
                            break  # crashed worker: nobody will drain
        if self._thread is None:
            # never started: serve the backlog inline so no future dangles
            self._drain_queue()
            self._flush_all("close")
            return
        self._thread.join()
        self._thread = None

    def kill(self) -> None:
        """Chaos hook: simulate a worker crash (DESIGN.md §10).

        The worker thread aborts at its next tick WITHOUT flushing — all
        queued/binned requests are left as dangling futures, exactly like a
        real crash.  Safe to call from any thread; idempotent.
        """
        self._killed = True
        try:
            self._queue.put_nowait(_NUDGE)  # wake a blocked worker now
        except queue.Full:
            pass  # a full queue wakes the worker anyway

    def add_tick_hook(self, fn) -> None:
        """Register ``fn()`` to run on the worker thread each loop iteration
        and after every flush — the fleet heartbeat/chaos-injection seam."""
        self._tick_hooks.append(fn)

    def set_fault_scenario(self, scenario) -> None:
        """Serve under a degraded topology (DESIGN.md §11).

        Forwards a ``net.faults.FaultScenario`` (or ``None`` to heal) to
        the engine, whose fallback ladder does the actual work: flushes
        re-price their plans over the degraded schedule, and a scenario
        that makes the gather impossible reroutes every flush onto the
        healthy host path instead of erroring — callers see correct
        results either way, ``metrics()`` sees which scenario is live and
        how many flushes it degraded.  Safe from any thread: the engine
        reads the scenario once per plan, on the worker thread.
        """
        self.engine.set_fault_scenario(scenario)
        with self._lock:
            self._fault_name = (
                scenario.name
                if scenario is not None and getattr(scenario, "is_degraded", False)
                else None
            )

    def backlog(self) -> int:
        """Requests accepted but not yet served (queued + binned).

        Approximate under concurrency — good enough for the fleet's
        steal/health heuristics, never used for correctness.
        """
        return self._queue.qsize() + self._binned

    @property
    def worker_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "Sortd":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- submission
    def submit(self, keys) -> Future:
        """Enqueue one sort request; the Future resolves to the sorted array.

        Raises :class:`QueueFull` when the bounded queue is at capacity and
        ``block_on_full`` is off; blocks otherwise.  Raises RuntimeError
        after ``close()``.
        """
        arr = np.asarray(keys).ravel()
        return self._enqueue(_Pending(arr, time.monotonic(), Future()))

    def submit_merge(self, sorted_buf, new_keys) -> Future:
        """Enqueue an incremental merge; resolves to the merged array.

        The streaming workload (DESIGN.md §12): ``new_keys`` coalesces
        with other merge increments of the same (dtype, shape bucket) —
        one fused ``sort_segments`` call sorts every batch's increments —
        and each result then folds into its caller's ``sorted_buf`` with
        the O(n+m) gather.  Merge bins carry their own op-prefixed
        coalescing key, so they never share a batch with plain sort
        requests on the same (dtype, bucket).  The buffer is validated
        ascending at serve time; a bad buffer fails only its own future.
        """
        buf = np.asarray(sorted_buf).ravel()
        new = np.asarray(new_keys).ravel()
        if buf.dtype != new.dtype:
            raise ValueError(
                f"merge: dtype mismatch — buffer {buf.dtype} "
                f"vs new keys {new.dtype}"
            )
        return self._enqueue(
            _Pending(new, time.monotonic(), Future(), op="merge", buf=buf)
        )

    def merge(self, sorted_buf, new_keys, timeout: float | None = 60.0) -> np.ndarray:
        """Synchronous wrapper: ``submit_merge(...).result()``."""
        return self.submit_merge(sorted_buf, new_keys).result(timeout=timeout)

    def _enqueue(self, item: _Pending) -> Future:
        with self._close_lock:
            if self._closed:
                raise RuntimeError("sortd is closed")
            try:
                self._queue.put(item, block=self.config.block_on_full)
            except queue.Full:
                with self._lock:
                    self._rejected += 1
                raise QueueFull(
                    f"sortd queue at capacity ({self.config.max_queue})"
                ) from None
        with self._lock:
            self._max_queue_depth = max(self._max_queue_depth, self._queue.qsize())
        return item.future

    def sort(self, keys, timeout: float | None = 60.0) -> np.ndarray:
        """Synchronous convenience wrapper: ``submit(keys).result()``."""
        return self.submit(keys).result(timeout=timeout)

    # -------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """JSON-ready snapshot: latency percentiles + pad waste per bucket."""

        def pct(d, q):
            return float(np.percentile(np.asarray(d), q)) * 1e3 if d else 0.0

        with self._lock:
            buckets = {}
            for key, b in self._buckets.items():
                total_cells = b.pad_cells + b.valid_cells
                buckets[key] = {
                    "requests": b.requests,
                    "batches": b.batches,
                    "mean_batch": b.rows / b.batches if b.batches else 0.0,
                    "p50_ms": pct(b.lat_s, 50),
                    "p99_ms": pct(b.lat_s, 99),
                    "pad_waste": b.pad_cells / total_cells if total_cells else 0.0,
                    "methods": dict(b.methods),
                }
            return {
                "completed": self._completed,
                "failed": self._failed,
                "oversize_direct": self._oversize_direct,
                "rejected": self._rejected,
                "fault_scenario": self._fault_name,
                "degraded_flushes": self._degraded_flushes,
                "flushes": dict(self._flushes),
                "queue_depth": self._queue.qsize(),
                "max_queue_depth": self._max_queue_depth,
                "busy_s": self._busy_s,
                "uptime_s": time.monotonic() - self._t_start,
                "latency_ms": {
                    "p50": pct(self._all_lat_s, 50),
                    "p99": pct(self._all_lat_s, 99),
                },
                "buckets": buckets,
            }

    # ------------------------------------------------------------- worker
    def _bin_key(self, item: _Pending) -> tuple[str, str, int]:
        # op-prefixed: "merge" increments never coalesce with "sort"
        # requests of the same (dtype, bucket) — batches stay homogeneous
        return (item.op,) + affinity_key(item.keys)

    def _beat(self) -> None:
        for fn in self._tick_hooks:
            fn()

    def _tick(self) -> None:
        self._beat()
        if self._killed:
            raise WorkerKilled("chaos kill")

    def _wait_budget(self) -> float:
        """How long the oldest binned request may wait before a flush.

        ``max_wait_s`` while traffic is arriving; the (shorter)
        ``idle_flush_s`` once the queue is empty — every producer is then
        blocked on a Future and further waiting buys no batch size.
        """
        cfg = self.config
        if (
            cfg.idle_flush_s is not None
            and cfg.idle_flush_s < cfg.max_wait_s
            and self._queue.qsize() == 0
        ):
            return cfg.idle_flush_s
        return cfg.max_wait_s

    def _next_deadline(self) -> float | None:
        if not self._bins:
            return None
        oldest = min(batch[0].t_enqueue for batch in self._bins.values())
        return oldest + self._wait_budget()

    def _run(self) -> None:
        try:
            self._run_loop()
        except WorkerKilled:
            return  # simulated crash: exit without draining or flushing

    def _run_loop(self) -> None:
        while True:
            self._tick()
            deadline = self._next_deadline()
            timeout = (
                max(0.0, deadline - time.monotonic()) if deadline is not None else None
            )
            tick_s = self.config.tick_interval_s
            if tick_s is not None:
                timeout = tick_s if timeout is None else min(timeout, tick_s)
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                item = None
            stop = isinstance(item, _Stop)
            if item is not None and not stop and not isinstance(item, _Nudge):
                self._route(item)
            if not stop:
                # Greedy drain: coalesce the backlog before looking at
                # deadlines.  Without this, a backlog built up during a long
                # flush arrives one item per wakeup with its deadline already
                # expired — every flush degenerates to batch size 1 exactly
                # when the server is overloaded (the anti-batching death
                # spiral).  _route flushes any bin that reaches max_batch.
                # The drain is BUDGETED at max_queue items: producers with
                # block_on_full refill the queue as fast as it drains, and an
                # unbounded drain would then starve a lone expired request in
                # a cold (dtype, bucket) bin forever — the budget caps the
                # wait at one backlog's worth of routing before deadlines are
                # honored again.  (Breaking out as soon as any deadline has
                # expired is wrong the other way: a burst that arrives during
                # a flush is entirely past its deadline, and per-item breaks
                # would flush it one request at a time.)
                budget = max(self.config.max_queue, 1)
                while budget > 0:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(nxt, _Stop):
                        stop = True
                        break
                    if isinstance(nxt, _Nudge):
                        continue
                    self._route(nxt)
                    budget -= 1
            if stop:
                self._drain_queue()
                self._flush_all("close")
                return
            self._flush_expired()

    def _drain_queue(self) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if not isinstance(item, (_Stop, _Nudge)):
                self._route(item)

    def _route(self, item: _Pending) -> None:
        if item.keys.size > self.config.max_bucket:
            self._serve_direct(item)
            return
        key = self._bin_key(item)
        self._bins.setdefault(key, []).append(item)
        self._binned += 1
        if len(self._bins[key]) >= self.config.max_batch:
            self._flush(key, "full")

    def _flush_expired(self) -> None:
        now = time.monotonic()
        budget = self._wait_budget()
        for key in [
            k
            for k, batch in self._bins.items()
            if now - batch[0].t_enqueue >= budget
        ]:
            waited = now - self._bins[key][0].t_enqueue
            reason = "deadline" if waited >= self.config.max_wait_s else "idle"
            self._flush(key, reason)

    def _flush_all(self, reason: str) -> None:
        for key in list(self._bins):
            self._flush(key, reason)

    def _flush(self, key: tuple[str, str, int], reason: str) -> None:
        batch = self._bins.pop(key)
        self._binned -= len(batch)
        t_busy0 = time.monotonic()
        op, dtype_str, bucket = key
        lens = [p.keys.size for p in batch]
        try:
            flat = (
                np.concatenate([p.keys for p in batch])
                if len(batch) > 1
                else batch[0].keys
            )
            outs = self.engine.sort_segments(flat, lens)
            plan = (self.engine.last_report or {}).get("plan")
            method = getattr(plan, "method", None) or "?"
            fault = getattr(plan, "fault", None)
        except Exception as e:  # one bad batch must not kill its siblings' futures
            self._busy_s += time.monotonic() - t_busy0
            with self._lock:
                self._failed += len(batch)
            for p in batch:
                p.future.set_exception(e)
            return
        errs: "list[Exception | None]" = [None] * len(batch)
        if op == "merge":
            # Merge batch (DESIGN.md §12): the fused call above sorted
            # every increment; fold each into its caller's buffer with the
            # O(n+m) gather.  check=True validates the buffer ascending —
            # a bad buffer fails only ITS future, never its batch-mates'.
            merged: list = []
            for i, (p, out) in enumerate(zip(batch, outs)):
                try:
                    merged.append(
                        workloads.merge_sorted_arrays(
                            p.buf, np.asarray(out), check=True
                        )
                    )
                except Exception as e:
                    merged.append(None)
                    errs[i] = e
            outs = merged
        done = time.monotonic()
        self._busy_s += done - t_busy0
        lats = [done - p.t_enqueue for p in batch]
        n_err = sum(1 for e in errs if e is not None)
        # Account BEFORE resolving: a caller that wakes on the last future
        # and immediately reads metrics() must see these requests counted.
        with self._lock:
            self._flushes[reason] += 1
            if fault is not None:
                self._degraded_flushes += 1
            self._completed += len(batch) - n_err
            self._failed += n_err
            self._all_lat_s.extend(lats)
            label = (
                f"{dtype_str}/{bucket}"
                if op == "sort"
                else f"{op}/{dtype_str}/{bucket}"
            )
            b = self._bucket_stats(label)
            b.requests += len(batch)
            b.batches += 1
            b.rows += len(batch)
            b.valid_cells += int(sum(lens))
            b.pad_cells += len(batch) * bucket - int(sum(lens))
            b.lat_s.extend(lats)
            b.methods[method] = b.methods.get(method, 0) + 1
        for p, out, err in zip(batch, outs, errs):
            if err is not None:
                p.future.set_exception(err)
            else:
                p.future.set_result(out)
        self._beat()  # heartbeat between flushes of a long backlog

    def _serve_direct(self, item: _Pending) -> None:
        t_busy0 = time.monotonic()
        try:
            if item.op == "merge":
                out = self.engine.merge_sorted(item.buf, item.keys)
            else:
                out = self.engine.sort(item.keys)
        except Exception as e:
            self._busy_s += time.monotonic() - t_busy0
            with self._lock:
                self._failed += 1
            item.future.set_exception(e)
            return
        done = time.monotonic()
        self._busy_s += done - t_busy0
        lat = done - item.t_enqueue
        label = (
            f"{item.keys.dtype}/direct"
            if item.op == "sort"
            else f"{item.op}/{item.keys.dtype}/direct"
        )
        with self._lock:  # account before resolving (see _flush)
            self._oversize_direct += 1
            self._completed += 1
            self._all_lat_s.append(lat)
            b = self._bucket_stats(label)
            b.requests += 1
            b.batches += 1
            b.rows += 1
            b.valid_cells += item.keys.size
            b.lat_s.append(lat)
        item.future.set_result(out)
        self._beat()

    def _bucket_stats(self, key: str) -> _BucketStats:
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = _BucketStats(self.config.latency_window)
        return b
