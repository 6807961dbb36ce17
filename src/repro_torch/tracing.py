"""The port's spans and counters.

A span marks one layer's part of a request: ``with span("engine.h2d"):``.
It records its name, its host start and end (``time.perf_counter()``
seconds), the span it ran inside (``parent``) and the root span of its
request (``request``, shared by every span of one request), and the
counters that ``count`` added while it was the innermost open span.
``span(..., device=d)`` also times the span's work on the ``torch.device``
``d``: on a CUDA device by a pair of events on the current stream, read
only when :func:`records` is called, so the span adds no wait for the
card; on the CPU by the host clock.

The tracer records only while a ``torch.profiler`` session is open in the
process.  Otherwise a span is one flag read and a shared object that does
nothing, and ``count`` finds no open span.  While it records, every span
also opens ``torch.profiler.record_function(name)``, so a profile taken
with CPU activity shows the spans on the device timeline.

Each thread keeps its own stack of open spans; the kept records are
shared, capped at ``CAP`` (:func:`dropped` counts those past it).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 16


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # this thread's open spans, innermost last


_lock = threading.Lock()
_local = _Local()
_ids = itertools.count(1)
_store: list[dict] = []
_dropped = 0


_OFF = contextlib.nullcontext()  # every span while the tracer is not recording


class _Span:
    def __init__(self, name: str, device):
        self.name = name
        self.device = device
        self.counts: dict = {}

    def __enter__(self):
        stack = _local.stack
        self.id = next(_ids)
        self.parent, self.request = (stack[-1].id, stack[-1].request) if stack else (None, self.id)
        stack.append(self)
        self.fn = _profiler.record_function(self.name)
        self.fn.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record(self.stream)
        self.fn.__exit__(*exc)
        _local.stack.pop()
        host_ms = (t1 - self.t0) * 1e3 if self.device is not None and self.events is None else None
        rec = {"id": self.id, "name": self.name, "request": self.request, "parent": self.parent,
               "t0": self.t0, "t1": t1, "device_ms": host_ms, "counts": self.counts, "_events": self.events}
        global _dropped
        with _lock:
            if len(_store) < CAP:
                _store.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, *, device: "torch.device | None" = None):
    """A context manager marking ``name``; ``device`` is the ``torch.device``
    the span's work runs on, whose time the record then gives as
    ``device_ms``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def recording() -> bool:
    """Whether spans and counters are being kept: a counter that costs
    work to read is read only then."""
    return _profiler._is_profiler_enabled


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of this thread's innermost open span."""
    stack = _local.stack
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def records() -> list[dict]:
    """Every kept span, in the order they ended: ``id``, ``name``,
    ``request``, ``parent`` (an ``id`` or None), ``t0`` and ``t1`` (host
    seconds), ``device_ms`` (None for a span of the host alone) and
    ``counts``.  Waits for the card to pass the spans it times."""
    with _lock:
        for rec in _store:
            events = rec.pop("_events", None)
            if events is not None:
                events[1].synchronize()
                rec["device_ms"] = events[0].elapsed_time(events[1])
        return [dict(rec, counts=dict(rec["counts"])) for rec in _store]


def dropped() -> int:
    """Spans that ended while the store held ``CAP`` records."""
    return _dropped


def clear() -> None:
    """Empty the store and its count of dropped spans."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0
