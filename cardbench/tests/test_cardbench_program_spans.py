"""``cardbench/program_spans.py`` and the five readers of the program's
spans and counters, on a made-up context and made-up records: each record
goes to the traced call whose host window holds it, in that call's ms;
idle device time is put down to the innermost span open at the time; and
every reader is silent where the program kept no record.

With a card, ``-m cuda`` runs the sort cell and the 2 x 4,096 training
cell at their own sizes, traced, and holds the spans to the device trace:
each request's big host-to-card copy starts inside ``engine.h2d`` and its
big card-to-host copy inside ``engine.d2h``; under a tenth of a request's
idle device time lies outside every program span; and a step's three
phases sum to within 5 % of its busy device time.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest
import torch

from cardbench import program_spans
from cardbench import run as harness

ROOT = Path(__file__).resolve().parents[2]
NEW = ("sort.stage_ms", "sort.host_alloc_mib", "train.forward_ms", "train.backward_ms", "train.optimizer_ms")
MiB = 2**20


def reader(name):
    return harness.load(ROOT / "cardbench" / "metrics" / f"{name}.py", "metric").read


def rec(name, t0_ms, t1_ms, call_start=100.0, device_ms=None, **counts):
    """A record of the program's, its times given in ms from ``call_start`` (s)."""
    return {"id": 0, "name": name, "request": 0, "parent": None, "t0": call_start + t0_ms / 1e3,
            "t1": call_start + t1_ms / 1e3, "device_ms": device_ms, "counts": counts}


def sort_ctx():
    """Two traced requests of 10 ms and one untraced.  Each: an H2D copy at
    2-4 ms, a kernel at 5-6 ms, a D2H copy at 6-9 ms; the card idle 0-2,
    4-5 and 9-10 ms."""
    events = [("Memcpy HtoD (Pageable -> Device)", 2.0, 2.0), ("sort_kernel", 5.0, 1.0),
              ("Memcpy DtoH (Device -> Pageable)", 6.0, 3.0)]
    traced = [{"work": 100, "wall_ms": 10.0, "spans": [], "events": list(events)} for _ in range(2)]
    return {"calls": [(100.0, 100.010, 100), (101.0, 101.010, 100), (102.0, 102.010, 100)], "n_traced": 2,
            "traced": traced, "busy_s": 0.012, "trace_window_s": 0.020}


def sort_records():
    out = []
    for start in (100.0, 101.0):
        out += [
            rec("engine.stats", 0.1, 0.5, start),
            rec("engine.sort", 0.6, 9.8, start),
            rec("engine.stage", 0.7, 1.9 if start == 100.0 else 2.1, start, **{"engine.host_alloc_bytes": 64 * MiB}),
            rec("engine.h2d", 1.9, 4.1, start),
            rec("engine.device_sort", 4.1, 6.0, start),
            rec("engine.d2h", 6.0, 9.1, start, **{"engine.host_alloc_bytes": 60 * MiB}),
        ]
    out.append(rec("engine.sort", 0.0, 9.0, 102.0))  # an untraced request: no traced call holds it
    out.append(rec("engine.sort", -5.0, 1.0, 100.0))  # begins before the first call
    return out


def train_ctx():
    traced = [{"work": 8192, "wall_ms": 700.0, "spans": [], "events": [("gemm", 1.0, 690.0)]} for _ in range(2)]
    return {"calls": [(10.0, 10.7, 8192), (11.0, 11.7, 8192)], "n_traced": 2, "traced": traced,
            "busy_s": 1.38, "trace_window_s": 1.4}


def train_records():
    out = []
    for start, f in ((10.0, 120.0), (11.0, 140.0)):
        out += [rec("train.step", 0.5, 699.0, start, device_ms=690.0),
                rec("train.forward", 0.6, 100.0, start, device_ms=f),
                rec("train.backward", 100.0, 300.0, start, device_ms=420.0),
                rec("train.optimizer", 300.0, 698.0, start, device_ms=130.0)]
    return out


@pytest.fixture
def records(monkeypatch):
    from repro_torch import tracing

    def use(recs):
        monkeypatch.setattr(tracing, "records", lambda: [dict(r, counts=dict(r["counts"])) for r in recs])

    return use


def test_records_go_to_the_call_that_holds_them(records):
    records(sort_records())
    calls = program_spans.per_call(sort_ctx())
    assert [len(c) for c in calls] == [6, 6]
    first = {r["name"]: r for r in calls[0]}
    assert first["engine.h2d"]["t0"] == pytest.approx(1.9) and first["engine.h2d"]["t1"] == pytest.approx(4.1)
    assert {r["name"]: r for r in calls[1]}["engine.stage"]["t1"] == pytest.approx(2.1)


def test_spans_and_counters_by_call(records):
    records(sort_records())
    ctx = sort_ctx()
    assert program_spans.span_ms(ctx, "engine.stage") == pytest.approx((1.2 + 1.4) / 2)
    assert program_spans.counter(ctx, "engine.host_alloc_bytes") == [124 * MiB, 124 * MiB]
    assert program_spans.span_ms(ctx, "engine.unmap") is None
    assert program_spans.counter(ctx, "engine.unknown") is None


def test_idle_by_innermost_span(records):
    records(sort_records())
    by_span = program_spans.idle_by_span(sort_ctx())
    # idle 0-2: 0-0.1 none, 0.1-0.5 stats, 0.5-0.6 none, 0.6-0.7 sort, then stage to 1.9 (2.1 in
    # the second call, past the idle's end at 2.0), then h2d; idle 4-5: h2d to 4.1, then the
    # device sort; idle 9-10: d2h to 9.1, sort to 9.8, none to 10
    assert by_span == pytest.approx({
        "": (0.1 + 0.1 + 0.2 + 0.1 + 0.1 + 0.2) / 2,
        "engine.stats": 0.4, "engine.sort": 0.1 + 0.7,
        "engine.stage": (1.2 + 1.3) / 2, "engine.h2d": (0.1 + 0.1 + 0.1) / 2,
        "engine.device_sort": 0.9, "engine.d2h": 0.1,
    })
    assert sum(by_span.values()) == pytest.approx(4.0)  # the idle ms of a request


def test_the_five_readers(records):
    records(sort_records())
    ctx = sort_ctx()
    assert reader("sort.stage_ms")(ctx) == pytest.approx(1.3)
    assert reader("sort.host_alloc_mib")(ctx) == pytest.approx(124.0)
    records(train_records())
    ctx = train_ctx()
    assert reader("train.forward_ms")(ctx) == pytest.approx(130.0)
    assert reader("train.backward_ms")(ctx) == pytest.approx(420.0)
    assert reader("train.optimizer_ms")(ctx) == pytest.approx(130.0)
    assert reader("sort.stage_ms")(ctx) is None


def test_silent_without_records(records, monkeypatch):
    for ctx in (sort_ctx(), train_ctx()):
        records([])
        assert all(reader(name)(ctx) is None for name in NEW)
        records(sort_records() + train_records())
        untraced = dict(ctx, n_traced=0, traced=[], busy_s=None, trace_window_s=None)
        assert all(reader(name)(untraced) is None for name in NEW)
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing")  # a program without the tracer
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    records_gone = sort_ctx()
    assert program_spans.per_call(records_gone) is None
    assert all(reader(name)(records_gone) is None for name in NEW)


def test_idle_needs_the_device_trace(records):
    records(sort_records())
    ctx = dict(sort_ctx(), busy_s=None)
    assert program_spans.idle_by_span(ctx) is None
    assert reader("sort.host_alloc_mib")(ctx) == pytest.approx(124.0)


def _traced_ctx(monkeypatch, workload, seed):
    """A traced run of ``workload`` at its own size on the card, a short
    window: the context its metrics were read from."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seen = {}
    real = harness.load

    def load(path, tag):
        mod = real(path, tag)
        if tag != "metric":
            return mod
        return types.SimpleNamespace(read=lambda ctx: seen.setdefault("ctx", ctx) and mod.read(ctx))

    monkeypatch.setattr(harness, "load", load)
    out = harness.run(harness.cell(ROOT, workload), seed, 3.0, True, torch.device("cuda"))
    assert out["correct"] and "ctx" in seen, out
    ctx = seen["ctx"]
    assert ctx.get("busy_s") is not None and len(ctx["traced"]) == ctx["traffic"]["trace_calls"]
    return ctx


def _start_of_largest(events, prefix):
    return max((e for e in events if e[0].startswith(prefix)), key=lambda e: e[2])[1]


@pytest.mark.cuda
def test_sort_spans_hold_the_copies_and_the_idle_on_the_card(monkeypatch):
    ctx = _traced_ctx(monkeypatch, "sort.ohhc-dh1.random-60mb", 2_147_489_001)
    calls = program_spans.per_call(ctx)
    for rec, recs in zip(ctx["traced"], calls):
        spans = {r["name"]: r for r in recs}
        for span, prefix in (("engine.h2d", "Memcpy HtoD"), ("engine.d2h", "Memcpy DtoH")):
            start = _start_of_largest(rec["events"], prefix)
            assert spans[span]["t0"] - 0.5 <= start <= spans[span]["t1"] + 0.5, (span, start, spans[span])
    by_span = program_spans.idle_by_span(ctx)
    print({"idle_by_span": by_span})
    assert by_span.get("", 0.0) < 0.1 * sum(by_span.values()), by_span


@pytest.mark.cuda
def test_train_phases_cover_the_step_on_the_card(monkeypatch):
    ctx = _traced_ctx(monkeypatch, "train.dsv2-lite-4l.2x4k", 2_147_489_101)
    phases = ("train.forward", "train.backward", "train.optimizer")
    for rec, recs in zip(ctx["traced"], program_spans.per_call(ctx)):
        busy_ms = harness.busy([rec])[0] * 1e3
        summed = sum(r["device_ms"] for r in recs if r["name"] in phases)
        print({"phases_ms": summed, "busy_ms": busy_ms})
        assert summed == pytest.approx(busy_ms, rel=0.05)
