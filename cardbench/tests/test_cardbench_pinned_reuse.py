"""The reader of ``sort.pinned_reuse_pct`` on made-up records: the share of
the pinned bytes the traced requests took that the pool already held, and
silence where the program kept no pinned counter (a program on the CPU, or
one that stages its keys in pageable memory)."""

from __future__ import annotations

from pathlib import Path

import pytest

from cardbench import run as harness

ROOT = Path(__file__).resolve().parents[2]
MiB = 2**20


def reader():
    return harness.load(ROOT / "cardbench" / "metrics" / "sort.pinned_reuse_pct.py", "metric").read


def rec(name, t0_ms, t1_ms, call_start, **counts):
    return {"id": 0, "name": name, "request": 0, "parent": None, "t0": call_start + t0_ms / 1e3,
            "t1": call_start + t1_ms / 1e3, "device_ms": None, "counts": counts}


def ctx():
    """Three traced requests of 10 ms and one untraced."""
    calls = [(100.0 + i, 100.010 + i, 100) for i in range(4)]
    traced = [{"work": 100, "wall_ms": 10.0, "spans": [], "events": []} for _ in range(3)]
    return {"calls": calls, "n_traced": 3, "traced": traced, "busy_s": 0.01, "trace_window_s": 0.03}


def pinned(start, stage_new, answer_new, answer=60 * MiB):
    """One request's records: a 60 MiB key block, an answer block of
    ``answer`` bytes (0 past the ceiling), and what the pool newly made."""
    return [
        rec("engine.stage", 1.0, 2.0, start, **{"engine.pinned_bytes": 60 * MiB,
                                                "engine.pinned_new_bytes": stage_new,
                                                "engine.host_alloc_bytes": stage_new}),
        rec("engine.d2h", 6.0, 7.0, start, **{"engine.pinned_bytes": answer,
                                              "engine.pinned_new_bytes": answer_new,
                                              "engine.host_alloc_bytes": answer_new}),
    ]


@pytest.fixture
def records(monkeypatch):
    from repro_torch import tracing

    def use(recs):
        monkeypatch.setattr(tracing, "records", lambda: [dict(r, counts=dict(r["counts"])) for r in recs])

    return use


@pytest.mark.parametrize("news,want", [
    (((0, 0), (0, 0), (0, 0)), 100.0),
    (((0, 0), (0, 64 * MiB), (0, 0)), 100.0 * (1 - 64 / 360)),  # one kept answer took a new block
    (((64 * MiB, 0), (0, 0), (0, 64 * MiB)), 100.0 * (1 - 128 / 360)),
], ids=("all_reused", "one_new_answer", "first_and_kept"))
def test_share_of_pinned_bytes_reused(records, news, want):
    recs = []
    for i, (stage_new, answer_new) in enumerate(news):
        recs += pinned(100.0 + i, stage_new, answer_new)
    recs += pinned(103.0, 64 * MiB, 64 * MiB)  # the untraced request: no traced call holds it
    records(recs)
    assert reader()(ctx()) == pytest.approx(want)


def test_answers_past_the_ceiling_take_no_block(records):
    recs = pinned(100.0, 0, 0) + pinned(101.0, 0, 0, answer=0) + pinned(102.0, 0, 0, answer=0)
    records(recs)
    assert reader()(ctx()) == pytest.approx(100.0)


def test_silent_without_pinned_counters(records):
    records([])
    assert reader()(ctx()) is None
    pageable = [rec("engine.stage", 1.0, 2.0, 100.0 + i, **{"engine.host_alloc_bytes": 64 * MiB})
                for i in range(3)]
    records(pageable)
    assert reader()(ctx()) is None
    records([r for i in range(3) for r in pinned(100.0 + i, 0, 0)])
    assert reader()(dict(ctx(), n_traced=0, traced=[])) is None
