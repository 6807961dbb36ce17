"""The program's own spans and counters (``repro_torch.tracing``) in the
frame of the traced calls.

The tracer records while the profiler is open, which is over exactly the
traced calls.  Each record goes to the traced call whose host window
(``ctx["calls"]``) holds it, its times moved to ms from the call's start:
the frame the call's device events are given in.  Every function returns
None where the program kept no record, as a program without the tracer
does, or a run on the CPU, where no profiler opens.
"""

from __future__ import annotations

import statistics


def per_call(ctx: dict) -> "list[list[dict]] | None":
    """Each traced call's records, ``t0``/``t1`` in ms from the call's start."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    windows = ctx["calls"][: ctx["n_traced"]]
    out: list[list[dict]] = [[] for _ in windows]
    for rec in tracing.records():
        for i, (a, b, _) in enumerate(windows):
            if a <= rec["t0"] and rec["t1"] <= b:
                out[i].append(dict(rec, t0=(rec["t0"] - a) * 1e3, t1=(rec["t1"] - a) * 1e3))
                break
    return out if any(out) else None


def span_ms(ctx: dict, name: str, device: bool = False) -> "float | None":
    """Mean ms a traced call spent in the spans ``name``: their device time
    with ``device``, else their host time."""
    calls = per_call(ctx)
    if calls is None or not any(r["name"] == name for recs in calls for r in recs):
        return None
    if device:
        return statistics.fmean(sum(r["device_ms"] for r in recs if r["name"] == name) for recs in calls)
    return statistics.fmean(sum(r["t1"] - r["t0"] for r in recs if r["name"] == name) for recs in calls)


def counter(ctx: dict, name: str) -> "list[int] | None":
    """The counter ``name`` summed over each traced call's spans."""
    calls = per_call(ctx)
    if calls is None or not any(name in r["counts"] for recs in calls for r in recs):
        return None
    return [sum(r["counts"].get(name, 0) for r in recs) for recs in calls]


def _idle(rec: dict) -> list[tuple[float, float]]:
    """The intervals of a traced call in which no device operation ran."""
    gaps, end = [], 0.0
    for _, s, ms in sorted(rec["events"], key=lambda e: e[1]) + [("end", rec["wall_ms"], 0.0)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, s + ms)
    return gaps


def idle_by_span(ctx: dict) -> "dict[str, float] | None":
    """Mean device-idle ms a traced call, by the innermost program span open
    at the time (``""`` where none was)."""
    calls = per_call(ctx)
    if calls is None or ctx.get("busy_s") is None:
        return None
    out: dict[str, float] = {}
    for rec, recs in zip(ctx["traced"], calls):
        for a, b in _idle(rec):
            cuts = sorted({a, b} | {t for r in recs for t in (r["t0"], r["t1"]) if a < t < b})
            for lo, hi in zip(cuts, cuts[1:]):
                mid = (lo + hi) / 2
                inside = [r for r in recs if r["t0"] <= mid <= r["t1"]]
                name = min(inside, key=lambda r: r["t1"] - r["t0"])["name"] if inside else ""
                out[name] = out.get(name, 0.0) + (hi - lo)
    return {k: v / len(calls) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}
