"""Arithmetic the metric readers share: rates and tails over the window's
calls, and device time by name over the traced calls."""

from __future__ import annotations

import statistics


def rate(ctx: dict) -> float:
    """Work of every call of the window over the window's seconds."""
    return sum(w for _, _, w in ctx["calls"]) / ctx["window_s"]


def tail_ms(ctx: dict, pct: int) -> "float | None":
    """The ``pct``-th percentile of the window's call times, in ms."""
    lat = [(b - a) * 1e3 for a, b, _ in ctx["calls"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[pct - 1]


def device_ms(ctx: dict, match) -> "list[float] | None":
    """Device ms a traced call of the events whose name ``match`` accepts;
    None without a trace."""
    if ctx.get("busy_s") is None:
        return None
    return [sum(ms for name, _, ms in rec["events"] if match(name)) for rec in ctx["traced"]]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy HtoD") or name.startswith("Memcpy DtoH")


def idle_pct(ctx: dict) -> "float | None":
    if not ctx.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])


def span_ms(ctx: dict, span: str) -> "float | None":
    """Mean ms a traced call spent in the benchmark's span ``span``."""
    per = [sum(b - a for n, a, b in rec["spans"] if n == span) for rec in ctx["traced"]]
    return statistics.fmean(per) if per and any(per) else None
