"""Per-scenario baselines with drift detection (DESIGN.md §7); the port's
copy of ``repro.verify.baseline``, so the two packages' baselines compare
with :func:`diff_baselines`.

A baseline is a JSON document mapping ``scenario_id`` → the *stable*
outcome of that cell: pass/fail status, the executed path/method, the
autotuned capacity, and the overflow-retry count.  Timings are explicitly
excluded — a baseline diff must be empty across machines.

Drift policy: any change — a scenario appearing, disappearing, or any
recorded field flipping (e.g. the capacity model now picks a different
buffer, or a plan policy change reroutes a cell) — fails the conformance
run until someone re-records the baseline with ``python -m
repro_torch.verify --update-baseline``.  Plan-policy changes therefore always show up in
review as a baseline-file diff, never as a silent behavioural flip.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Sequence

SCHEMA_VERSION = 1

# The stable per-scenario fields, in persisted order.
RECORD_FIELDS = ("status", "path", "method", "capacity", "retries")


def result_record(result) -> dict:
    """The baseline-stable projection of a ScenarioResult."""
    return {
        "status": result.status,
        "path": result.path,
        "method": result.method,
        "capacity": result.capacity if result.capacity is None else int(result.capacity),
        "retries": int(result.retries),
    }


def build_baseline(results: Sequence, *, grid: str) -> dict:
    """Results → baseline document (deterministically ordered)."""
    scenarios = {r.scenario_id: result_record(r) for r in results}
    return {
        "schema": SCHEMA_VERSION,
        "grid": grid,
        "scenario_count": len(scenarios),
        "scenarios": {k: scenarios[k] for k in sorted(scenarios)},
    }


def save_baseline(doc: dict, path) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


def load_baseline(path) -> dict:
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"baseline schema {doc.get('schema')!r} != supported {SCHEMA_VERSION}"
        )
    return doc


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Differences between a fresh run and the committed baseline."""

    added: tuple  # scenario_ids present now, absent in baseline
    removed: tuple  # scenario_ids in baseline, absent now
    changed: tuple  # (scenario_id, field, baseline_value, current_value)

    @property
    def clean(self) -> bool:
        return not (self.added or self.removed or self.changed)

    def summary(self) -> str:
        if self.clean:
            return "no drift"
        lines = []
        for sid in self.added:
            lines.append(f"ADDED    {sid}")
        for sid in self.removed:
            lines.append(f"REMOVED  {sid}")
        for sid, field, old, new in self.changed:
            lines.append(f"CHANGED  {sid}: {field} {old!r} -> {new!r}")
        lines.append(
            f"drift: {len(self.added)} added, {len(self.removed)} removed, "
            f"{len(self.changed)} changed"
        )
        return "\n".join(lines)


def diff_baselines(
    current: dict, baseline: dict, *, ignore_missing_in_current: bool = False
) -> DriftReport:
    """Compare a fresh document against the committed baseline.

    ``ignore_missing_in_current=True`` supports subset runs (the tier-1
    pytest slice re-checks only its own cells against the full committed
    smoke baseline).
    """
    cur = current.get("scenarios", {})
    base = baseline.get("scenarios", {})
    added = tuple(sorted(k for k in cur if k not in base))
    removed = (
        ()
        if ignore_missing_in_current
        else tuple(sorted(k for k in base if k not in cur))
    )
    changed = []
    for sid in sorted(set(cur) & set(base)):
        for field in RECORD_FIELDS:
            old, new = base[sid].get(field), cur[sid].get(field)
            if old != new:
                changed.append((sid, field, old, new))
    return DriftReport(added=added, removed=removed, changed=tuple(changed))
