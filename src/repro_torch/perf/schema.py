"""Perf-case schema and the committed ``BENCH_<suite>.json`` documents
(DESIGN.md §9).

The port's copy of ``repro.perf.schema``: the same ``SCHEMA_VERSION``,
``TRAJECTORY_KEEP`` and JSON layout, so a file either package writes loads
in the other.  Mirrors ``repro_torch.verify.baseline``: a baseline is a
JSON document mapping ``case_id`` → the reference outcome of that case,
committed under ``src/repro_torch/perf/baselines/`` (recorded on the
card), and every change lands as a reviewable file diff via ``python -m
repro_torch.perf --update-baseline`` — never as a silent drift.  Unlike verify's baselines, the recorded value here is a *number*
(the machine-normalized ratio, see ``repro_torch.perf.normalize``) with an
asymmetric tolerance band around it, ReFrame-reference style:
``(reference, -lower, +upper)`` → fail above ``ref·(1+upper)``, warn below
``ref·(1-lower)``.

Also home of the benchmark CSV row contract (``name,us_per_call,derived``)
that the reference's ``tests/test_bench_smoke.py`` validates for every
suite (the port keeps the same contract).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Callable, Sequence

from repro_torch.perf.normalize import Workload

SCHEMA_VERSION = 1

# Default asymmetric tolerance band on the normalized ratio: fail beyond
# +75% regression, warn beyond -50% "improvement" (a number that good
# usually means the measurement broke or the baseline is stale).
DEFAULT_LOWER = 0.50
DEFAULT_UPPER = 0.75

# How many --update-baseline recordings the trajectory keeps.
TRAJECTORY_KEEP = 20


@dataclasses.dataclass(frozen=True)
class PerfCase:
    """One gated perf scenario: what to run, its work model, its band.

    ``setup`` returns a zero-arg callable measured under the
    ``repro_torch.perf.measure`` contract (warmup → sync → median-of-k);
    inputs, kernel builds and one untimed call happen inside ``setup``,
    never inside the timed call.  A callable with a ``close`` attribute
    (a live service) is closed once the case is measured.
    ``workload=None`` opts the case out of roofline normalization (raw
    seconds, machine-local — see ``repro_torch.perf.normalize``).
    """

    suite: str
    key: str
    setup: "Callable[[], Callable[[], object]]"
    workload: "Workload | None"
    metric: str = "time"
    units: str = "s"
    lower: float = DEFAULT_LOWER
    upper: float = DEFAULT_UPPER
    smoke: bool = True  # in the pinned CI slice, or full-run only

    @property
    def case_id(self) -> str:
        return f"{self.suite}/{self.key}"


@dataclasses.dataclass(frozen=True)
class PerfRecord:
    """One measured outcome of a :class:`PerfCase` on this machine."""

    case_id: str
    metric: str
    units: str
    median_s: float
    iqr_s: float
    repeats: int
    warmup: int
    normalized: bool
    roofline_s: "float | None"
    norm_ratio: float
    pct_of_roofline: "float | None"
    workload: "Workload | None"
    hw_name: str
    lower: float = DEFAULT_LOWER
    upper: float = DEFAULT_UPPER

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["workload"] = None if self.workload is None else self.workload.as_dict()
        return d


def reference_entry(rec: PerfRecord) -> dict:
    """The baseline-persisted projection of one record.

    ``norm_ratio`` is the judged reference; ``raw_s``/``iqr_s``/
    ``pct_of_roofline`` are context for humans reading the diff; the
    workload is persisted so a silently changed work model (same case id,
    different bytes) is detected instead of judged against a stale ratio.
    """
    return {
        "metric": rec.metric,
        "units": rec.units,
        "normalized": rec.normalized,
        "norm_ratio": rec.norm_ratio,
        "raw_s": rec.median_s,
        "iqr_s": rec.iqr_s,
        "pct_of_roofline": rec.pct_of_roofline,
        "workload": None if rec.workload is None else rec.workload.as_dict(),
        "tolerance": {"lower": rec.lower, "upper": rec.upper},
    }


def build_baseline(
    records: "Sequence[PerfRecord]",
    *,
    suite: str,
    hw_name: str,
    recorded_utc: "str | None" = None,
    trajectory: "list | None" = None,
) -> dict:
    """Records → committed ``BENCH_<suite>.json`` document.

    ``trajectory`` is the prior document's history (each entry one
    ``--update-baseline`` recording); the new recording is appended and
    the list trimmed to :data:`TRAJECTORY_KEEP`.
    """
    cases = {r.case_id: reference_entry(r) for r in records}
    entry = {
        "recorded_utc": recorded_utc,
        "hw": hw_name,
        "norm_ratios": {cid: cases[cid]["norm_ratio"] for cid in sorted(cases)},
    }
    history = list(trajectory or []) + [entry]
    return {
        "schema": SCHEMA_VERSION,
        "suite": suite,
        "hw": hw_name,
        "case_count": len(cases),
        "cases": {k: cases[k] for k in sorted(cases)},
        "trajectory": history[-TRAJECTORY_KEEP:],
    }


def baseline_path(suite: str, directory) -> pathlib.Path:
    return pathlib.Path(directory) / f"BENCH_{suite}.json"


def save_baseline(doc: dict, path) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")


def load_baseline(path) -> dict:
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"perf baseline schema {doc.get('schema')!r} != supported {SCHEMA_VERSION}"
        )
    return doc


# --- benchmark CSV row contract -------------------------------------------
#
# Every benchmarks/ module prints `name,us_per_call,derived` rows
# (`benchmarks.common.emit`); `# `-prefixed lines are section markers /
# comments.  The smoke test validates every emitted row against this.


def parse_csv_row(line: str) -> "tuple[str, float, str]":
    """Parse and validate one benchmark CSV row; raises ValueError."""
    parts = line.split(",", 2)
    if len(parts) != 3:
        raise ValueError(f"row needs 3 comma fields: {line!r}")
    name, us, derived = parts
    if not name or " " in name:
        raise ValueError(f"bad row name {name!r}: {line!r}")
    try:
        v = float(us)
    except ValueError:
        raise ValueError(f"us_per_call not a number: {line!r}") from None
    if not math.isfinite(v) or v < 0:
        raise ValueError(f"us_per_call must be finite and >= 0: {line!r}")
    return name, v, derived


def validate_csv(text: str) -> "list[str]":
    """All problems in a benchmark CSV stream (header/comment lines skipped)."""
    problems = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        if line.strip() == "name,us_per_call,derived":
            continue
        try:
            parse_csv_row(line)
        except ValueError as e:
            problems.append(f"line {lineno}: {e}")
    return problems
