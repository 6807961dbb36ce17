"""Perf-regression gate: fresh run vs committed baseline (DESIGN.md §9).

The port's copy of ``repro.perf.guard``: the same verdicts, bands and
reports.

The perf twin of ``repro_torch.verify.baseline``'s drift gate.  Each measured
:class:`~repro_torch.perf.schema.PerfRecord` is judged against the committed
reference for its ``case_id`` on the *normalized* ratio (see
``repro_torch.perf.normalize``), under the baseline's own asymmetric tolerance:

* ``fail``  — regression beyond ``ref · (1 + upper)``;
* ``warn``  — inside tolerance but past the warn fraction of the band, or
  an improvement beyond ``ref · (1 - lower)`` (numbers that good usually
  mean the measurement broke or the baseline is stale — re-record);
* ``pass``  — inside the band;
* ``new``   — measured but absent from the baseline: a gate has nothing to
  gate against, so it fails until recorded;
* ``missing`` — in the baseline but not measured (a silently dropped case
  is a gate silently shrinking): fails, except on explicit subset runs
  (``--filter``/``--suite``), mirroring verify's subset diff.

A changed work model (same case id, different bytes/flops) makes the old
ratio incomparable; the case is judged ``new`` with a re-record hint, not
compared against a stale reference.  ``slack`` scales both tolerance arms
(CI shared runners run with ``--slack 2``); it never rescues ``new`` /
``missing``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.perf.schema import PerfRecord

# Inside the tolerance band but beyond this fraction of it → warn.
WARN_FRACTION = 0.75


@dataclasses.dataclass(frozen=True)
class CaseVerdict:
    """One case's judgment: status, the numbers behind it, and prose."""

    case_id: str
    status: str  # pass | warn | fail | new | missing
    value: "float | None"  # fresh norm_ratio (None for missing)
    reference: "float | None"  # baseline norm_ratio (None for new)
    rel: "float | None"  # value / reference
    detail: str

    @property
    def gate_ok(self) -> bool:
        return self.status in ("pass", "warn")


def classify(
    value: float,
    reference: float,
    *,
    lower: float,
    upper: float,
    slack: float = 1.0,
) -> "tuple[str, float, str]":
    """(status, rel, detail) for a comparable (value, reference) pair."""
    if reference <= 0:
        raise ValueError(f"non-positive reference {reference}")
    lo, up = lower * slack, upper * slack
    rel = value / reference
    if rel > 1.0 + up:
        return "fail", rel, (
            f"regression: {rel:.2f}x the reference "
            f"(tolerance +{up * 100:.0f}%)"
        )
    if rel > 1.0 + WARN_FRACTION * up:
        return "warn", rel, (
            f"approaching tolerance: {rel:.2f}x the reference "
            f"(warn past +{WARN_FRACTION * up * 100:.0f}%, fail past +{up * 100:.0f}%)"
        )
    if rel < 1.0 - lo:
        return "warn", rel, (
            f"improvement beyond tolerance: {rel:.2f}x the reference "
            f"(-{lo * 100:.0f}% band) — verify and re-record the baseline"
        )
    return "pass", rel, f"{rel:.2f}x the reference"


def _workload_matches(rec: PerfRecord, ref_entry: dict) -> bool:
    ref_w = ref_entry.get("workload")
    rec_w = None if rec.workload is None else rec.workload.as_dict()
    return ref_w == rec_w and bool(ref_entry.get("normalized")) == rec.normalized


def _roofline_delta(rec: PerfRecord, ref_entry: dict) -> str:
    ref_pct = ref_entry.get("pct_of_roofline")
    if not rec.normalized or ref_pct is None or rec.pct_of_roofline is None:
        return ""
    return (
        f"; %-of-roofline {ref_pct:.2f}% -> {rec.pct_of_roofline:.2f}% "
        f"(delta {rec.pct_of_roofline - ref_pct:+.2f}pp)"
    )


def judge(
    records: "Sequence[PerfRecord]",
    baseline: "dict | None",
    *,
    subset: bool = False,
    slack: float = 1.0,
) -> "list[CaseVerdict]":
    """Judge a suite's fresh records against its committed baseline.

    ``baseline=None`` (no committed file) makes every record ``new`` —
    the gate fails loudly instead of silently passing, exactly like a
    missing verify baseline.
    """
    cases = {} if baseline is None else baseline.get("cases", {})
    verdicts = []
    seen = set()
    for rec in records:
        seen.add(rec.case_id)
        ref = cases.get(rec.case_id)
        if ref is None:
            verdicts.append(CaseVerdict(
                case_id=rec.case_id, status="new", value=rec.norm_ratio,
                reference=None, rel=None,
                detail="not in baseline — record with --update-baseline",
            ))
            continue
        if not _workload_matches(rec, ref):
            verdicts.append(CaseVerdict(
                case_id=rec.case_id, status="new", value=rec.norm_ratio,
                reference=ref.get("norm_ratio"), rel=None,
                detail="work model changed — the recorded ratio is "
                "incomparable; re-record with --update-baseline",
            ))
            continue
        tol = ref.get("tolerance", {})
        status, rel, detail = classify(
            rec.norm_ratio, ref["norm_ratio"],
            lower=float(tol.get("lower", rec.lower)),
            upper=float(tol.get("upper", rec.upper)),
            slack=slack,
        )
        if status != "pass":
            detail += _roofline_delta(rec, ref)
        verdicts.append(CaseVerdict(
            case_id=rec.case_id, status=status, value=rec.norm_ratio,
            reference=ref["norm_ratio"], rel=rel, detail=detail,
        ))
    if not subset:
        for cid in sorted(set(cases) - seen):
            verdicts.append(CaseVerdict(
                case_id=cid, status="missing", value=None,
                reference=cases[cid].get("norm_ratio"), rel=None,
                detail="in baseline but not measured — dropped case?",
            ))
    return verdicts


def gate_ok(verdicts: "Sequence[CaseVerdict]") -> bool:
    return all(v.gate_ok for v in verdicts)


def summarize(verdicts: "Sequence[CaseVerdict]") -> dict:
    counts = {"pass": 0, "warn": 0, "fail": 0, "new": 0, "missing": 0}
    for v in verdicts:
        counts[v.status] += 1
    return counts


def markdown_report(
    suite_verdicts: "dict[str, list[CaseVerdict]]",
    *,
    hw_name: str,
    slack: float = 1.0,
) -> str:
    """Human-readable gate report (the CI artifact next to the JSON)."""
    lines = [
        "# perfguard report",
        "",
        f"normalization hw: `{hw_name}`; tolerance slack: {slack:g}x",
        "",
        "| case | status | norm ratio | reference | rel | detail |",
        "|---|---|---|---|---|---|",
    ]
    for suite in sorted(suite_verdicts):
        for v in suite_verdicts[suite]:
            fmt = lambda x: "—" if x is None else f"{x:.3f}"  # noqa: E731
            lines.append(
                f"| `{v.case_id}` | {v.status.upper()} | {fmt(v.value)} | "
                f"{fmt(v.reference)} | {fmt(v.rel)} | {v.detail} |"
            )
    totals = summarize([v for vs in suite_verdicts.values() for v in vs])
    ok = all(gate_ok(vs) for vs in suite_verdicts.values())
    lines += [
        "",
        f"**{'PASS' if ok else 'FAIL'}** — " + ", ".join(
            f"{k}: {n}" for k, n in totals.items() if n
        ),
        "",
    ]
    return "\n".join(lines)


def json_report(
    suite_verdicts: "dict[str, list[CaseVerdict]]",
    suite_records: "dict[str, list[PerfRecord]]",
    *,
    hw_name: str,
    slack: float = 1.0,
    elapsed_s: "float | None" = None,
) -> dict:
    return {
        "hw": hw_name,
        "slack": slack,
        "elapsed_s": elapsed_s,
        "gate_ok": all(gate_ok(vs) for vs in suite_verdicts.values()),
        "totals": summarize([v for vs in suite_verdicts.values() for v in vs]),
        "suites": {
            suite: {
                "verdicts": [dataclasses.asdict(v) for v in suite_verdicts[suite]],
                "records": [r.as_dict() for r in suite_records.get(suite, [])],
            }
            for suite in sorted(suite_verdicts)
        },
    }
