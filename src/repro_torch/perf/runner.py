"""Execute perf suites under the measurement contract (DESIGN.md §9).

The port's copy of ``repro.perf.runner``.  ``run_cases`` is the only place
a :class:`~repro_torch.perf.schema.PerfCase` becomes a
:class:`~repro_torch.perf.schema.PerfRecord`: setup (inputs, kernel builds
and one untimed call) happens outside the timed region, each timed call is
drained via the measure layer's sync, the value is median-of-``repeats``
with IQR, and the result is normalized against the calibrated roofline of
``device`` (the card by default) before anything is persisted or judged.
"""

from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.perf.measure import measure as _measure
from repro_torch.perf.normalize import Workload, host_hw, normalize
from repro_torch.perf.schema import PerfCase, PerfRecord
from repro_torch.perf.suites import cases_for
from repro_torch.roofline.hw import HW

DEFAULT_WARMUP = 2
DEFAULT_REPEATS = 5


def run_case(
    case: PerfCase,
    *,
    hw: "HW | None" = None,
    warmup: int = DEFAULT_WARMUP,
    repeats: int = DEFAULT_REPEATS,
    device="cuda",
) -> PerfRecord:
    hw = hw or host_hw(device)
    fn = case.setup()
    try:
        m = _measure(fn, warmup=warmup, repeats=repeats)
    finally:
        close = getattr(fn, "close", None)
        if close is not None:
            close()
    return record_from_measurement(
        case_id=case.case_id,
        median_s=m.median_s,
        iqr_s=m.iqr_s,
        warmup=m.warmup,
        repeats=m.repeats,
        workload=case.workload,
        hw=hw,
        metric=case.metric,
        units=case.units,
        lower=case.lower,
        upper=case.upper,
    )


def record_from_measurement(
    *,
    case_id: str,
    median_s: float,
    iqr_s: float,
    warmup: int,
    repeats: int,
    workload: "Workload | None",
    hw: HW,
    metric: str = "time",
    units: str = "s",
    lower: float = 0.5,
    upper: float = 0.75,
) -> PerfRecord:
    """Measurement numbers → normalized record (also the test seam:
    fixtures fabricate records without timing anything)."""
    norm = normalize(median_s, workload, hw)
    return PerfRecord(
        case_id=case_id,
        metric=metric,
        units=units,
        median_s=median_s,
        iqr_s=iqr_s,
        repeats=repeats,
        warmup=warmup,
        normalized=norm["normalized"],
        roofline_s=norm["roofline_s"],
        norm_ratio=norm["norm_ratio"],
        pct_of_roofline=norm["pct_of_roofline"],
        workload=workload,
        hw_name=hw.name,
        lower=lower,
        upper=upper,
    )


def run_cases(
    cases: "Sequence[PerfCase]",
    *,
    hw: "HW | None" = None,
    warmup: int = DEFAULT_WARMUP,
    repeats: int = DEFAULT_REPEATS,
    progress: "Callable[[PerfRecord], None] | None" = None,
    device="cuda",
) -> "list[PerfRecord]":
    hw = hw or host_hw(device)
    records = []
    for case in cases:
        rec = run_case(case, hw=hw, warmup=warmup, repeats=repeats, device=device)
        records.append(rec)
        if progress is not None:
            progress(rec)
    return records


def run_suite(
    suite: str,
    *,
    smoke: bool = True,
    hw: "HW | None" = None,
    warmup: int = DEFAULT_WARMUP,
    repeats: int = DEFAULT_REPEATS,
    case_filter: "str | None" = None,
    progress: "Callable[[PerfRecord], None] | None" = None,
    device="cuda",
) -> "list[PerfRecord]":
    cases = cases_for(suite, smoke=smoke, device=device)
    if case_filter:
        cases = [c for c in cases if case_filter in c.case_id]
    return run_cases(cases, hw=hw, warmup=warmup, repeats=repeats, progress=progress, device=device)
