"""repro_torch.perf — performance-regression subsystem over the port
(the port's copy of ``repro.perf``, DESIGN.md §9).

The perf twin of ``repro_torch.verify``: bench suites run under one
enforced timing discipline (``measure``: warmup, then a sync of every CUDA
device a result lies on, then median-of-k with IQR), results are
normalized against the calibrated roofline of the device they ran on
(``normalize``; the card by default), judged against committed
``BENCH_<suite>.json`` baselines (``guard``; the port's own, recorded on
the card, under ``src/repro_torch/perf/baselines/``), and gated by
``python -m repro_torch.perf`` (``__main__.py``).
"""

from repro_torch.perf.guard import (
    CaseVerdict,
    classify,
    gate_ok,
    judge,
    json_report,
    markdown_report,
    summarize,
)
from repro_torch.perf.measure import (
    Measurement,
    measure,
    measure_interleaved,
    median_iqr,
)
from repro_torch.perf.normalize import Workload, host_hw, normalize, roofline_s
from repro_torch.perf.runner import (
    record_from_measurement,
    run_case,
    run_cases,
    run_suite,
)
from repro_torch.perf.schema import (
    PerfCase,
    PerfRecord,
    baseline_path,
    build_baseline,
    load_baseline,
    parse_csv_row,
    reference_entry,
    save_baseline,
    validate_csv,
)
from repro_torch.perf.suites import SUITE_NAMES, cases_for

__all__ = [
    "CaseVerdict",
    "Measurement",
    "PerfCase",
    "PerfRecord",
    "SUITE_NAMES",
    "Workload",
    "baseline_path",
    "build_baseline",
    "cases_for",
    "classify",
    "gate_ok",
    "host_hw",
    "judge",
    "json_report",
    "load_baseline",
    "markdown_report",
    "measure",
    "measure_interleaved",
    "median_iqr",
    "normalize",
    "parse_csv_row",
    "record_from_measurement",
    "reference_entry",
    "roofline_s",
    "run_case",
    "run_cases",
    "run_suite",
    "save_baseline",
    "summarize",
    "validate_csv",
]
