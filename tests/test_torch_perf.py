"""repro_torch.perf and repro_torch.roofline: the port's perf gate against
the JAX package's ``repro.perf`` / ``repro.roofline``.

The reference's own tests (``tests/test_perfguard.py``,
``tests/test_perf_stats.py``) run here over the port, every case, the
hypothesis properties kept as properties.  Then the port is held to the
reference on the same inputs: the suites' case sets (ids through
``REFERENCE_KEY``, workloads, bands, smoke flags), the normalization,
verdicts and reports on the same fabricated records, ``model_flops_for``
for every arch and shape, and baselines that load across the two
packages.  Every suite's smoke cases (and every full-only case) run once
on the CPU (``device="cpu"``: the kernels' plain versions), and the CLI
``python -m repro_torch.perf`` runs in subprocesses.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import perf as jperf
from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.perf import guard as jguard
from repro.perf import runner as jrunner
from repro.perf import schema as jschema
from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch import perf
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.perf import guard, runner, schema
from repro_torch.perf.measure import default_sync, median_iqr
from repro_torch.perf.schema import TRAJECTORY_KEEP
from repro_torch.perf.suites import REFERENCE_KEY, SUITE_NAMES
from repro_torch.roofline import H100, HW, V5E, analysis
from repro_torch.roofline.analysis import bound_time_s
from repro_torch.roofline.hw import calibrate_host

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are small: one torch thread a test process, so this file
    does not crowd the suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# A fixed fixture machine: 1 GB/s memory, 10 GFLOP/s compute.  All the
# numbers below are chosen against these peaks, so the expected roofline
# times are exact powers of ten.
FIX_HW = HW(
    name="fixture-hw",
    peak_bf16_flops=1e10,
    hbm_bw=1e9,
    ici_bw=1e9,
    inter_pod_bw=1e9,
    hbm_bytes=0.0,
)

# 1 MB moved, 1 kFLOP: memory-bound on FIX_HW → roofline_s = 1e6/1e9 = 1 ms.
WORKLOAD = perf.Workload(bytes_moved=1e6, flops=1e3)
ROOFLINE_S = 1e-3


def rec(
    case_id: str = "engine/sort/random/65536/int32",
    median_s: float = 2e-3,
    *,
    workload: "perf.Workload | None" = WORKLOAD,
    hw: HW = FIX_HW,
    lower: float = 0.5,
    upper: float = 0.75,
    iqr_s: float = 0.0,
) -> perf.PerfRecord:
    return perf.record_from_measurement(
        case_id=case_id,
        median_s=median_s,
        iqr_s=iqr_s,
        warmup=1,
        repeats=5,
        workload=workload,
        hw=hw,
        lower=lower,
        upper=upper,
    )


def baseline_of(*records: perf.PerfRecord, trajectory=None) -> dict:
    return perf.build_baseline(
        records,
        suite="engine",
        hw_name=FIX_HW.name,
        recorded_utc="2026-08-08T00:00:00Z",
        trajectory=trajectory,
    )


# ===================================================================
# The reference's tests/test_perfguard.py over the port
# ===================================================================

# --- normalization math ----------------------------------------------------


def test_normalize_against_roofline():
    out = perf.normalize(2e-3, WORKLOAD, FIX_HW)
    assert out["normalized"] is True
    assert out["roofline_s"] == pytest.approx(ROOFLINE_S)
    assert out["norm_ratio"] == pytest.approx(2.0)  # 2 ms vs a 1 ms bound
    assert out["pct_of_roofline"] == pytest.approx(50.0)


def test_normalize_compute_bound_term():
    # 1e8 FLOPs at 1e10 FLOP/s (10 ms) dominates 1e6 bytes at 1e9 B/s (1 ms).
    w = perf.Workload(bytes_moved=1e6, flops=1e8)
    assert perf.roofline_s(w, FIX_HW) == pytest.approx(1e-2)
    assert bound_time_s(flops=1e8, bytes_moved=1e6, hw=FIX_HW) == pytest.approx(1e-2)


def test_normalize_raw_fallback_without_workload():
    out = perf.normalize(4.2e-3, None, FIX_HW)
    assert out["normalized"] is False
    assert out["roofline_s"] is None
    assert out["norm_ratio"] == pytest.approx(4.2e-3)  # raw seconds
    assert out["pct_of_roofline"] is None


def test_roofline_rejects_empty_workload():
    with pytest.raises(ValueError):
        perf.roofline_s(perf.Workload(bytes_moved=0.0, flops=0.0), FIX_HW)


# --- classification --------------------------------------------------------


def test_classify_bands():
    kw = dict(lower=0.5, upper=0.75)
    assert perf.classify(2.0, 2.0, **kw)[0] == "pass"
    assert perf.classify(3.2, 2.0, **kw)[0] == "warn"  # 1.6x > 1 + 0.75*0.75
    assert perf.classify(3.6, 2.0, **kw)[0] == "fail"  # 1.8x > 1.75
    assert perf.classify(0.9, 2.0, **kw)[0] == "warn"  # 0.45x < 0.5 → stale?


def test_classify_asymmetric_tolerances():
    # Wide regression arm, tight improvement arm: 1.5x passes but 0.85x warns.
    kw = dict(lower=0.1, upper=1.0)
    status, rel, _ = perf.classify(1.5, 1.0, **kw)
    assert (status, rel) == ("pass", pytest.approx(1.5))
    assert perf.classify(0.85, 1.0, **kw)[0] == "warn"
    assert perf.classify(2.01, 1.0, **kw)[0] == "fail"
    # Warn band sits at WARN_FRACTION of the regression arm (1.75x here).
    assert perf.classify(1.8, 1.0, **kw)[0] == "warn"


def test_classify_slack_scales_both_arms():
    kw = dict(lower=0.5, upper=0.75)
    assert perf.classify(4.5, 2.0, **kw)[0] == "fail"
    assert perf.classify(4.5, 2.0, slack=2.0, **kw)[0] == "warn"  # 2.25x < 1+1.5
    assert perf.classify(0.9, 2.0, slack=2.0, **kw)[0] == "pass"  # lo widened


def test_classify_rejects_nonpositive_reference():
    with pytest.raises(ValueError):
        perf.classify(1.0, 0.0, lower=0.5, upper=0.75)


# --- judge: the acceptance-criterion slowdown ------------------------------


def test_injected_2x_slowdown_fails_with_roofline_delta():
    baseline = baseline_of(rec(median_s=2e-3))
    slowed = rec(median_s=4e-3)  # same case, twice the wall time
    (v,) = perf.judge([slowed], baseline)
    assert v.status == "fail"
    assert not v.gate_ok
    assert v.rel == pytest.approx(2.0)
    # The detail must carry the %-of-roofline movement: 50% → 25%.
    assert "%-of-roofline" in v.detail
    assert "50.00% -> 25.00%" in v.detail
    assert "-25.00pp" in v.detail
    assert not perf.gate_ok([v])
    assert perf.summarize([v])["fail"] == 1


def test_judge_pass_within_band():
    baseline = baseline_of(rec(median_s=2e-3))
    (v,) = perf.judge([rec(median_s=2.2e-3)], baseline)
    assert (v.status, v.gate_ok) == ("pass", True)
    assert v.rel == pytest.approx(1.1)


def test_judge_uses_baseline_tolerance_not_fresh():
    # The committed band governs: a fresh record claiming a looser band
    # cannot widen the gate it is judged under.
    baseline = baseline_of(rec(median_s=2e-3, lower=0.1, upper=0.1))
    fresh = rec(median_s=4e-3, lower=9.0, upper=9.0)
    (v,) = perf.judge([fresh], baseline)
    assert v.status == "fail"


# --- judge: new / missing / workload drift ---------------------------------


def test_judge_new_case_fails_gate():
    baseline = baseline_of(rec())
    verdicts = perf.judge([rec(), rec(case_id="engine/sort/local/65536/int32")], baseline)
    by_status = {v.status for v in verdicts}
    assert by_status == {"pass", "new"}
    assert not perf.gate_ok(verdicts)
    (new,) = [v for v in verdicts if v.status == "new"]
    assert "--update-baseline" in new.detail


def test_judge_no_baseline_all_new():
    verdicts = perf.judge([rec(), rec(case_id="engine/b")], None)
    assert [v.status for v in verdicts] == ["new", "new"]
    assert not perf.gate_ok(verdicts)


def test_judge_missing_case_fails_unless_subset():
    baseline = baseline_of(rec(), rec(case_id="engine/sort/dupes/65536/int32"))
    verdicts = perf.judge([rec()], baseline)
    assert perf.summarize(verdicts) == {
        "pass": 1, "warn": 0, "fail": 0, "new": 0, "missing": 1,
    }
    assert not perf.gate_ok(verdicts)
    # Explicit subset runs (--filter / --smoke vs a --full baseline) skip it.
    subset = perf.judge([rec()], baseline, subset=True)
    assert [v.status for v in subset] == ["pass"]
    assert perf.gate_ok(subset)


def test_judge_changed_workload_is_incomparable():
    baseline = baseline_of(rec())
    drifted = rec(workload=perf.Workload(bytes_moved=2e6, flops=1e3))
    (v,) = perf.judge([drifted], baseline)
    assert v.status == "new"
    assert "incomparable" in v.detail
    assert not v.gate_ok


def test_judge_slack_never_rescues_new_or_missing():
    baseline = baseline_of(rec(), rec(case_id="engine/gone"))
    verdicts = perf.judge(
        [rec(), rec(case_id="engine/fresh")], baseline, slack=100.0
    )
    statuses = sorted(v.status for v in verdicts)
    assert statuses == ["missing", "new", "pass"]
    assert not perf.gate_ok(verdicts)


# --- baseline round-trip & trajectory --------------------------------------


def test_update_baseline_round_trip(tmp_path):
    records = [rec(), rec(case_id="engine/sort/dupes/65536/int32", median_s=3e-3)]
    doc = baseline_of(*records)
    path = perf.baseline_path("engine", tmp_path)
    assert path.name == "BENCH_engine.json"
    perf.save_baseline(doc, path)
    loaded = perf.load_baseline(path)
    assert loaded == doc
    assert loaded["case_count"] == 2
    # Re-judging the very records that were recorded must be clean.
    verdicts = perf.judge(records, loaded)
    assert [v.status for v in verdicts] == ["pass", "pass"]
    assert all(v.rel == pytest.approx(1.0) for v in verdicts)


def test_load_baseline_rejects_unknown_schema(tmp_path):
    p = tmp_path / "BENCH_engine.json"
    p.write_text(json.dumps({"schema": 999, "cases": {}}))
    with pytest.raises(ValueError, match="schema"):
        perf.load_baseline(p)


def test_trajectory_appends_and_stays_bounded():
    doc = baseline_of(rec())
    assert len(doc["trajectory"]) == 1
    entry = doc["trajectory"][0]
    assert entry["hw"] == FIX_HW.name
    assert entry["norm_ratios"] == {
        "engine/sort/random/65536/int32": pytest.approx(2.0)
    }
    # Each --update-baseline threads the prior history through; the kept
    # window is bounded at TRAJECTORY_KEEP.
    for _ in range(TRAJECTORY_KEEP + 7):
        doc = baseline_of(rec(), trajectory=doc["trajectory"])
    assert len(doc["trajectory"]) == TRAJECTORY_KEEP


def test_reference_entry_persists_workload_and_tolerance():
    entry = perf.reference_entry(rec(median_s=2e-3, lower=0.2, upper=0.3))
    assert entry["norm_ratio"] == pytest.approx(2.0)
    assert entry["raw_s"] == pytest.approx(2e-3)
    assert entry["workload"] == {"bytes_moved": 1e6, "flops": 1e3}
    assert entry["tolerance"] == {"lower": 0.2, "upper": 0.3}
    assert entry["normalized"] is True


# --- reports ---------------------------------------------------------------


def test_markdown_and_json_reports():
    baseline = baseline_of(rec(median_s=2e-3))
    verdicts = perf.judge([rec(median_s=4e-3)], baseline)
    md = perf.markdown_report({"engine": verdicts}, hw_name=FIX_HW.name, slack=2.0)
    assert "engine/sort/random/65536/int32" in md
    assert "FAIL" in md
    assert "slack: 2x" in md
    doc = perf.json_report(
        {"engine": verdicts}, {"engine": [rec(median_s=4e-3)]},
        hw_name=FIX_HW.name, slack=2.0, elapsed_s=1.5,
    )
    assert doc["gate_ok"] is False
    assert doc["totals"]["fail"] == 1
    assert doc["suites"]["engine"]["verdicts"][0]["status"] == "fail"
    assert doc["suites"]["engine"]["records"][0]["median_s"] == pytest.approx(4e-3)
    json.dumps(doc)  # must be serializable as the CI artifact


# --- CSV row contract ------------------------------------------------------


def test_parse_csv_row_accepts_emit_format():
    name, us, derived = perf.parse_csv_row("engine/sort/random,123.4,iqr_us=1.2")
    assert name == "engine/sort/random"
    assert us == pytest.approx(123.4)
    assert derived == "iqr_us=1.2"
    # derived may itself contain commas (split is bounded at 3 fields)
    assert perf.parse_csv_row("a,1.0,x=1,y=2")[2] == "x=1,y=2"


@pytest.mark.parametrize(
    "row",
    [
        "onlyname",
        "two,fields",
        "bad name,1.0,d",
        ",1.0,d",
        "a,notanum,d",
        "a,-1.0,d",
        "a,inf,d",
        "a,nan,d",
    ],
)
def test_parse_csv_row_rejects(row):
    with pytest.raises(ValueError):
        perf.parse_csv_row(row)


def test_validate_csv_skips_markers_and_header():
    text = "name,us_per_call,derived\n# suite=engine\n\nok/row,1.0,d\nbad row,1,d\n"
    problems = perf.validate_csv(text)
    assert len(problems) == 1
    assert "line 5" in problems[0]


# --- CLI guards ------------------------------------------------------------


def _perfguard(*argv: str, timeout: float = 120):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # One BLAS thread: the host calibration's 384-wide numpy GEMM (the
    # reference's probe) reads anywhere from 0.7 to 400 GFLOP/s a process
    # when OpenBLAS oversubscribes the cores; one thread reads within ~1.5x.
    # One torch thread too, as in this process, so the subprocesses do
    # not crowd the suite's parallel workers.
    env["OPENBLAS_NUM_THREADS"] = env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.perf", *argv],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT,
    )


def test_cli_refuses_update_baseline_with_filter():
    p = _perfguard("--update-baseline", "--filter", "engine/sort")
    assert p.returncode == 2
    assert "--filter" in p.stdout


def test_cli_refuses_smoke_update_of_default_baselines():
    p = _perfguard("--smoke", "--update-baseline")
    assert p.returncode == 2
    assert "--full" in p.stdout


# ===================================================================
# The reference's tests/test_perf_stats.py over the port
# ===================================================================

BASE_HW = HW(
    name="prop-hw",
    peak_bf16_flops=1e10,
    hbm_bw=1e9,
    ici_bw=1e9,
    inter_pod_bw=1e9,
    hbm_bytes=0.0,
)


def _samples(seed: int, size: int) -> np.ndarray:
    # Log-uniform over ~6 decades: timing samples span µs to seconds.
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-6), np.log(1.0), size=size))


@given(seed=st.integers(0, 500), size=st.integers(1, 25))
@settings(max_examples=40, deadline=None)
def test_median_is_permutation_invariant(seed, size):
    s = _samples(seed, size)
    med, iqr = median_iqr(s)
    rng = np.random.default_rng(seed + 1)
    for _ in range(3):
        perm = rng.permutation(s)
        med_p, iqr_p = median_iqr(perm)
        assert med_p == pytest.approx(med, rel=1e-12)
        assert iqr_p == pytest.approx(iqr, rel=1e-12)


@given(seed=st.integers(0, 500), size=st.integers(1, 25))
@settings(max_examples=40, deadline=None)
def test_dispersion_nonnegative_and_median_bounded(seed, size):
    s = _samples(seed, size)
    med, iqr = median_iqr(s)
    assert iqr >= 0.0
    assert s.min() <= med <= s.max()
    if size == 1:
        assert iqr == 0.0  # single repeat: no dispersion by definition


@given(
    seed=st.integers(0, 200),
    k_exp=st.integers(-3, 3),
    lower=st.sampled_from([0.1, 0.5, 0.9]),
    upper=st.sampled_from([0.25, 0.75, 2.0]),
)
@settings(max_examples=60, deadline=None)
def test_judgment_invariant_under_roofline_rescale(seed, k_exp, lower, upper):
    """Rescale every peak by k: both the fresh and the reference norm_ratio
    scale by the same k, so (status, rel) — the gate's entire judgment —
    is unchanged.  This is the portability property of DESIGN.md §9."""
    k = 10.0 ** k_exp
    hw_k = dataclasses.replace(
        BASE_HW,
        name=f"prop-hw-x{k:g}",
        peak_bf16_flops=BASE_HW.peak_bf16_flops * k,
        hbm_bw=BASE_HW.hbm_bw * k,
        ici_bw=BASE_HW.ici_bw * k,
        inter_pod_bw=BASE_HW.inter_pod_bw * k,
    )
    rng = np.random.default_rng(seed)
    w = perf.Workload(
        bytes_moved=float(rng.uniform(1e3, 1e9)),
        flops=float(rng.uniform(0.0, 1e9)),
    )
    ref_s = float(rng.uniform(1e-5, 1e-1))
    val_s = ref_s * float(rng.uniform(0.2, 3.0))

    ratios = [
        (
            perf.normalize(val_s, w, hw)["norm_ratio"],
            perf.normalize(ref_s, w, hw)["norm_ratio"],
        )
        for hw in (BASE_HW, hw_k)
    ]
    # The ratios themselves scale by k...
    assert ratios[1][0] == pytest.approx(ratios[0][0] * k, rel=1e-9)
    assert ratios[1][1] == pytest.approx(ratios[0][1] * k, rel=1e-9)
    # ...and the judgment does not move at all.
    verdicts = [
        perf.classify(v, r, lower=lower, upper=upper) for v, r in ratios
    ]
    assert verdicts[0][0] == verdicts[1][0]
    assert verdicts[0][1] == pytest.approx(verdicts[1][1], rel=1e-9)


@given(warmup=st.integers(0, 3), repeats=st.integers(1, 6))
@settings(max_examples=15, deadline=None)
def test_measure_call_accounting(warmup, repeats):
    """measure() calls fn exactly warmup+repeats times and keeps only the
    post-warmup samples; the median lies inside [min, max]."""
    calls = []

    def fn():
        calls.append(None)
        return None

    m = perf.measure(fn, warmup=warmup, repeats=repeats)
    assert len(calls) == warmup + repeats
    assert len(m.samples_s) == repeats
    assert (m.warmup, m.repeats) == (warmup, repeats)
    assert m.min_s <= m.median_s <= m.max_s
    assert m.iqr_s >= 0.0


# ===================================================================
# Parity with repro.perf / repro.roofline on the same inputs
# ===================================================================


def _jhw(hw: HW) -> jhw.HW:
    return jhw.HW(**dataclasses.asdict(hw))


def _w(w):
    return None if w is None else w.as_dict()


def test_constants_match_reference():
    assert SUITE_NAMES == jperf.SUITE_NAMES
    assert schema.SCHEMA_VERSION == jschema.SCHEMA_VERSION == 1
    assert schema.TRAJECTORY_KEEP == jschema.TRAJECTORY_KEEP == 20
    assert (schema.DEFAULT_LOWER, schema.DEFAULT_UPPER) == (jschema.DEFAULT_LOWER, jschema.DEFAULT_UPPER)
    assert guard.WARN_FRACTION == jguard.WARN_FRACTION
    assert (runner.DEFAULT_WARMUP, runner.DEFAULT_REPEATS) == (jrunner.DEFAULT_WARMUP, jrunner.DEFAULT_REPEATS)
    assert dataclasses.asdict(V5E) == dataclasses.asdict(jhw.V5E)
    assert sorted(perf.__all__) == sorted(jperf.__all__)


def test_h100_is_the_data_sheet_record():
    assert (H100.peak_bf16_flops, H100.hbm_bw, H100.ici_bw, H100.inter_pod_bw, H100.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 50e9, 80e9
    )


@pytest.mark.parametrize("smoke", (True, False), ids=("smoke", "full"))
@pytest.mark.parametrize("suite", SUITE_NAMES)
def test_cases_match_reference(suite, smoke):
    """Same ids (through REFERENCE_KEY), workloads, bands, smoke flags and
    order; the reference's setups are built but never called."""
    mine = perf.cases_for(suite, smoke=smoke, device="cpu")
    ref = jperf.cases_for(suite, smoke=smoke)
    assert [REFERENCE_KEY.get(c.case_id, c.case_id) for c in mine] == [c.case_id for c in ref]
    for m, r in zip(mine, ref):
        assert (m.suite, m.metric, m.units, m.lower, m.upper, m.smoke) == (
            r.suite, r.metric, r.units, r.lower, r.upper, r.smoke
        ), m.case_id
        assert _w(m.workload) == _w(r.workload), m.case_id


def test_reference_key_names_only_renamed_port_ids():
    port_ids = {c.case_id for s in SUITE_NAMES for c in perf.cases_for(s, smoke=False, device="cpu")}
    ref_ids = {c.case_id for s in SUITE_NAMES for c in jperf.cases_for(s, smoke=False)}
    assert set(REFERENCE_KEY) <= port_ids
    assert not set(REFERENCE_KEY) & ref_ids
    assert set(REFERENCE_KEY.values()) <= ref_ids
    assert {REFERENCE_KEY.get(i, i) for i in port_ids} == ref_ids


# Fabricated records: (case id, median s, workload, lower, upper), with
# compute- and memory-bound workloads, raw-seconds cases and wide bands.
FAB = [
    ("engine/a", 2e-3, (1e6, 1e3), 0.5, 0.75),
    ("engine/b", 3.7e-3, (1e6, 1e8), 0.5, 0.75),
    ("engine/c", 4.2e-3, None, 0.7, 1.5),
    ("engine/d", 1.3e-5, (6.5e4, 2.1e5), 0.1, 2.0),
    ("engine/e", 9.1e-1, (3.2e9, 7.7e9), 0.9, 0.25),
]
FAB_HWS = [FIX_HW, H100, V5E, dataclasses.replace(FIX_HW, name="odd", peak_bf16_flops=3.3e11, hbm_bw=7.1e9)]


def _fab(pkg, hw, scale: float = 1.0) -> list:
    out = []
    for cid, med, w, lo, up in FAB:
        work = None if w is None else pkg.Workload(bytes_moved=w[0], flops=w[1])
        out.append(pkg.record_from_measurement(
            case_id=cid, median_s=med * scale, iqr_s=med / 10, warmup=2, repeats=5,
            workload=work, hw=hw, lower=lo, upper=up,
        ))
    return out


@pytest.mark.parametrize("hw", FAB_HWS, ids=lambda h: h.name)
def test_normalize_and_bounds_match_reference(hw):
    for _, med, w, _, _ in FAB:
        work = None if w is None else perf.Workload(bytes_moved=w[0], flops=w[1])
        jwork = None if w is None else jperf.Workload(bytes_moved=w[0], flops=w[1])
        assert perf.normalize(med, work, hw) == jperf.normalize(med, jwork, _jhw(hw))
        if w is not None:
            assert perf.roofline_s(work, hw) == jperf.roofline_s(jwork, _jhw(hw))
    for kw in (
        dict(flops=1e9), dict(bytes_moved=4e8), dict(flops=3e12, bytes_moved=5e9),
        dict(intra_pod_bytes=1e7, inter_pod_bytes=3e6), dict(flops=1e6, intra_pod_bytes=2e9),
        dict(),
    ):
        assert bound_time_s(hw=hw, **kw) == janalysis.bound_time_s(hw=_jhw(hw), **kw)
    assert bound_time_s(flops=1e12) == janalysis.bound_time_s(flops=1e12)  # default hw: V5E
    assert analysis.np_prod((3, 5, 7)) == janalysis.np_prod((3, 5, 7)) == 105


@given(
    value=st.integers(1, 4000),
    ref=st.integers(1, 4000),
    lower=st.sampled_from([0.1, 0.5, 0.7, 0.9]),
    upper=st.sampled_from([0.1, 0.25, 0.75, 1.5, 2.0]),
    slack=st.sampled_from([1.0, 2.0, 4.0]),
)
@settings(max_examples=80, deadline=None)
def test_classify_matches_reference(value, ref, lower, upper, slack):
    v, r = value / 1000.0, ref / 1000.0
    assert perf.classify(v, r, lower=lower, upper=upper, slack=slack) == jperf.classify(
        v, r, lower=lower, upper=upper, slack=slack
    )


@pytest.mark.parametrize("scale", (1.0, 1.1, 1.65, 2.0, 0.3))
@pytest.mark.parametrize("hw", FAB_HWS, ids=lambda h: h.name)
def test_judge_and_reports_match_reference(hw, scale):
    jh = _jhw(hw)
    kw = dict(suite="engine", hw_name=hw.name, recorded_utc="2026-08-08T00:00:00Z")
    mine = _fab(perf, hw)
    ref = _fab(jperf, jh)
    assert [r.as_dict() for r in mine] == [r.as_dict() for r in ref]
    base = perf.build_baseline(mine[:-1], **kw)
    jbase_doc = jperf.build_baseline(ref[:-1], **kw)
    assert base == jbase_doc
    fresh, jfresh = _fab(perf, hw, scale), _fab(jperf, jh, scale)
    for subset in (False, True):
        for slack in (1.0, 2.0):
            # one case measured but not in the baseline, one in it twice over
            v = perf.judge(fresh[1:], base, subset=subset, slack=slack)
            jv = jperf.judge(jfresh[1:], jbase_doc, subset=subset, slack=slack)
            assert [dataclasses.asdict(x) for x in v] == [dataclasses.asdict(x) for x in jv]
            assert perf.summarize(v) == jperf.summarize(jv)
            assert perf.gate_ok(v) == jperf.gate_ok(jv)
            sv, srec = {"engine": v}, {"engine": fresh[1:]}
            jsv, jsrec = {"engine": jv}, {"engine": jfresh[1:]}
            assert perf.markdown_report(sv, hw_name=hw.name, slack=slack) == jperf.markdown_report(
                jsv, hw_name=hw.name, slack=slack
            )
            assert perf.json_report(sv, srec, hw_name=hw.name, slack=slack, elapsed_s=1.25) == jperf.json_report(
                jsv, jsrec, hw_name=hw.name, slack=slack, elapsed_s=1.25
            )
    assert perf.judge(fresh, None) == [guard.CaseVerdict(**dataclasses.asdict(x)) for x in jperf.judge(jfresh, None)]


@pytest.mark.parametrize("shape", sorted(tbase.SHAPES))
@pytest.mark.parametrize("arch", sorted(tregistry.ARCHS))
def test_model_flops_for_matches_reference(arch, shape):
    got = analysis.model_flops_for(tregistry.get_config(arch), tbase.SHAPES[shape])
    want = janalysis.model_flops_for(jregistry.get_config(arch), jbase.SHAPES[shape])
    assert got == want and got > 0


def test_registry_and_shapes_cover_the_reference():
    assert sorted(tregistry.ARCHS) == sorted(jregistry.ARCHS)
    assert sorted(tbase.SHAPES) == sorted(jbase.SHAPES)


def test_baselines_load_across_packages(tmp_path):
    kw = dict(suite="engine", hw_name="NVIDIA H100 80GB HBM3, 700.00 W", recorded_utc="2026-10-17T00:00:00+00:00")
    doc = perf.build_baseline(_fab(perf, H100), **kw)
    mine = tmp_path / "port" / "BENCH_engine.json"
    perf.save_baseline(doc, mine)
    assert jperf.load_baseline(mine) == doc == perf.load_baseline(mine)
    jdoc = jperf.build_baseline(_fab(jperf, _jhw(H100)), **kw)
    theirs = tmp_path / "ref" / "BENCH_engine.json"
    jperf.save_baseline(jdoc, theirs)
    assert perf.load_baseline(theirs) == jdoc
    assert mine.read_bytes() == theirs.read_bytes()  # the same JSON, byte for byte


def test_committed_reference_baseline_loads_in_the_port():
    path = ROOT / "benchmarks" / "baselines" / "BENCH_engine.json"
    doc = perf.load_baseline(path)  # read only
    assert doc == jperf.load_baseline(path) == json.loads(path.read_text())
    hw = FIX_HW
    recs, jrecs = [], []
    for cid, entry in doc["cases"].items():
        w = entry["workload"]
        recs.append(perf.record_from_measurement(
            case_id=cid, median_s=entry["raw_s"] * 1.3, iqr_s=0.0, warmup=2, repeats=5,
            workload=None if w is None else perf.Workload(**w), hw=hw))
        jrecs.append(jperf.record_from_measurement(
            case_id=cid, median_s=entry["raw_s"] * 1.3, iqr_s=0.0, warmup=2, repeats=5,
            workload=None if w is None else jperf.Workload(**w), hw=_jhw(hw)))
    v, jv = perf.judge(recs, doc), jperf.judge(jrecs, doc)
    assert [dataclasses.asdict(x) for x in v] == [dataclasses.asdict(x) for x in jv]
    assert {x.status for x in v} <= {"pass", "warn", "fail"}  # every case comparable


# ===================================================================
# The port's own surface: calibration, sync, the suites on the CPU, the CLI
# ===================================================================


def test_calibrate_host_cpu_is_cached_and_positive():
    hw = calibrate_host(device="cpu")
    assert hw is calibrate_host(device="cpu") is perf.host_hw("cpu")
    assert hw.name == "host-calibrated" and hw.hbm_bytes == 0.0
    assert hw.hbm_bw > 0 and hw.peak_bf16_flops > 0
    assert hw.ici_bw == hw.inter_pod_bw == hw.hbm_bw


def test_calibrate_host_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the no-card failure shows only where there is no card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_host()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        perf.host_hw()


def test_default_sync_walks_results_and_ignores_host_values():
    # no CUDA leaf: nothing to drain, whatever the nesting
    default_sync(None)
    default_sync((np.arange(3), torch.arange(3), {"a": [1, 2.0, torch.zeros(2)], "b": (np.int32(1),)}))


def _check_records(records, cases):
    assert [r.case_id for r in records] == [c.case_id for c in cases]
    for r, c in zip(records, cases):
        assert math.isfinite(r.median_s) and r.median_s > 0, r
        assert math.isfinite(r.norm_ratio) and r.norm_ratio > 0, r
        assert r.normalized == (c.workload is not None)
        if r.normalized:
            assert math.isfinite(r.pct_of_roofline) and r.pct_of_roofline > 0
        assert (r.lower, r.upper, r.repeats, r.warmup) == (c.lower, c.upper, 1, 0)


@pytest.mark.parametrize("suite", SUITE_NAMES)
def test_smoke_suite_runs_on_cpu(suite):
    hw = perf.host_hw("cpu")
    records = perf.run_suite(suite, smoke=True, hw=hw, warmup=0, repeats=1, device="cpu")
    _check_records(records, perf.cases_for(suite, smoke=True, device="cpu"))
    assert all(r.hw_name == "host-calibrated" for r in records)


FULL_ONLY = [c.case_id for s in SUITE_NAMES for c in perf.cases_for(s, smoke=False, device="cpu") if not c.smoke]


@pytest.mark.parametrize("case_id", FULL_ONLY)
def test_full_only_case_runs_on_cpu(case_id):
    (case,) = [c for c in perf.cases_for(case_id.split("/")[0], smoke=False, device="cpu") if c.case_id == case_id]
    records = perf.run_cases([case], hw=perf.host_hw("cpu"), warmup=0, repeats=1, device="cpu")
    _check_records(records, [case])


def test_fleet_case_closes_its_service():
    (case,) = [c for c in perf.cases_for("fleet", smoke=True, device="cpu") if "single" in c.case_id]
    fn = case.setup()
    wall, outs = fn()
    assert len(outs) == 80 and wall > 0
    fn.close()
    with pytest.raises(RuntimeError):  # a closed service takes no request
        fn()


def test_cli_records_then_passes_the_gate(tmp_path):
    """``--update-baseline`` into a directory of the caller's, then the
    gate over a filtered slice against it.  CPU times under the test
    suite's parallel workers swing; ``--slack 4`` lets the gate fail only
    past 4x the recorded ratio."""
    common = ("--suite", "engine", "--device", "cpu", "--baseline-dir", str(tmp_path), "--warmup", "1")
    p = _perfguard(*common, "--repeats", "3", "--update-baseline", timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    doc = perf.load_baseline(tmp_path / "BENCH_engine.json")
    assert doc["hw"] == "host-calibrated" and doc["case_count"] == 2
    assert sorted(doc["cases"]) == ["engine/sort/dupes/65536/int32", "engine/sort/random/65536/int32"]
    report = tmp_path / "report.json"
    p = _perfguard(*common, "--repeats", "3", "--filter", "dupes", "--slack", "4", "--report", str(report),
                   timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "OK" in p.stdout
    rep = json.loads(report.read_text())
    assert rep["gate_ok"] is True and rep["totals"]["new"] == rep["totals"]["missing"] == 0
    assert [v["case_id"] for v in rep["suites"]["engine"]["verdicts"]] == ["engine/sort/dupes/65536/int32"]


def test_cli_fails_without_a_baseline(tmp_path):
    p = _perfguard("--suite", "netsim", "--device", "cpu", "--baseline-dir", str(tmp_path),
                   "--warmup", "0", "--repeats", "1")
    assert p.returncode == 1
    assert "baseline MISSING" in p.stdout


def test_cli_defaults_to_the_card_and_the_port_baselines():
    from repro_torch.perf import __main__ as cli

    args = cli.parse_args([])
    assert args.device == "cuda"
    assert Path(args.baseline_dir) == ROOT / "src" / "repro_torch" / "perf" / "baselines"


@pytest.mark.parametrize("suite", SUITE_NAMES)
def test_committed_port_baselines_hold_the_full_case_set(suite):
    """The port's committed baselines (recorded on the card) hold every
    case of the suite at full scope with its current work model and band,
    name the card and its power limit, and load in the reference too."""
    path = perf.baseline_path(suite, ROOT / "src" / "repro_torch" / "perf" / "baselines")
    doc = perf.load_baseline(path)
    assert doc == jperf.load_baseline(path)
    assert doc["suite"] == suite and doc["hw"].startswith("NVIDIA H100") and doc["hw"].endswith(" W")
    cases = {c.case_id: c for c in perf.cases_for(suite, smoke=False, device="cpu")}
    assert sorted(doc["cases"]) == sorted(cases) and doc["case_count"] == len(cases)
    for cid, entry in doc["cases"].items():
        c = cases[cid]
        assert entry["workload"] == _w(c.workload) and entry["normalized"] == (c.workload is not None)
        assert entry["tolerance"] == {"lower": c.lower, "upper": c.upper}
        assert entry["raw_s"] > 0 and entry["norm_ratio"] > 0
