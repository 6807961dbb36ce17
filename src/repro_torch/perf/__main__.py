"""Perf-regression gate over the port (DESIGN.md §9).

The port's copy of the reference's ``tools/perfguard.py``: the same flags,
exit codes (0 pass, 1 gate failure, 2 refused) and refusals, plus
``--device``.  Runs the pinned perf suites (``repro_torch.perf.suites``)
under the enforced timing discipline, normalizes every case against the
calibrated roofline of the device it ran on, and gates the normalized
ratios against the committed ``src/repro_torch/perf/baselines/
BENCH_<suite>.json`` files: any regression beyond a case's tolerance — or
a new/dropped case — fails the run until the baseline is explicitly
re-recorded.  Those baselines are recorded on the card (each names the
card and its power limit); the reference's ``benchmarks/baselines/`` were
recorded on a CPU in Pallas interpret mode and are never this gate's.

Usage::

    PYTHONPATH=src python -m repro_torch.perf --smoke              # on the card
    PYTHONPATH=src python -m repro_torch.perf --full --update-baseline
    PYTHONPATH=src python -m repro_torch.perf --suite engine --filter dupes
    PYTHONPATH=src python -m repro_torch.perf --smoke --slack 2    # shared card
    PYTHONPATH=src python -m repro_torch.perf --smoke --device cpu --baseline-dir DIR

``--device cuda`` (the default) runs every case on the card and raises
where there is none; ``--device cpu`` runs the kernels' plain versions.
``--slack`` scales every tolerance arm; ``--filter``/``--suite`` subset
runs skip the missing-case check.  ``--report``/``--markdown`` write the
artifacts.
"""

from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import subprocess
import sys
import time

import torch

DEFAULT_BASELINE_DIR = pathlib.Path(__file__).resolve().parent / "baselines"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="pinned CI slice (default)")
    mode.add_argument("--full", action="store_true",
                      help="every registered case, nightly scope")
    ap.add_argument("--suite", action="append", default=None,
                    help="run only this suite (repeatable)")
    ap.add_argument("--filter", default=None,
                    help="substring filter on case ids")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every case runs (cpu: the kernels' plain versions)")
    ap.add_argument("--baseline-dir", default=str(DEFAULT_BASELINE_DIR),
                    help=f"BENCH_<suite>.json directory (default {DEFAULT_BASELINE_DIR})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="record outcomes as the new baselines instead of gating")
    ap.add_argument("--slack", type=float, default=1.0,
                    help="tolerance multiplier for noisy hosts (CI uses 2)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5,
                    help="median-of-k repeats per case")
    ap.add_argument("--report", default=None,
                    help="write the JSON report (CI artifact) here")
    ap.add_argument("--markdown", default=None,
                    help="write the markdown report here")
    ap.add_argument("-q", "--quiet", action="store_true")
    return ap.parse_args(argv)


def hw_label(hw, device) -> str:
    """The name a baseline records: on the card, its name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit`` gives them; else
    ``hw.name``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return hw.name
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        r = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        r = None
    if r is None or r.returncode != 0 or not r.stdout.strip():
        return f"{hw.name}, power limit not read"
    return r.stdout.strip()


def main(argv=None) -> int:
    args = parse_args(argv)
    from repro_torch import perf
    from repro_torch.perf.suites import SUITE_NAMES

    smoke = not args.full
    suites = list(args.suite) if args.suite else list(SUITE_NAMES)
    for s in suites:
        if s not in SUITE_NAMES:
            print(f"unknown suite {s!r}; choose from {SUITE_NAMES}")
            return 2
    if args.update_baseline and args.filter:
        # A --filter run measures a slice of a suite; recording it would
        # silently shrink the committed baseline out from under the gate.
        print("refusing --update-baseline with --filter: record whole "
              "suites (optionally narrowed with --suite)")
        return 2
    if (args.update_baseline and smoke
            and pathlib.Path(args.baseline_dir).resolve()
            == DEFAULT_BASELINE_DIR.resolve()):
        # Committed baselines carry the full case set (--smoke gates a
        # pinned subset of them); a smoke recording would drop the
        # full-only cases from the committed files.
        print("refusing --update-baseline in --smoke mode: the committed "
              "baselines are recorded at --full scope; pass --full, or "
              "--baseline-dir PATH to record a smoke set elsewhere")
        return 2

    hw = perf.host_hw(args.device)
    label = hw_label(hw, args.device)
    if not args.quiet:
        print(f"# hw: {label}  mem_bw={hw.hbm_bw / 1e9:.1f}GB/s  "
              f"gemm={hw.peak_bf16_flops / 1e9:.1f}GFLOP/s  device={args.device}  "
              f"mode={'smoke' if smoke else 'full'}  slack={args.slack:g}x")

    baseline_dir = pathlib.Path(args.baseline_dir)
    t0 = time.perf_counter()
    suite_records: dict = {}
    suite_verdicts: dict = {}
    rc = 0
    for suite in suites:
        def progress(rec):
            if not args.quiet:
                pct = ("-" if rec.pct_of_roofline is None
                       else f"{rec.pct_of_roofline:.2f}%")
                print(f"  {rec.case_id}: {rec.median_s * 1e6:.0f}us "
                      f"(iqr {rec.iqr_s * 1e6:.0f}us, roofline {pct}, "
                      f"norm_ratio {rec.norm_ratio:.3g})", flush=True)

        records = perf.run_suite(
            suite, smoke=smoke, hw=hw, warmup=args.warmup,
            repeats=args.repeats, case_filter=args.filter, progress=progress,
            device=args.device,
        )
        suite_records[suite] = records
        path = perf.baseline_path(suite, baseline_dir)
        if args.update_baseline:
            trajectory = None
            if path.exists():
                trajectory = perf.load_baseline(path).get("trajectory")
            doc = perf.build_baseline(
                records, suite=suite, hw_name=label,
                recorded_utc=datetime.datetime.now(datetime.timezone.utc)
                .isoformat(timespec="seconds"),
                trajectory=trajectory,
            )
            perf.save_baseline(doc, path)
            print(f"baseline recorded: {path} ({len(records)} cases)")
            continue
        baseline = perf.load_baseline(path) if path.exists() else None
        # Committed baselines are recorded at --full scope; a --smoke run
        # measures its pinned slice of them, so missing cases are expected
        # there (subset diff) but a dropped case in a --full run fails.
        verdicts = perf.judge(
            records, baseline, subset=bool(args.filter) or smoke,
            slack=args.slack,
        )
        suite_verdicts[suite] = verdicts
        for v in verdicts:
            if v.status != "pass":
                print(f"{v.status.upper():7s} {v.case_id}: {v.detail}")
        if baseline is None:
            print(f"baseline MISSING: {path} — the perf gate cannot run; "
                  "restore the committed file or record with --update-baseline")
        if not perf.gate_ok(verdicts) or baseline is None:
            rc = 1

    elapsed = time.perf_counter() - t0
    if args.update_baseline:
        return 0

    if args.markdown:
        pathlib.Path(args.markdown).write_text(
            perf.markdown_report(suite_verdicts, hw_name=label, slack=args.slack)
        )
    if args.report:
        pathlib.Path(args.report).write_text(json.dumps(
            perf.json_report(
                suite_verdicts, suite_records, hw_name=label,
                slack=args.slack, elapsed_s=elapsed,
            ),
            indent=1,
        ) + "\n")

    totals = perf.summarize([v for vs in suite_verdicts.values() for v in vs])
    print(f"perfguard[{'smoke' if smoke else 'full'}]: "
          + ", ".join(f"{k}={n}" for k, n in totals.items())
          + f", {elapsed:.1f}s — {'OK' if rc == 0 else 'GATE FAILED'}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
