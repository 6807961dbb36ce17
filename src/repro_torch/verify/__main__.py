"""Paper-grid conformance runner over the port (DESIGN.md §7).

The port's copy of the reference runner ``tools/verify.py``.  Sweeps the
verify grid (``repro_torch.verify.grid``), checks every scenario against
the ``np.sort`` oracle plus cross-path agreement, runs the
metamorphic/fault property battery on a representative slice, and gates
the result on the committed port baseline
(``tests/baselines/verify_smoke_torch.json``, whose scenarios equal the
reference's ``verify_smoke.json``) — any plan/capacity/status drift fails
the run until the baseline is explicitly re-recorded.

Usage::

    PYTHONPATH=src python -m repro_torch.verify --smoke               # on the card
    PYTHONPATH=src python -m repro_torch.verify --smoke --device cpu  # plain versions
    PYTHONPATH=src python -m repro_torch.verify --smoke --device cpu --update-baseline
    PYTHONPATH=src python -m repro_torch.verify --full
    PYTHONPATH=src python -m repro_torch.verify --smoke --filter uint32
    PYTHONPATH=src python -m repro_torch.verify --smoke --devices 4

``--device cuda`` (the default) runs every engine on the card and raises
where there is none; ``--device cpu`` runs the kernels' plain versions.
``--devices N`` adds the grid's dist cells (``smoke_grid(devices=N,
mesh_axes=2 if N ≥ 4 and N is even else 1)``, as the reference runner) and
runs them on N spawned ranks (``runtime.ranks.run_ranks``); every other
cell runs here, once.  The ranks' backend follows one rule, and the
summary line names it: gloo on the CPU, nccl when every rank has a card
of its own, gloo when ranks share a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = ROOT / "tests" / "baselines" / "verify_smoke_torch.json"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true", help="pruned CI grid (default)")
    mode.add_argument("--full", action="store_true", help="the whole paper grid")
    mode.add_argument("--tier1", action="store_true", help="the fast pytest subset")
    mode.add_argument("--sortd", action="store_true",
                      help="sortd serving-layer smoke slice (DESIGN.md §8): "
                      "live micro-batching service vs the np.sort oracle")
    mode.add_argument("--degraded", action="store_true",
                      help="degraded-topology slice only (DESIGN.md §11): "
                      "the fault grid + fault properties, drift-gated "
                      "against the committed smoke baseline")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every engine runs (cpu: the kernels' plain versions)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks for the dist scenarios (spawned; 1: no dist cells)")
    ap.add_argument("--filter", default=None,
                    help="substring filter on scenario ids")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default for --smoke: {DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="record outcomes as the new baseline instead of gating")
    ap.add_argument("--report", default=None,
                    help="write the full JSON report (CI artifact) here")
    ap.add_argument("--skip-properties", action="store_true",
                    help="grid only; skip the metamorphic/fault battery")
    ap.add_argument("-q", "--quiet", action="store_true")
    return ap.parse_args(argv)


def run_sortd_slice(args) -> int:
    """Serving-layer smoke: a live sortd instance must agree with np.sort.

    Submits a (dtype × distribution × size) request grid — including
    oversize requests beyond the largest coalescible bucket — from two
    concurrent client threads, checks every result against the oracle, and
    sanity-checks the service's own accounting (completion count, flush
    reasons, per-bucket latency/pad-waste invariants).
    """
    import threading

    import numpy as np

    from repro_torch.core import SortEngine
    from repro_torch.data import make_array
    from repro_torch.serve.sortd import Sortd, SortdConfig

    cfg = SortdConfig(max_batch=32, max_wait_s=0.005, max_bucket=1 << 12)
    eng = SortEngine(device=args.device)
    cases = []
    seed = 0
    for dtype in ("int32", "int16", "uint32", "float32"):
        for dist in ("random", "sorted", "dupes", "local"):
            for n in (37, 513, 2048):
                seed += 1
                cases.append(
                    (f"{dtype}/{dist}/{n}",
                     make_array(dist, n, seed=seed, dtype=np.dtype(dtype)))
                )
    # oversize → the direct per-array engine path
    cases.append(("int32/random/oversize",
                  make_array("random", (1 << 12) + 777, seed=99)))

    t0 = time.perf_counter()
    fails = []
    with Sortd(eng, cfg) as sd:
        futs = [None] * len(cases)

        def submit_range(lo, hi):
            for i in range(lo, hi):
                futs[i] = sd.submit(cases[i][1])

        mid = len(cases) // 2
        threads = [
            threading.Thread(target=submit_range, args=(0, mid)),
            threading.Thread(target=submit_range, args=(mid, len(cases))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for (name, x), fut in zip(cases, futs):
            try:
                out = fut.result(timeout=120)
            except Exception as e:  # noqa: BLE001 - report, don't crash the slice
                fails.append((name, f"raised {e!r}"))
                continue
            if not np.array_equal(out, np.sort(x)):
                fails.append((name, "result != np.sort oracle"))
        m = sd.metrics()

    if m["completed"] != len(cases):
        fails.append(("metrics", f"completed {m['completed']} != {len(cases)}"))
    if m["oversize_direct"] < 1:
        fails.append(("metrics", "oversize request did not take the direct path"))
    if sum(m["flushes"].values()) < 1:
        fails.append(("metrics", "no flush recorded"))
    for bucket, b in m["buckets"].items():
        if not (0.0 <= b["pad_waste"] < 1.0):
            fails.append((f"bucket {bucket}", f"pad_waste {b['pad_waste']}"))
        if b["p99_ms"] + 1e-9 < b["p50_ms"]:
            fails.append((f"bucket {bucket}", "p99 < p50"))
    elapsed = time.perf_counter() - t0
    if args.report:
        pathlib.Path(args.report).write_text(json.dumps({
            "mode": "sortd",
            "device": args.device,
            "elapsed_s": elapsed,
            "cases": len(cases),
            "fails": [list(f) for f in fails],
            "metrics": m,
        }, indent=1) + "\n")
    print(
        f"verify[sortd]: {len(cases) - len(fails)}/{len(cases)} requests pass, "
        f"{len(m['buckets'])} shape buckets, flushes={m['flushes']}, "
        f"p50={m['latency_ms']['p50']:.1f}ms p99={m['latency_ms']['p99']:.1f}ms, "
        f"{elapsed:.1f}s"
    )
    for name, detail in fails:
        print(f"FAIL {name}: {detail}")
    return 1 if fails else 0


def ranks_backend(args) -> str:
    """gloo on the CPU or where ranks share a card, else nccl (one rank a
    card)."""
    if args.device == "cpu":
        return "gloo"
    import torch

    return "nccl" if args.devices <= torch.cuda.device_count() else "gloo"


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.sortd:
        return run_sortd_slice(args)

    import numpy as np

    from repro_torch.core import OHHCTopology, SortEngine
    from repro_torch.data import make_array
    from repro_torch.verify import baseline as bl
    from repro_torch.verify import differential, grid, properties

    # the property battery's engine; built first, so a run on a missing
    # card fails before any cell
    eng = SortEngine(OHHCTopology(1, "full"), device=args.device)
    mesh_axes = 2 if args.devices >= 4 and args.devices % 2 == 0 else 1
    if args.full:
        mode = "full"
        scenarios = grid.full_grid(devices=args.devices, mesh_axes=mesh_axes)
        segments = grid.segment_smoke_grid()
        faults = grid.fault_grid()
        ops_cells = grid.op_smoke_grid()
    elif args.tier1:
        mode = "tier1"
        scenarios = grid.tier1_grid()
        segments = grid.segment_tier1_grid()
        faults = []
        ops_cells = grid.op_tier1_grid()
    elif args.degraded:
        # The fault slice alone (fast CI lane): its cells are a subset of
        # the committed smoke baseline, so the drift gate still applies.
        mode = "degraded"
        scenarios = []
        segments = []
        faults = grid.fault_grid()
        ops_cells = []
    else:
        mode = "smoke"
        scenarios = grid.smoke_grid(devices=args.devices, mesh_axes=mesh_axes)
        segments = grid.segment_smoke_grid()
        faults = grid.fault_grid()
        ops_cells = grid.op_smoke_grid()
    pruned = grid.pruned_cells(devices=args.devices, mesh_axes=mesh_axes)
    if args.filter:
        scenarios = [sc for sc in scenarios if args.filter in sc.scenario_id]
        segments = [sc for sc in segments if args.filter in sc.scenario_id]
        faults = [sc for sc in faults if args.filter in sc.scenario_id]
        ops_cells = [sc for sc in ops_cells if args.filter in sc.scenario_id]

    baseline_path = pathlib.Path(
        args.baseline
        if args.baseline
        else (DEFAULT_BASELINE if mode in ("smoke", "tier1", "degraded") else "")
        or f"verify_{mode}_baseline.json"
    )
    # The committed smoke baseline records the devices=1 grid; gate against
    # it only when this run executes that same grid (or a filtered/tier1/
    # degraded subset of it) — a multi-rank sweep adds dist cells the
    # baseline legitimately doesn't carry, which is coverage, not drift.
    subset_run = bool(args.filter) or mode in ("tier1", "degraded")
    comparable = args.baseline is not None or (
        mode in ("smoke", "tier1", "degraded") and args.devices == 1
    )
    if args.update_baseline and baseline_path.resolve() == DEFAULT_BASELINE.resolve() and (
        subset_run or args.devices != 1 or mode != "smoke"
    ):
        # Never let a partial or differently-configured run silently shrink
        # the committed smoke baseline out from under CI; refuse up front.
        print(
            "refusing --update-baseline: the committed smoke baseline must "
            "be recorded by a plain `--smoke` run (no --filter, --devices 1); "
            "pass --baseline PATH to record elsewhere"
        )
        return 2

    t0 = time.perf_counter()
    done = {"n": 0}
    total = len(scenarios) + len(segments) + len(faults) + len(ops_cells)

    def progress(r):
        done["n"] += 1
        if not args.quiet and (r.status != "pass" or done["n"] % 25 == 0):
            print(
                f"[{done['n']:4d}/{total}] {r.status:4s} "
                f"{r.scenario_id}  {r.detail}",
                flush=True,
            )

    engines = differential.EngineCache(device=args.device)
    dist_cells = [sc for sc in scenarios if sc.path == "dist"]
    backend = ranks_backend(args) if dist_cells else None
    results = differential.run_grid(
        [sc for sc in scenarios if sc.path != "dist"], progress=progress, engines=engines
    )
    if dist_cells:
        from repro_torch.runtime.ranks import run_ranks

        # every rank runs every dist cell (SPMD); a cell fails if it
        # failed on any rank, and reports rank 0's outcome otherwise
        per_rank = run_ranks(
            differential.run_dist_cells, (args.devices,), ("data",), backend=backend,
            device=args.device, args=(dist_cells, args.device),
        )
        by_id = {r.scenario_id: r for r in results}
        for cell in zip(*per_rank):
            r = next((r for r in cell if r.status != "pass"), cell[0])
            by_id[r.scenario_id] = r
            progress(r)
        results = [by_id[sc.scenario_id] for sc in scenarios]
    # Segmented-batch cells ride the same result stream: cross_check then
    # asserts byte-agreement between the library row backend and both
    # variants of the row kernel (shared group_id), and the baseline gates
    # their drift.
    results += differential.run_segment_grid(
        segments, progress=progress, engines=engines
    )
    # Degraded-topology cells too (DESIGN.md §11): each topology's healthy
    # cell anchors a cross-check group, so every degraded run and typed
    # host fallback must match its bytes exactly.
    results += differential.run_fault_grid(
        faults, progress=progress, engines=engines
    )
    # Workload-op cells (DESIGN.md §12): top-k / pytree pairs / streaming
    # merge vs their np.partition-style oracles; the full-output ops share
    # cross-check groups with plain sort on the same input.
    results += differential.run_op_grid(
        ops_cells, progress=progress, engines=engines
    )
    mismatches = differential.cross_check(results)
    fails = [r for r in results if r.status != "pass"]

    prop_results = []
    if not args.skip_properties:
        if mode != "degraded":  # the fault lane runs only the fault battery
            for dist in ("random", "sorted", "dupes", "local"):
                for dtype in ("int32", "uint32"):
                    x = make_array(dist, 1024, seed=11, dtype=np.dtype(dtype))
                    prop_results += properties.metamorphic_checks(
                        eng, x, subject=f"{dtype}/{dist}"
                    )
            keys = make_array("dupes", 500, seed=5)
            prop_results += properties.pairs_pairing_check(
                eng, keys, np.arange(keys.size, dtype=np.int32), subject="int32/dupes"
            )
        x = make_array("local", 2048, seed=9)
        prop_results += properties.fault_replay_for_engine_run(eng, x)
        for d_h in (1, 2):
            t = OHHCTopology(d_h, "full")
            prop_results += properties.fault_replay(
                t, [17] * t.total_procs, groups=(1,)
            )
    prop_fails = [p for p in prop_results if p.status != "pass"]

    doc = bl.build_baseline(results, grid=mode)
    drift = None
    baseline_missing = False
    if args.update_baseline:
        bl.save_baseline(doc, baseline_path)
        print(f"baseline recorded: {baseline_path} ({len(results)} scenarios)")
    elif comparable:
        if baseline_path.exists():
            drift = bl.diff_baselines(
                doc, bl.load_baseline(baseline_path),
                ignore_missing_in_current=subset_run,
            )
        else:
            # The gate is the point: a comparable run with no baseline to
            # gate against must fail loudly, not silently pass (e.g. the
            # committed file lost in a bad merge).
            baseline_missing = True

    elapsed = time.perf_counter() - t0
    if args.report:
        report = {
            "mode": mode,
            "device": args.device,
            "devices": args.devices,
            "backend": backend,
            "elapsed_s": elapsed,
            "scenario_count": len(results),
            "pruned_count": len(pruned),
            "fails": [
                {"scenario": r.scenario_id, "detail": r.detail} for r in fails
            ],
            "cross_check_mismatches": mismatches,
            "property_checks": [dataclasses.asdict(p) for p in prop_results],
            "pruned": [
                {"scenario": sc.scenario_id, "reason": reason}
                for sc, reason in pruned
            ],
            "drift": None if drift is None else {
                "clean": drift.clean,
                "added": list(drift.added),
                "removed": list(drift.removed),
                "changed": [list(c) for c in drift.changed],
            },
            "baseline": doc,
        }
        pathlib.Path(args.report).write_text(json.dumps(report, indent=1) + "\n")

    print(
        f"verify[{mode}]: {len(results) - len(fails)}/{len(results)} scenarios pass, "
        f"{len(pruned)} cells pruned, {len(mismatches)} cross-check mismatches, "
        f"{len(prop_results) - len(prop_fails)}/{len(prop_results)} property checks "
        f"pass, {elapsed:.1f}s on {eng.device}"
        + (f"; {len(dist_cells)} dist cells on {args.devices} ranks over {backend}" if dist_cells else "")
    )
    rc = 0
    if fails or mismatches or prop_fails:
        for r in fails:
            print(f"FAIL {r.scenario_id}: {r.detail}")
        for m in mismatches:
            print(f"CROSS-CHECK {m}")
        for p in prop_fails:
            print(f"PROPERTY {p.check}[{p.subject}]: {p.detail}")
        rc = 1
    if drift is not None:
        if drift.clean:
            print(f"baseline: no drift vs {baseline_path}")
        else:
            print(f"baseline DRIFT vs {baseline_path} "
                  "(re-record with --update-baseline if intended):")
            print(drift.summary())
            rc = 1
    elif baseline_missing:
        print(
            f"baseline MISSING: {baseline_path} — the drift gate cannot run; "
            "restore the committed file or re-record with --update-baseline"
        )
        rc = 1
    elif not args.update_baseline:
        print(
            "baseline: not gated (grid config differs from the committed "
            "devices=1 smoke baseline; pass --baseline to compare anyway)"
        )
    return rc



if __name__ == "__main__":
    sys.exit(main())
