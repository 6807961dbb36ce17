"""Differential execution: every grid scenario vs the ``np.sort`` oracle
(DESIGN.md §7); the port's copy of ``repro.verify.differential``.

Each :class:`~repro_torch.verify.grid.Scenario` is forced down its declared
(path, method) via an explicit :class:`~repro_torch.core.engine.SortPlan` — the
same calling convention ``benchmarks/bench_engine.py`` uses for its fixed
baselines — so the grid exercises the executors directly rather than
whatever ``choose_plan`` would have picked.  Engines are cached per
topology so the warm executor cache works *for* the sweep: two scenarios
in the same shape bucket share one executor.  Every engine runs on the
card unless the cache is asked for the CPU (``EngineCache(device="cpu")``),
where the kernels' wrappers take their plain versions.

Checks per scenario:

* **oracle**     — output equals ``np.sort(input)`` exactly, dtype preserved;
* **conservation** — the executor's element accounting (``counts_sum``)
  matches ``n`` (no silent capacity drops);
* **cross-path** — :func:`cross_check` then asserts byte-equality between
  every pair of paths/methods that sorted the same input array, which
  catches oracle *and* comparison bugs that a single-path check can hide.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import OHHCTopology, SortEngine, SortPlan, autotune_capacity
from repro_torch.core.engine import _DIST_TODO
from repro_torch.verify.grid import (
    FAULT_IMPOSSIBLE,
    FaultCell,
    OpScenario,
    Scenario,
    SegmentScenario,
)


@dataclasses.dataclass
class ScenarioResult:
    """Outcome of one scenario run.  ``output`` is held only for the
    in-memory cross-check; baselines persist the stable fields."""

    scenario: Scenario
    status: str  # 'pass' | 'fail'
    detail: str
    path: str
    method: str
    capacity: int | None
    retries: int
    counts_sum: int | None
    elapsed_s: float
    output: np.ndarray | None = None

    @property
    def scenario_id(self) -> str:
        return self.scenario.scenario_id


class EngineCache:
    """One SortEngine per (d_h, variant) — shared executor caches.

    ``device`` is every engine's device: ``None`` (the card) or ``"cpu"``.
    The dist path over a mesh is not ported: ``devices > 1`` and a dist
    scenario raise ``NotImplementedError`` rather than being pruned.
    """

    def __init__(self, *, devices: int = 1, device=None):
        if int(devices) > 1:
            raise NotImplementedError(_DIST_TODO)
        self.devices = int(devices)
        self.device = device
        self._engines: dict[tuple, SortEngine] = {}

    def segment_engine(self) -> SortEngine:
        """The shared single-box engine the segment cells run on (d_h=1 —
        the segment path's method is forced per cell, so topology only
        sizes the never-used bucket fallback)."""
        key = (1, "full")
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = SortEngine(
                OHHCTopology(1, "full"), device=self.device
            )
        return eng

    def fault_engine(self, cell: FaultCell) -> SortEngine:
        """One engine per fault-grid topology, *shared across fault
        classes* — the degraded grid deliberately switches scenarios on a
        warm engine so stale-plan bugs (DESIGN.md §11) would surface as
        wrong cells here, not just in the unit tests."""
        key = ("fault", cell.d_h, cell.variant)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = SortEngine(
                OHHCTopology(cell.d_h, cell.variant), device=self.device
            )
        return eng

    def engine_for(self, sc: Scenario) -> SortEngine:
        if sc.path == "dist":
            raise NotImplementedError(_DIST_TODO)
        key = (sc.d_h, sc.variant)
        eng = self._engines.get(key)
        if eng is None:
            topo = OHHCTopology(sc.d_h, sc.variant)
            eng = self._engines[key] = SortEngine(topo, device=self.device)
        return eng


def forced_plan(eng: SortEngine, sc: Scenario, x: np.ndarray) -> SortPlan:
    """Pin the scenario's (path, method); capacity still comes from the
    engine's measured autotune so the grid validates the capacity model too."""
    if sc.path == "host":
        return SortPlan("host", sc.method, None, None, "verify grid")
    if sc.path == "dist":
        return SortPlan("dist", sc.method, None, None, "verify grid")
    from repro_torch.kernels import ops

    stats = eng.stats(x)
    padded = ops.bucketed_length(x.size)
    cap = autotune_capacity(stats, sc.method, eng.topo.total_procs, padded)
    return SortPlan("sim", sc.method, cap, padded, "verify grid")


def run_scenario(
    sc: Scenario, engines: EngineCache, *, keep_output: bool = True
) -> ScenarioResult:
    """Execute one scenario against the oracle."""
    x = sc.make_input()
    oracle = np.sort(x)
    eng = engines.engine_for(sc)
    t0 = time.perf_counter()
    try:
        plan = forced_plan(eng, sc, x)
        out = eng.sort(x, plan=plan)
    except Exception as e:  # an executor crash is a finding, not an abort
        return ScenarioResult(
            sc, "fail", f"error: {type(e).__name__}: {e}", sc.path, sc.method,
            None, 0, None, time.perf_counter() - t0,
        )
    elapsed = time.perf_counter() - t0
    report = eng.last_report or {}
    capacity = report.get("capacity_used", plan.capacity)
    retries = int(report.get("overflow_retries", 0))
    counts_sum = report.get("counts_sum")
    counts_sum = int(counts_sum) if counts_sum is not None else None

    out = np.asarray(out)
    if out.dtype != x.dtype:
        status, detail = "fail", f"dtype changed: {x.dtype} -> {out.dtype}"
    elif out.shape != oracle.shape:
        status, detail = "fail", f"shape changed: {oracle.shape} -> {out.shape}"
    elif not np.array_equal(out, oracle):
        bad = int(np.flatnonzero(out != oracle)[0])
        status = "fail"
        detail = (
            f"oracle mismatch at index {bad}: got {out[bad]!r}, "
            f"want {oracle[bad]!r}"
        )
    elif counts_sum is not None and counts_sum != x.size:
        status, detail = "fail", f"element accounting: counts_sum={counts_sum} != n={x.size}"
    else:
        status, detail = "pass", ""
    return ScenarioResult(
        sc, status, detail, sc.path, sc.method, capacity, retries,
        counts_sum, elapsed, out if keep_output else None,
    )


def run_segment_scenario(
    sc: SegmentScenario, engines: EngineCache, *, keep_output: bool = True
) -> ScenarioResult:
    """One segmented-batch cell: force the row-sort method through
    ``sort_segments(plan=...)`` and oracle every row against ``np.sort``.

    The stored output is the concatenation of the sorted segments, so the
    cross-check asserts byte-agreement between the vmapped XLA backend and
    both fused row-kernel variants on the same batch.
    """
    from repro_torch.kernels import ops

    flat, lens = sc.make_batch()
    eng = engines.segment_engine()
    padded_n = ops.bucketed_length(max(lens) if lens else 1)
    plan = SortPlan("sim", sc.method, None, padded_n, "verify segment grid")
    t0 = time.perf_counter()
    try:
        outs = eng.sort_segments(flat, lens, plan=plan)
    except Exception as e:  # an executor crash is a finding, not an abort
        return ScenarioResult(
            sc, "fail", f"error: {type(e).__name__}: {e}", "sim", sc.method,
            None, 0, None, time.perf_counter() - t0,
        )
    elapsed = time.perf_counter() - t0
    report = eng.last_report or {}
    retries = int(report.get("overflow_retries", 0))
    method = getattr(report.get("plan"), "method", sc.method)
    status, detail = "pass", ""
    oracle_rows = np.split(flat, np.cumsum(lens)[:-1]) if lens else []
    for i, (seg, n) in enumerate(zip(outs, lens)):
        seg = np.asarray(seg)
        want = np.sort(oracle_rows[i])
        if seg.dtype != flat.dtype:
            status, detail = "fail", f"row {i}: dtype {flat.dtype} -> {seg.dtype}"
            break
        if seg.shape != (n,):
            status, detail = "fail", f"row {i}: length {seg.size} != {n}"
            break
        if not np.array_equal(seg, want):
            bad = int(np.flatnonzero(seg != want)[0])
            status = "fail"
            detail = (
                f"row {i} oracle mismatch at {bad}: got {seg[bad]!r}, "
                f"want {want[bad]!r}"
            )
            break
    out_flat = (
        np.concatenate([np.asarray(o) for o in outs]) if lens else np.zeros(0)
    )
    return ScenarioResult(
        sc, status, detail, "sim", method, None, retries, None, elapsed,
        out_flat if keep_output else None,
    )


def run_segment_grid(
    scenarios: "Sequence[SegmentScenario]",
    *,
    keep_outputs: bool = True,
    progress: "Callable[[ScenarioResult], None] | None" = None,
    engines: "EngineCache | None" = None,
) -> list[ScenarioResult]:
    """Run every segment cell (same contract as :func:`run_grid`)."""
    if engines is None:
        engines = EngineCache(devices=1)
    results = []
    for sc in scenarios:
        r = run_segment_scenario(sc, engines, keep_output=keep_outputs)
        results.append(r)
        if progress is not None:
            progress(r)
    return results


def run_fault_scenario(
    cell: FaultCell, engines: EngineCache, *, keep_output: bool = True
) -> ScenarioResult:
    """One degraded-topology cell: set the engine's fault scenario, force
    the requested (path, method), and oracle the result.

    The pins beyond the oracle (DESIGN.md §11):

    * a degraded-but-possible scenario must *execute* on the requested
      path with the plan annotated (``plan.fault`` + predicted slowdown);
    * an impossible scenario (``FAULT_IMPOSSIBLE``) forced onto ``sim``
      must come back on the typed host fallback — never an error, never
      a wrong answer;
    * the recorded ``path`` is the *executed* one, so the committed
      baseline pins which rung of the fallback ladder every cell lands on.
    """
    x = cell.make_input()
    oracle = np.sort(x)
    eng = engines.fault_engine(cell)
    t0 = time.perf_counter()
    try:
        scenario = cell.scenario(eng.topo)
        eng.set_fault_scenario(scenario)
        plan = forced_plan(eng, cell, x)
        out = eng.sort(x, plan=plan)
    except Exception as e:  # an executor crash is a finding, not an abort
        return ScenarioResult(
            cell, "fail", f"error: {type(e).__name__}: {e}", cell.path,
            cell.method, None, 0, None, time.perf_counter() - t0,
        )
    finally:
        eng.set_fault_scenario(None)  # engines are shared; never leak faults
    elapsed = time.perf_counter() - t0
    report = eng.last_report or {}
    executed = report.get("plan")
    path = getattr(executed, "path", cell.path)
    method = getattr(executed, "method", cell.method)
    fault_name = getattr(executed, "fault", None)
    capacity = report.get("capacity_used", plan.capacity)
    retries = int(report.get("overflow_retries", 0))
    counts_sum = report.get("counts_sum")
    counts_sum = int(counts_sum) if counts_sum is not None else None

    out = np.asarray(out)
    impossible = cell.fault in FAULT_IMPOSSIBLE
    if out.dtype != x.dtype:
        status, detail = "fail", f"dtype changed: {x.dtype} -> {out.dtype}"
    elif out.shape != oracle.shape:
        status, detail = "fail", f"shape changed: {oracle.shape} -> {out.shape}"
    elif not np.array_equal(out, oracle):
        bad = int(np.flatnonzero(out != oracle)[0])
        status = "fail"
        detail = (
            f"oracle mismatch at index {bad}: got {out[bad]!r}, "
            f"want {oracle[bad]!r}"
        )
    elif counts_sum is not None and counts_sum != x.size:
        status, detail = "fail", f"element accounting: counts_sum={counts_sum} != n={x.size}"
    elif scenario is not None and fault_name != scenario.name:
        status = "fail"
        detail = f"plan not annotated: plan.fault={fault_name!r}, want {scenario.name!r}"
    elif impossible and cell.path == "sim" and path != "host":
        status = "fail"
        detail = f"impossible scenario executed on {path!r}, want host fallback"
    elif scenario is not None and not impossible and path != cell.path:
        status = "fail"
        detail = f"possible scenario bumped off {cell.path!r} onto {path!r}"
    else:
        status, detail = "pass", ""
    return ScenarioResult(
        cell, status, detail, path, method, capacity, retries,
        counts_sum, elapsed, out if keep_output else None,
    )


def run_fault_grid(
    cells: "Sequence[FaultCell]",
    *,
    keep_outputs: bool = True,
    progress: "Callable[[ScenarioResult], None] | None" = None,
    engines: "EngineCache | None" = None,
) -> list[ScenarioResult]:
    """Run every degraded-grid cell (same contract as :func:`run_grid`)."""
    if engines is None:
        engines = EngineCache(devices=1)
    results = []
    for cell in cells:
        r = run_fault_scenario(cell, engines, keep_output=keep_outputs)
        results.append(r)
        if progress is not None:
            progress(r)
    return results


def run_grid(
    scenarios: Sequence[Scenario],
    *,
    devices: int = 1,
    keep_outputs: bool = True,
    progress: "Callable[[ScenarioResult], None] | None" = None,
    engines: "EngineCache | None" = None,
) -> list[ScenarioResult]:
    """Run every scenario (pre-pruned ones are the caller's business —
    anything handed in is executed) and return results in grid order.

    Pass ``engines`` to reuse warm executor caches across sweeps (e.g. a
    warm-up pass before a timed pass — ``benchmarks/bench_verify.py``).
    """
    if engines is None:
        engines = EngineCache(devices=devices)
    results = []
    for sc in scenarios:
        r = run_scenario(sc, engines, keep_output=keep_outputs)
        results.append(r)
        if progress is not None:
            progress(r)
    return results


def _op_pytree_payload(x: np.ndarray) -> dict:
    """The conformance payload for ``pairs_pytree`` cells: a nested
    dict/tuple with mixed dtypes (64-bit, float, sub-byte-range int) so the
    leaf gather is exercised on every byte width at once."""
    idx = np.arange(x.size, dtype=np.int64)
    return {
        "idx": idx,
        "nested": (x.astype(np.float64), (idx % 251).astype(np.int8)),
    }


def run_op_scenario(
    sc: OpScenario, engines: EngineCache, *, keep_output: bool = True
) -> ScenarioResult:
    """Execute one workload-op cell (DESIGN.md §12) against its oracle.

    Per-op oracle:

    * ``sort``         — ``np.sort(x)`` (the baseline the others share);
    * ``top_k``        — ``np.sort(x)[:k]``, and the plan's ``reason`` must
      carry the ``skipped=`` bucket accounting of the plan;
    * ``pairs_pytree`` — keys equal ``np.sort(x)``; the ``idx`` leaf is a
      valid permutation and every other leaf is byte-identical to
      ``leaf[perm]`` (the gather contract);
    * ``merge``        — host-sorted prefix + chunked ``merge_sorted``
      folds of the remainder equals ``np.sort(x)``.

    The stored ``output`` is always the fully-sorted key view the op
    implies (the head for top-k), so cells sharing a ``group_id`` —
    ``sort``/``pairs_pytree``/``merge`` on the same input — byte-compare
    against each other in :func:`cross_check`.
    """
    x = sc.make_input()
    oracle = np.sort(x)
    eng = engines.segment_engine()
    t0 = time.perf_counter()
    try:
        if sc.op == "sort":
            out = np.asarray(eng.sort(x))
            want = oracle
        elif sc.op == "top_k":
            out = np.asarray(eng.top_k(x, sc.k))
            want = oracle[: sc.k]
        elif sc.op == "pairs_pytree":
            keys_s, vals_s = eng.sort_pairs(x, _op_pytree_payload(x))
            out = np.asarray(keys_s)
            want = oracle
        elif sc.op == "merge":
            split = 2 * x.size // 3
            buf = np.sort(x[:split])
            rest = x[split:]
            for chunk in np.array_split(rest, 3):
                buf = eng.merge_sorted(buf, chunk)
            out = np.asarray(buf)
            want = oracle
        else:  # pragma: no cover - pruned upstream
            raise ValueError(f"unknown op {sc.op!r}")
    except Exception as e:  # an executor crash is a finding, not an abort
        return ScenarioResult(
            sc, "fail", f"error: {type(e).__name__}: {e}", sc.path, sc.method,
            None, 0, None, time.perf_counter() - t0,
        )
    elapsed = time.perf_counter() - t0
    report = eng.last_report or {}
    plan = report.get("plan")
    path = plan.path if plan is not None else "host"
    method = plan.method if plan is not None else sc.op
    capacity = report.get("capacity_used")
    capacity = int(capacity) if capacity is not None else None
    retries = int(report.get("overflow_retries", 0))
    counts_sum = report.get("counts_sum")
    counts_sum = int(counts_sum) if counts_sum is not None else None

    status, detail = "pass", ""
    if out.dtype != x.dtype:
        status, detail = "fail", f"dtype changed: {x.dtype} -> {out.dtype}"
    elif out.shape != want.shape:
        status, detail = "fail", f"shape changed: {want.shape} -> {out.shape}"
    elif not np.array_equal(out, want):
        bad = int(np.flatnonzero(out != want)[0])
        status = "fail"
        detail = (
            f"oracle mismatch at index {bad}: got {out[bad]!r}, "
            f"want {want[bad]!r}"
        )
    elif sc.op == "top_k":
        if plan is None or "skipped=" not in (plan.reason or ""):
            status = "fail"
            detail = (
                "top_k plan reason lacks skipped-bucket accounting: "
                f"{plan.reason if plan is not None else None!r}"
            )
        elif int(report.get("kept_count", 0)) < sc.k:
            status = "fail"
            detail = (
                f"kept_count={report.get('kept_count')} < k={sc.k} "
                "after retries — cut under-covers the head"
            )
    elif sc.op == "pairs_pytree":
        perm = np.asarray(vals_s["idx"])
        f64, i8 = vals_s["nested"]
        if not np.array_equal(np.sort(perm), np.arange(x.size)):
            status, detail = "fail", "payload idx leaf is not a permutation"
        elif np.asarray(f64).tobytes() != x.astype(np.float64)[perm].tobytes():
            status, detail = "fail", "float64 leaf not gathered by idx perm"
        elif np.asarray(i8).tobytes() != (
            (np.arange(x.size, dtype=np.int64) % 251).astype(np.int8)[perm]
        ).tobytes():
            status, detail = "fail", "int8 leaf not gathered by idx perm"
    elif sc.op == "sort" and counts_sum is not None and counts_sum != x.size:
        status = "fail"
        detail = f"element accounting: counts_sum={counts_sum} != n={x.size}"
    return ScenarioResult(
        sc, status, detail, path, method, capacity, retries,
        counts_sum, elapsed, out if keep_output else None,
    )


def run_op_grid(
    scenarios: "Sequence[OpScenario]",
    *,
    keep_outputs: bool = True,
    progress: "Callable[[ScenarioResult], None] | None" = None,
    engines: "EngineCache | None" = None,
) -> list[ScenarioResult]:
    """Run every workload-op cell (same contract as :func:`run_grid`)."""
    if engines is None:
        engines = EngineCache(devices=1)
    results = []
    for sc in scenarios:
        r = run_op_scenario(sc, engines, keep_output=keep_outputs)
        results.append(r)
        if progress is not None:
            progress(r)
    return results


def cross_check(results: Sequence[ScenarioResult]) -> list[str]:
    """Pairwise differential check: all paths/methods that sorted the same
    input must produce byte-identical output, *including* scenarios that
    failed the oracle (so a divergence is reported both as the failing
    cell and as a localized path-vs-path disagreement).  Returns mismatch
    messages."""
    groups: dict[str, list[ScenarioResult]] = {}
    for r in results:
        if r.output is not None:
            groups.setdefault(r.scenario.group_id, []).append(r)
    mismatches = []
    for gid, members in groups.items():
        ref = members[0]
        for other in members[1:]:
            if not np.array_equal(ref.output, other.output):
                mismatches.append(
                    f"{gid}: {ref.scenario_id} and {other.scenario_id} disagree"
                )
    return mismatches


