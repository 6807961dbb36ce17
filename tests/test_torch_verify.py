"""repro_torch.verify: the port's conformance runner against the JAX
package's ``repro.verify``.

The reference's own tests (``tests/test_verify.py``) run here over the
port (``device="cpu"``: every kernel wrapper takes its plain version);
then the grids are held to the reference's cell for cell, the whole smoke
run to the committed baselines, the tier-1 cells to the JAX runner output
for output (the JAX engine running its Pallas kernels in interpret mode),
and the CLI ``python -m repro_torch.verify`` in a subprocess.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import OHHCTopology as JaxOHHCTopology
from repro.core import SortEngine as JaxSortEngine
from repro.kernels import ops as jops
from repro.verify import baseline as jbaseline
from repro.verify import differential as jdifferential
from repro.verify import grid as jgrid
from repro_torch.core import OHHCTopology, SortEngine
from repro_torch.data import ALL_DISTRIBUTIONS, make_array
from repro_torch.verify import (
    DriftReport,
    Scenario,
    build_baseline,
    cross_check,
    diff_baselines,
    fault_replay,
    load_baseline,
    metamorphic_checks,
    pairs_pairing_check,
    prune_reason,
    run_grid,
    save_baseline,
    smoke_grid,
    tier1_grid,
)
from repro_torch.verify import baseline as bl
from repro_torch.verify import differential, grid
from repro_torch.verify.differential import EngineCache
from repro_torch.verify.properties import fault_replay_for_engine_run

pytestmark = pytest.mark.conformance

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE_PATH = ROOT / "tests" / "baselines" / "verify_smoke_torch.json"
JAX_BASELINE_PATH = ROOT / "tests" / "baselines" / "verify_smoke.json"

# One engine per topology for the whole module: the warm executor cache is
# part of what the conformance battery exercises.
ENGINE = SortEngine(OHHCTopology(1, "full"), device="cpu")


def cpu_engines() -> EngineCache:
    return EngineCache(device="cpu")


# ------------------------------------------------------------------ grid
def test_smoke_grid_is_big_unique_and_runnable():
    smoke = smoke_grid(devices=1)
    assert len(smoke) >= 100  # the smoke grid's coverage floor
    ids = [sc.scenario_id for sc in smoke]
    assert len(set(ids)) == len(ids)
    assert all(prune_reason(sc, devices=1) is None for sc in smoke)
    # every axis value the single-device environment can cover is covered
    assert {sc.path for sc in smoke} == {"sim", "host"}
    assert {sc.dist for sc in smoke} == set(ALL_DISTRIBUTIONS)
    assert {sc.d_h for sc in smoke} == {1, 2, 3}
    assert "int64" in {sc.dtype for sc in smoke}  # via the host path


def test_grid_pruning_rules():
    # dist needs a mesh
    sc = Scenario("dist", "sample", "int32", "random", 1024, 1)
    assert prune_reason(sc, devices=1) is not None
    assert prune_reason(sc, devices=4) is None
    # hier needs two mesh axes
    hier = Scenario("dist", "hier", "int32", "random", 1024, 1)
    assert prune_reason(hier, devices=4, mesh_axes=1) is not None
    assert prune_reason(hier, devices=4, mesh_axes=2) is None
    # 64-bit keys stay 64-bit on the port's device path; the reference's
    # rule (x64=False, the baseline grids') still prunes them there
    i64 = Scenario("sim", "paper", "int64", "random", 1024, 1)
    assert prune_reason(i64, devices=1) is None
    assert "64-bit" in prune_reason(i64, devices=1, x64=False)
    assert prune_reason(dataclasses.replace(i64, path="host"), devices=1, x64=False) is None
    # invalid method/path combos are named, not crashed on
    assert "invalid" in prune_reason(
        Scenario("sim", "hier", "int32", "random", 1024, 1)
    )


def test_tier1_is_subset_of_smoke():
    smoke_ids = {sc.scenario_id for sc in smoke_grid(devices=1)}
    tier1 = tier1_grid()
    assert tier1 and all(sc.scenario_id in smoke_ids for sc in tier1)


# ---------------------------------------------------- differential slice
def test_tier1_slice_passes_and_matches_committed_baseline():
    """The fast conformance gate: every tier-1 cell sorts exactly, paths
    agree pairwise, and the outcomes match the committed smoke baseline
    (so a plan/capacity policy change fails here until the baseline is
    re-recorded — the anti-silent-flip contract)."""
    results = run_grid(tier1_grid(), engines=cpu_engines())
    fails = [(r.scenario_id, r.detail) for r in results if r.status != "pass"]
    assert not fails, fails
    assert cross_check(results) == []
    doc = build_baseline(results, grid="tier1")
    committed = load_baseline(BASELINE_PATH)
    drift = diff_baselines(doc, committed, ignore_missing_in_current=True)
    assert drift.clean, drift.summary()


# ------------------------------------------------- metamorphic properties
@pytest.mark.parametrize("dist", ALL_DISTRIBUTIONS)
def test_metamorphic_battery_per_distribution(dist):
    x = make_array(dist, 1500, seed=21)
    for r in metamorphic_checks(ENGINE, x, subject=dist):
        assert r.status == "pass", (r.check, r.subject, r.detail)


@given(
    n=st.integers(2, 2500),
    seed=st.integers(0, 10_000),
    dist=st.sampled_from(list(ALL_DISTRIBUTIONS)),
)
@settings(max_examples=15, deadline=None)
def test_sort_output_is_permutation_of_input(n, seed, dist):
    """Not merely sorted — a permutation (multiset equality) for every
    distribution, so dropped/duplicated elements can't hide."""
    x = make_array(dist, n, seed=seed)
    out = np.asarray(ENGINE.sort(x))
    assert np.all(out[:-1] <= out[1:])
    vx, cx = np.unique(x, return_counts=True)
    vo, co = np.unique(out, return_counts=True)
    assert np.array_equal(vx, vo) and np.array_equal(cx, co)


def test_sort_pairs_pairing_preserved():
    keys = make_array("dupes", 700, seed=3)
    vals = np.arange(keys.size, dtype=np.int32)
    for r in pairs_pairing_check(ENGINE, keys, vals, subject="dupes"):
        assert r.status == "pass", (r.check, r.detail)


# ------------------------------------------------------------ fault stress
def test_fault_replay_with_engine_bucket_loads():
    """Degraded gathers deliver every element of a real engine run's
    bucket distribution, with no simulator-level reroutes left over."""
    x = make_array("local", 2048, seed=9)
    for r in fault_replay_for_engine_run(ENGINE, x):
        assert r.status == "pass", (r.check, r.subject, r.detail)


def test_fault_replay_uniform_d2():
    topo = OHHCTopology(2, "full")
    for r in fault_replay(topo, [13] * topo.total_procs, groups=(1, 5)):
        assert r.status == "pass", (r.check, r.subject, r.detail)


def test_fault_internal_node_raises_gather_impossible():
    from repro_torch.net.faults import FaultScenario, GatherImpossible, degraded_gather_rounds

    topo = OHHCTopology(1, "full")
    with pytest.raises(GatherImpossible):
        degraded_gather_rounds(
            topo, FaultScenario(name="master_down", failed_nodes=((0, 0),))
        )


# ------------------------------------------------------ baseline machinery
def test_baseline_roundtrip_reports_no_drift(tmp_path):
    results = run_grid(tier1_grid()[:6], engines=cpu_engines())
    doc = build_baseline(results, grid="unit")
    p = tmp_path / "b.json"
    save_baseline(doc, p)
    drift = diff_baselines(build_baseline(results, grid="unit"), load_baseline(p))
    assert drift.clean and drift.summary() == "no drift"


def test_baseline_drift_is_detected():
    rec = {"status": "pass", "path": "sim", "method": "paper", "capacity": 64, "retries": 0}
    base = {"schema": 1, "scenarios": {"a": dict(rec), "gone": dict(rec)}}
    cur = {
        "schema": 1,
        "scenarios": {"a": {**rec, "capacity": 128}, "new": dict(rec)},
    }
    drift = diff_baselines(cur, base)
    assert not drift.clean
    assert drift.added == ("new",)
    assert drift.removed == ("gone",)
    assert ("a", "capacity", 64, 128) in drift.changed
    # subset mode ignores cells the current run didn't execute
    subset = diff_baselines(
        {"schema": 1, "scenarios": {"a": dict(rec)}}, base,
        ignore_missing_in_current=True,
    )
    assert subset.clean


def test_drift_report_summary_mentions_every_kind():
    d = DriftReport(("x",), ("y",), (("z", "status", "pass", "fail"),))
    s = d.summary()
    assert "ADDED" in s and "REMOVED" in s and "CHANGED" in s


# ------------------------------------------------- parity with repro.verify
GRIDS = (
    "smoke_grid", "tier1_grid", "segment_smoke_grid", "segment_tier1_grid",
    "fault_grid", "op_smoke_grid", "op_tier1_grid",
)


@pytest.mark.parametrize("name", GRIDS)
def test_grid_cells_equal_the_reference(name):
    """Same cells, in the same order, with the same ids, input groups and
    inputs (the seeded generators are copies)."""
    mine, ref = getattr(grid, name)(), getattr(jgrid, name)()
    assert [sc.scenario_id for sc in mine] == [sc.scenario_id for sc in ref]
    assert [sc.group_id for sc in mine] == [sc.group_id for sc in ref]
    assert [dataclasses.astuple(sc) for sc in mine] == [dataclasses.astuple(sc) for sc in ref]
    for a, b in zip(mine, ref):
        if hasattr(a, "make_batch"):
            (fa, la), (fb, lb) = a.make_batch(), b.make_batch()
            assert la == lb and fa.dtype == fb.dtype and fa.tobytes() == fb.tobytes()
        else:
            xa, xb = a.make_input(), b.make_input()
            assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()


def test_prune_reasons_equal_the_reference():
    """Under the reference's 64-bit rule (``x64=False``) every cell of the
    whole product prunes for the same reason in every mesh environment;
    the port's own rule differs only by running 64-bit sim cells."""
    cells = list(grid._grid(grid.PATHS, grid.DTYPES, ALL_DISTRIBUTIONS, grid.SIZE_BUCKETS, grid.DIMS))
    cells.append(Scenario("sim", "hier", "int32", "random", 1024, 1))
    for devices, mesh_axes in ((1, 1), (4, 1), (4, 2), (2048, 2)):
        for sc in cells:
            want = jgrid.prune_reason(sc, devices=devices, mesh_axes=mesh_axes, x64=False)
            assert grid.prune_reason(sc, devices=devices, mesh_axes=mesh_axes, x64=False) == want
    # the audit list: the reference's with its rule for jax with x64 on
    mine = [(sc.scenario_id, why) for sc, why in grid.pruned_cells()]
    want = [(sc.scenario_id, jgrid.prune_reason(sc, x64=True)) for sc in cells[:-1]]
    assert mine == [(sid, why) for sid, why in want if why is not None]
    ref = [(sc.scenario_id, why) for sc, why in jgrid.pruned_cells()]
    assert {sid.split("/")[2] for sid, why in ref if why.startswith("64-bit")} == {"int64"}
    for sc in grid.segment_smoke_grid():
        assert grid.segment_prune_reason(sc) == jgrid.segment_prune_reason(sc) is None
    assert grid.segment_prune_reason(grid.SegmentScenario("bitonic", "float32", "ties", 100)) == \
        jgrid.segment_prune_reason(jgrid.SegmentScenario("bitonic", "float32", "ties", 100))
    for sc in (grid.OpScenario("top_k", "int32", "random", 257), grid.OpScenario("sort", "int64", "random", 257),
               grid.OpScenario("merge", "int32", "random", 257, 8), grid.OpScenario("scan", "int32", "random", 257)):
        assert grid.op_prune_reason(sc) == jgrid.op_prune_reason(sc) is not None


def test_full_grid_adds_exactly_the_int64_sim_cells():
    mine = {sc.scenario_id for sc in grid.full_grid()}
    ref = {sc.scenario_id for sc in jgrid.full_grid()}
    assert len(mine) == 1560 and len(ref) == 1430 and ref <= mine
    extra = mine - ref
    assert len(extra) == 130
    assert all(sid.startswith("sim/") and "/int64/" in sid for sid in extra)
    assert {sid for sid in mine if sid.startswith("sim/") and "/int64/" in sid} == extra


# ------------------------------------------------------- the whole smoke run
def test_whole_smoke_run_passes_and_equals_both_baselines():
    engines = cpu_engines()
    results = run_grid(grid.smoke_grid(), engines=engines)
    results += differential.run_segment_grid(grid.segment_smoke_grid(), engines=engines)
    results += differential.run_fault_grid(grid.fault_grid(), engines=engines)
    results += differential.run_op_grid(grid.op_smoke_grid(), engines=engines)
    assert len(results) == 438
    fails = [(r.scenario_id, r.detail) for r in results if r.status != "pass"]
    assert not fails, fails
    assert cross_check(results) == []
    doc = build_baseline(results, grid="smoke")
    assert doc == load_baseline(BASELINE_PATH)
    assert json.loads(BASELINE_PATH.read_text())["scenarios"] == json.loads(JAX_BASELINE_PATH.read_text())["scenarios"]


# ------------------------------------------ cell for cell against the JAX runner
TIER1_CELLS = (
    [("sort", sc) for sc in grid.tier1_grid()]
    + [("segment", sc) for sc in grid.segment_tier1_grid()]
    + [("op", sc) for sc in grid.op_tier1_grid()]
)
_RUNNERS = {
    "sort": (differential.run_scenario, jdifferential.run_scenario),
    "segment": (differential.run_segment_scenario, jdifferential.run_segment_scenario),
    "op": (differential.run_op_scenario, jdifferential.run_op_scenario),
}


@pytest.fixture(scope="module")
def runners():
    """The port's engines on the CPU and the reference's engines with its
    Pallas kernels as the local sort (interpret mode on the CPU), one of
    each per topology for the module, so executables are reused."""
    jax_engines = jdifferential.EngineCache(devices=1)
    for d_h in (1, 2):
        jax_engines._engines[(d_h, "full", False, 1)] = JaxSortEngine(
            JaxOHHCTopology(d_h, "full"), local_sort=jops.make_local_sort()
        )
    return cpu_engines(), jax_engines


@pytest.mark.parametrize("kind,sc", TIER1_CELLS, ids=[sc.scenario_id for _, sc in TIER1_CELLS])
def test_tier1_cell_equals_the_jax_runner(kind, sc, runners, monkeypatch):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
    engines, jax_engines = runners
    mine, ref = _RUNNERS[kind]
    jsc = getattr(jgrid, type(sc).__name__)(**dataclasses.asdict(sc))
    got, want = mine(sc, engines), ref(jsc, jax_engines)
    assert got.status == want.status == "pass", (got.detail, want.detail)
    assert got.output.dtype == want.output.dtype
    assert got.output.tobytes() == want.output.tobytes()
    assert bl.result_record(got) == jbaseline.result_record(want)
    assert got.counts_sum == want.counts_sum


# ---------------------------------------------------------------- the dist rule
def test_the_dist_path_raises_rather_than_prunes():
    with pytest.raises(NotImplementedError, match="Dist path"):
        EngineCache(devices=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Dist path"):
        cpu_engines().engine_for(Scenario("dist", "paper", "int32", "random", 1024, 1))


# ------------------------------------------------------------------ the CLI
def _cli(*args, cwd=ROOT):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.verify", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_cli_smoke_on_the_cpu_has_no_drift():
    r = _cli("--smoke", "--device", "cpu", "-q")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "verify[smoke]: 438/438 scenarios pass" in r.stdout
    assert "0 cross-check mismatches, 49/49 property checks pass" in r.stdout
    assert f"baseline: no drift vs {BASELINE_PATH}" in r.stdout


def test_cli_fails_on_a_changed_baseline_field(tmp_path):
    doc = json.loads(BASELINE_PATH.read_text())
    doc["scenarios"]["sim/paper/int32/random/n1024/d1"]["capacity"] += 8
    changed = tmp_path / "baseline.json"
    changed.write_text(json.dumps(doc))
    r = _cli("--smoke", "--device", "cpu", "-q", "--skip-properties", "--baseline", str(changed))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "CHANGED  sim/paper/int32/random/n1024/d1: capacity" in r.stdout
    assert "drift: 0 added, 0 removed, 1 changed" in r.stdout


def test_cli_refuses_more_devices_naming_the_dist_item():
    r = _cli("--smoke", "--device", "cpu", "--devices", "2")
    assert r.returncode != 0
    assert "Dist path" in r.stdout and "verify[" not in r.stdout


def test_cli_refuses_to_overwrite_the_committed_baseline_from_a_subset():
    before = BASELINE_PATH.read_bytes()
    for args in (("--tier1",), ("--smoke", "--filter", "uint32"), ("--degraded",)):
        r = _cli(*args, "--device", "cpu", "-q", "--update-baseline")
        assert r.returncode == 2, r.stdout + r.stderr
        assert "refusing --update-baseline" in r.stdout
    assert BASELINE_PATH.read_bytes() == before


def test_cli_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the no-card failure shows only where there is no card")
    r = _cli("--tier1", "-q")
    assert r.returncode != 0 and "device='cpu'" in r.stderr and "verify[" not in r.stdout


def test_cli_sortd_slice_on_the_cpu():
    r = _cli("--sortd", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "verify[sortd]: 49/49 requests pass" in r.stdout
