"""``SortEngine(mesh=...)``: the port's dist path on 4 gloo ranks against
the reference engine on 4 fake XLA devices.

* Plans equal the reference's ``choose_plan`` on a ``(4,)`` and a
  ``(2, 2)`` mesh for random, sorted and skewed input, ``comm_sim_s``
  included, and under the fault ladder: a degraded scenario re-prices the
  dist plan's gather, an impossible one rewrites it onto the host path.
* ``_sort_dist`` returns ``np.sort`` and the reference engine's output on
  every rank, with a shard-divisibility pad; ``last_report``'s
  ``counts_sum`` and ``overflow_retries`` equal the reference's, among
  them a forced ``sample`` plan on sorted keys that overflows and
  escalates.

The reference runs in one subprocess, the port's cases in one spawned
group of 4 ranks.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import SortEngine, SortPlan
from repro_torch.data import make_array
from repro_torch.net.faults import FaultScenario
from repro_torch.runtime import ranks

ROOT = Path(__file__).resolve().parents[1]
N = 20_001  # not a multiple of 4: the engine pads every shard

# name: (mesh axes, distribution, dtype, seed, forced method or None)
CASES = {
    "flat-random": (1, "random", "int32", 1, None),
    "flat-sorted": (1, "sorted", "int32", 2, None),
    "flat-skewed": (1, "local", "int32", 3, None),
    "flat-dupes": (1, "dupes", "int32", 4, None),
    "hier-random": (2, "random", "int32", 5, None),
    "hier-sorted": (2, "sorted", "uint32", 6, None),
    "forced-sample-sorted": (1, "sorted", "int32", 7, "sample"),
    "forced-paper-uint32": (1, "random", "uint32", 8, "paper"),
    "forced-paper-float32": (1, "random", "float32", 9, "paper"),
}
FAULTS = ("optical_link_down", "worker_down")

REFERENCE = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import SortEngine, SortPlan
from repro.data.distributions import make_array
from repro.net.faults import FaultScenario
cases, n, faults, out = eval(sys.argv[1]), int(sys.argv[2]), eval(sys.argv[3]), sys.argv[4]
# The engine's dist_sort, jitted once per static configuration: the same
# function, which unjitted compiles anew at every call.
_ds = sys.modules["repro.core.dist_sort"]
_orig, _jits = _ds.dist_sort, {}
def _jitted(x, *, mesh, axis_names, method, capacity_factor):
    key = (id(mesh), tuple(axis_names), method, capacity_factor, x.shape, str(x.dtype))
    if key not in _jits:
        _jits[key] = jax.jit(lambda x: _orig(x, mesh=mesh, axis_names=axis_names, method=method,
                                             capacity_factor=capacity_factor))
    return _jits[key](x)
_ds.dist_sort = _jitted
devs = np.array(jax.devices()[:4])
meshes = {1: Mesh(devs, ("data",)), 2: Mesh(devs.reshape(2, 2), ("pod", "data"))}
engines = {k: SortEngine(mesh=m, axis_names=m.axis_names) for k, m in meshes.items()}
res = {}
for name, (axes, d, dtype, seed, method) in cases.items():
    eng = engines[axes]
    x = make_array(d, n, seed=seed, dtype=np.dtype(dtype))
    plan = None if method is None else SortPlan("dist", method, None, None, "forced")
    y = eng.sort(x, plan=plan)
    r = eng.last_report
    res[name] = {"out": y, "plan": dataclasses.asdict(eng.plan(x)) if method is None else None,
                 "counts_sum": r["counts_sum"], "overflow_retries": r["overflow_retries"],
                 "comm_sim_s": r["comm_sim_s"]}
for f in faults:
    for axes, eng in engines.items():
        sc = getattr(FaultScenario, f)(1)
        eng.set_fault_scenario(sc)
        res[(f, axes)] = dataclasses.asdict(eng.plan(make_array("random", n, seed=1)))
        eng.set_fault_scenario(None)
with open(out, "wb") as fh:
    pickle.dump(res, fh)
"""


def _rank_cases(mesh, cases, n, faults):
    engines = {
        1: SortEngine(mesh=mesh, device="cpu"),
        2: SortEngine(mesh=ranks.make_mesh((2, 2), ("pod", "data"), "cpu"), axis_names=("pod", "data"), device="cpu"),
    }
    res = {}
    for name, (axes, d, dtype, seed, method) in cases.items():
        eng = engines[axes]
        x = make_array(d, n, seed=seed, dtype=np.dtype(dtype))
        plan = None if method is None else SortPlan("dist", method, None, None, "forced")
        y = eng.sort(x, plan=plan)
        r = eng.last_report
        res[name] = {"out": y, "plan": dataclasses.asdict(eng.plan(x)) if method is None else None,
                     "counts_sum": r["counts_sum"], "overflow_retries": r["overflow_retries"],
                     "comm_sim_s": r["comm_sim_s"]}
    for f in faults:
        for axes, eng in engines.items():
            eng.set_fault_scenario(getattr(FaultScenario, f)(1))
            res[(f, axes)] = dataclasses.asdict(eng.plan(make_array("random", n, seed=1)))
            eng.set_fault_scenario(None)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_engine") / "reference.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, repr(CASES), str(N), repr(FAULTS), str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        mine = ranks.run_ranks(_rank_cases, (4,), ("data",), backend="gloo", device="cpu",
                               args=(CASES, N, FAULTS))
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(out, "rb") as fh:
        want = pickle.load(fh)
    return mine, want


@pytest.mark.parametrize("name", list(CASES))
def test_sort_equals_np_sort_and_the_reference_on_every_rank(name, runs):
    mine, want = runs
    axes, d, dtype, seed, _ = CASES[name]
    x = make_array(d, N, seed=seed, dtype=np.dtype(dtype))
    for rank, res in enumerate(mine):
        got = res[name]["out"]
        assert got.dtype == x.dtype, rank
        assert np.array_equal(got, np.sort(x)), rank
        assert np.array_equal(got, want[name]["out"]), rank


@pytest.mark.parametrize("name", list(CASES))
def test_plans_and_reports_equal_the_reference(name, runs):
    mine, want = runs
    for res in mine:
        for field in ("plan", "counts_sum", "overflow_retries", "comm_sim_s"):
            assert res[name][field] == want[name][field], field
    assert want[name]["counts_sum"] == N
    if name == "forced-sample-sorted":
        assert want[name]["overflow_retries"] >= 1, "the forced overflow must escalate"
    if CASES[name][4] is None:
        assert mine[0][name]["plan"]["path"] == "dist"


def test_the_planned_methods_cover_the_mesh_rules(runs):
    mine, _ = runs
    methods = {name: mine[0][name]["plan"]["method"] for name, c in CASES.items() if c[4] is None}
    assert methods["flat-random"] == "paper"
    assert methods["flat-sorted"] == "valiant"
    assert methods["flat-skewed"] == "sample"
    assert methods["hier-random"] == methods["hier-sorted"] == "hier"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("axes", (1, 2))
def test_the_fault_ladder_reprices_a_dist_plan(fault, axes, runs):
    mine, want = runs
    for res in mine:
        assert res[(fault, axes)] == want[(fault, axes)]
    plan = want[(fault, axes)]
    if fault == "worker_down":
        assert plan["path"] == "host"  # impossible gather: the healthy host path
    else:
        assert plan["path"] == "dist" and plan["fault_slowdown"] > 1.0
