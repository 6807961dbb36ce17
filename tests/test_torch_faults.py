"""The port's fault ladder against the JAX package's, scenario for scenario.

``SortEngine(device="cpu")`` of the port and the JAX ``SortEngine`` serve
the same seeded requests under the five scenarios of
``benchmarks/bench_faults.py`` at d_h = 1 (two degraded but possible, one
more of them, and two impossible).  Plans must agree field for field —
``path``, ``fault``, ``fault_slowdown`` (``==``, a pure-Python netsim
ratio), ``reason`` — and so must ``comm_cost_estimate``; every output
equals ``np.sort``.  The port's copies of the ladder's own tests in
``tests/test_faults_serving.py`` follow.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import SortEngine as JaxSortEngine
from repro.core import OHHCTopology as RTopo
from repro.net.faults import FaultScenario as RScenario
from repro_torch.core import OHHCTopology, SortEngine, SortPlan, engine
from repro_torch.data import make_array
from repro_torch.kernels import batched, bitonic, partition_kernel
from repro_torch.net.faults import FaultScenario, predicted_slowdown

BENCH_SCENARIOS = ("optical_g1_down", "klinks2_s3", "klinks4_s3", "uplinks_g1_down", "worker1_down")
IMPOSSIBLE = ("uplinks_g1_down", "worker1_down")


def _bench_scenario(cls, topo, name):
    """The scenarios of ``bench_faults._scenarios``, by name."""
    return {
        "optical_g1_down": lambda: cls.optical_link_down(1),
        "klinks2_s3": lambda: cls.random_links(topo, 2, seed=3),
        "klinks4_s3": lambda: cls.random_links(topo, 4, seed=3),
        "uplinks_g1_down": lambda: cls.group_uplinks_down(topo, 1),
        "worker1_down": lambda: cls.worker_down(1),
    }[name]()


def _pair(name):
    rsc = _bench_scenario(RScenario, RTopo(1, "full"), name)
    tsc = _bench_scenario(FaultScenario, OHHCTopology(1, "full"), name)
    assert rsc.name == tsc.name == name
    return rsc, tsc


def _fields(plan):
    return dataclasses.asdict(plan)


@pytest.fixture(scope="module")
def jax_engine():
    return JaxSortEngine()


@pytest.fixture
def port():
    return SortEngine(device="cpu")


@pytest.fixture
def no_kernel(monkeypatch):
    """Make every kernel wrapper raise: what runs under it runs none."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper ran under an impossible scenario")
    for mod, name in ((batched, "batched_row_sort"), (bitonic, "sort_tile"),
                      (bitonic, "merge_tiles"), (partition_kernel, "bucket_count_rank"),
                      (engine.ops, "local_sort"), (engine.partition.ops, "bucket_count_rank"),
                      (engine.batched_kernels, "batched_row_sort")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("name", BENCH_SCENARIOS)
def test_sort_plans_and_prices_match_under_each_scenario(name, jax_engine, port):
    rsc, tsc = _pair(name)
    jax_engine.set_fault_scenario(rsc)
    port.set_fault_scenario(tsc)
    try:
        for dist, n, dtype in (("random", 1000, np.int32), ("random", 4096, np.float32),
                               ("local", 60_000, np.int32), ("random", 3, np.int16)):
            x = make_array(dist, n, seed=31 + n, dtype=np.dtype(dtype))
            jp, tp = jax_engine.plan(x), port.plan(x)
            assert _fields(tp) == _fields(jp)
            assert tp.fault == name
            if name in IMPOSSIBLE:
                assert tp.path == "host" and tp.fault_slowdown is None
            else:
                assert tp.path == "sim" and tp.fault_slowdown > 1.0
            for itemsize in (1, 4, 8):
                assert port.comm_cost_estimate(n, itemsize) == jax_engine.comm_cost_estimate(n, itemsize)
            want = jax_engine.sort(x)
            got = port.sort(x)
            assert np.array_equal(got, np.sort(x)) and np.array_equal(got, want)
            assert _fields(port.last_report["plan"]) == _fields(jax_engine.last_report["plan"])
    finally:
        jax_engine.set_fault_scenario(None)


@pytest.mark.parametrize("name", BENCH_SCENARIOS)
def test_segment_and_top_k_plans_match_under_each_scenario(name, jax_engine, port, monkeypatch, rng):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
    rsc, tsc = _pair(name)
    jax_engine.set_fault_scenario(rsc)
    port.set_fault_scenario(tsc)
    try:
        for lens in ((0, 1, 100, 300), (9000, 300)):
            segs = [rng.integers(0, 1 << 30, n).astype(np.int32) for n in lens]
            keys = np.concatenate(segs)
            want = jax_engine.sort_segments(keys, list(lens))
            got = port.sort_segments(keys, list(lens))
            for g, w, s in zip(got, want, segs):
                assert np.array_equal(g, np.sort(s)) and np.array_equal(g, w)
            jp, tp = jax_engine.last_report["plan"], port.last_report["plan"]
            assert _fields(tp) == _fields(jp)
            assert tp.fault == name
            assert tp.path == ("host" if name in IMPOSSIBLE else "sim")
        x = make_array("random", 20_000, seed=32)
        for k in (10, 15_000):
            got = port.top_k(x, k)
            assert np.array_equal(got, np.sort(x)[:k]) and np.array_equal(got, jax_engine.top_k(x, k))
            assert _fields(port.last_report["plan"]) == _fields(jax_engine.last_report["plan"])
    finally:
        jax_engine.set_fault_scenario(None)


@pytest.mark.parametrize("name", IMPOSSIBLE)
def test_impossible_scenarios_run_no_kernel(name, port, no_kernel, monkeypatch, rng):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
    port.set_fault_scenario(_pair(name)[1])
    lens = [0, 1, 17, 100, 64, 9000]
    segs = [rng.integers(0, 1 << 30, n).astype(np.int32) for n in lens]
    flat = np.concatenate(segs)
    for seg, out in zip(segs, port.sort_segments(flat, lens)):
        assert np.array_equal(out, np.sort(seg))
    x = make_array("random", 5000, seed=33)
    forced = SortPlan("sim", "paper", 512, 8192, "forced")
    assert np.array_equal(port.sort(x, plan=forced), np.sort(x))
    assert port.last_report["plan"].path == "host"
    buf = np.sort(make_array("random", 4000, seed=34))
    assert np.array_equal(port.merge_sorted(buf, x), np.sort(np.concatenate([buf, x])))


# ---------------------------------------- the ladder's own tests, on the port
def _x(n=4096, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 31, size=n).astype(np.int32)


def test_engine_degraded_plan_is_annotated_and_exact(port):
    port.set_fault_scenario(FaultScenario.optical_link_down(1))
    x = _x()
    np.testing.assert_array_equal(port.sort(x), np.sort(x))
    plan = port.last_report["plan"]
    assert plan.fault == "optical_g1_down"
    assert plan.fault_slowdown is not None and plan.fault_slowdown > 1.0
    assert "predicted" in plan.reason and "gather slowdown" in plan.reason
    chunk = -(-x.size // port.topo.total_procs)  # n = 4096 is its own pow2 bucket
    _, _, ratio = predicted_slowdown(port.topo, port.fault_scenario, chunk_sizes=chunk)
    assert plan.fault_slowdown == ratio


def test_engine_impossible_scenario_falls_back_to_host(port):
    port.set_fault_scenario(FaultScenario.group_uplinks_down(port.topo, 1))
    x = _x(seed=1)
    forced = SortPlan("sim", "paper", 512, 4096, "test force")
    np.testing.assert_array_equal(port.sort(x, plan=forced), np.sort(x))
    plan = port.last_report["plan"]
    assert plan.path == "host" and plan.fault == "uplinks_g1_down"
    assert "impossible" in plan.reason and "host" in plan.reason
    assert plan.fault_slowdown is None


def test_engine_empty_scenario_is_a_noop(port):
    port.set_fault_scenario(FaultScenario())
    x = _x(seed=2)
    np.testing.assert_array_equal(port.sort(x), np.sort(x))
    assert port.last_report["plan"].fault is None


def test_constructor_scenario_equals_set_scenario():
    sc = FaultScenario.optical_link_down(2)
    a, b = SortEngine(device="cpu", fault_scenario=sc), SortEngine(device="cpu")
    b.set_fault_scenario(sc)
    x = _x(seed=6)
    assert _fields(a.plan(x)) == _fields(b.plan(x))
    assert a.comm_cost_estimate(x.size) == b.comm_cost_estimate(x.size)


def test_sort_segments_impossible_scenario_host_fallback(port, rng):
    port.set_fault_scenario(FaultScenario.worker_down(1))
    lens = [0, 1, 17, 100, 64]
    segs = [rng.integers(0, 1 << 30, n).astype(np.int32) for n in lens]
    flat = np.concatenate(segs)
    for seg, out in zip(segs, port.sort_segments(flat, lens)):
        np.testing.assert_array_equal(out, np.sort(seg))
    plan = port.last_report["plan"]
    assert plan.path == "host" and plan.fault == "worker1_down"
    with pytest.raises(ValueError, match="return_padded"):
        port.sort_segments(flat, lens, return_padded=True)


def test_sort_segments_possible_scenario_annotates_plan(port, rng, monkeypatch):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
    port.set_fault_scenario(FaultScenario.optical_link_down(2))
    lens = [9, 33, 100]
    segs = [rng.integers(0, 1 << 30, n).astype(np.int32) for n in lens]
    for seg, out in zip(segs, port.sort_segments(np.concatenate(segs), lens)):
        np.testing.assert_array_equal(out, np.sort(seg))
    plan = port.last_report["plan"]
    assert plan.path == "sim" and plan.fault == "optical_g2_down"
    assert plan.method == "bitonic_pallas"


def test_scenario_switching_reprices_without_rebuilding(port):
    """A flapping scenario never serves the healthy price for a degraded
    plan, and never builds an executor again (``trace_count`` stays)."""
    x = _x(seed=5)
    sc = FaultScenario.optical_link_down(1)
    port.sort(x)
    assert port.last_report["plan"].path == "sim"
    healthy_reason = port.last_report["plan"].reason
    healthy_price = port.comm_cost_estimate(x.size)
    builds = port.trace_count

    port.set_fault_scenario(sc)
    port.sort(x)
    degraded_reason = port.last_report["plan"].reason
    degraded_price = port.comm_cost_estimate(x.size)
    assert degraded_reason != healthy_reason
    assert degraded_price > healthy_price
    assert {None, sc.name} <= {key[3] for key in port._comm_sim_cache}

    port.set_fault_scenario(None)
    port.sort(x)
    assert port.last_report["plan"].reason == healthy_reason
    assert port.comm_cost_estimate(x.size) == healthy_price

    port.set_fault_scenario(sc)
    port.sort(x)
    assert port.last_report["plan"].reason == degraded_reason
    assert port.trace_count == builds
    assert list(port._fault_info) == [sc.name]
