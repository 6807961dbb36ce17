"""The port's link simulator ``repro_torch.net`` against the JAX package's
``repro.net``, case for case.

Both packages get the same topology, schedule, scenario and chunk sizes;
routes, timelines, exceptions, node sets and reports must be equal
exactly (``==`` on floats, the same bytes for a written report).  The
scenarios are those of ``tests/test_netsim.py`` and the ``rebuild_degraded``
section of ``tests/test_faults_serving.py``, each run on both sides.  The
Quick Sort counters of ``core.ohhc_sort`` are held here too.
"""

import dataclasses

import numpy as np
import pytest

import repro.net as rnet
import repro_torch.net as tnet
from repro.core import ohhc_sort as rsort
from repro.core.schedule import AccumulationSchedule as RSchedule
from repro.core.schedule import Send as RSend
from repro.core.topology import OHHCTopology as RTopo
from repro.net import faults as rfaults
from repro_torch.core import ohhc_sort as tsort
from repro_torch.core.schedule import AccumulationSchedule as TSchedule
from repro_torch.core.schedule import Send as TSend
from repro_torch.core.topology import OHHCTopology as TTopo
from repro_torch.data import make_array
from repro_torch.net import faults as tfaults

GRID = [(d, v) for d in (1, 2) for v in ("full", "half")]
GRID3 = [(d, v) for d in (1, 2, 3) for v in ("full", "half")]


def _topos(d_h, variant):
    return RTopo(d_h, variant), TTopo(d_h, variant)


def _plain(x):
    """A result as nested builtins: dataclasses (``Send``, ``SimResult`` …)
    become dicts, so the two packages' classes compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _outcome(fn):
    """``("ok", result)`` or ``("raised", type name, message, nodes)``."""
    try:
        return ("ok", _plain(fn()))
    except Exception as e:  # noqa: BLE001 — the exception is the datum
        return ("raised", type(e).__name__, str(e), sorted(getattr(e, "nodes", ())))


def _both(ref_fn, port_fn):
    r, t = _outcome(ref_fn), _outcome(port_fn)
    assert t == r
    return t


def test_net_exports_the_reference_names():
    assert sorted(tnet.__all__) == sorted(rnet.__all__)
    for name in tnet.__all__:
        obj = getattr(tnet, name)
        if isinstance(obj, str):  # the link-kind constants
            assert obj == getattr(rnet, name)
        else:
            assert obj.__module__.startswith("repro_torch."), name


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("d_h,variant", GRID)
def test_router_distances_diameter_and_edges_match(d_h, variant):
    rt, tt = _topos(d_h, variant)
    rr, tr = rnet.Router(rt), tnet.Router(tt)
    assert tr.adjacency == rr.adjacency
    assert tr.live_links() == rr.live_links()
    assert tr.eccentricities() == rr.eccentricities()
    assert tr.verify_diameter() == rr.verify_diameter()
    assert tr.verify_diameter()["measured"] == 2 * d_h + 3
    assert tt.summary == rt.summary
    assert tt.summary["electrical_edges"] == tt.electrical_edge_count_closed_form()
    assert tt.summary["optical_edges"] == tt.optical_edge_count_closed_form()
    for src in (0, tt.total_procs // 2, tt.total_procs - 1):
        for dst in range(tt.total_procs):
            assert tr.distance(src, dst) == rr.distance(src, dst)
        assert tr.shortest_path(src, 0) == rr.shortest_path(src, 0)


@pytest.mark.parametrize("d_h,variant", GRID)
def test_faulted_router_matches(d_h, variant):
    rt, tt = _topos(d_h, variant)
    rsc = rfaults.FaultScenario.group_uplinks_down(rt, 1)
    tsc = tfaults.FaultScenario.group_uplinks_down(tt, 1)
    rr, tr = rsc.router(rt), tsc.router(tt)
    assert tr.is_connected() == rr.is_connected() is False
    assert tr.component(rt.global_id(1, 0)) == rr.component(rt.global_id(1, 0))
    _both(lambda: rr.shortest_path(rt.global_id(1, 1), 0), lambda: tr.shortest_path(tt.global_id(1, 1), 0))
    leaf = rt.global_id(1, 5)
    rr, tr = rnet.Router(rt, failed_nodes=[leaf]), tnet.Router(tt, failed_nodes=[leaf])
    assert tr.eccentricities() == rr.eccentricities()


# ------------------------------------------------------------- timelines
@pytest.mark.parametrize("barrier", [True, False])
@pytest.mark.parametrize("d_h,variant", GRID3)
def test_simulate_gather_timelines_match(d_h, variant, barrier):
    rt, tt = _topos(d_h, variant)
    sizes = np.random.default_rng(d_h).integers(0, 4096, tt.total_procs).tolist()
    for lm_r, lm_t, chunk in (
        (rnet.LinkModel(), tnet.LinkModel(), 1024),
        (rnet.LinkModel.unit(), tnet.LinkModel.unit(), 1),
        (rnet.LinkModel(), tnet.LinkModel(), sizes),
    ):
        res = _both(
            lambda: rnet.simulate_gather(rt, link_model=lm_r, chunk_sizes=chunk, barrier=barrier),
            lambda: tnet.simulate_gather(tt, link_model=lm_t, chunk_sizes=chunk, barrier=barrier),
        )
        assert res[0] == "ok"
        got = res[1]
        # per-link occupancy and utilization are part of the equal record
        assert set(got["link_busy_s"]) == {"electrical", "optical"}
    rres = rnet.simulate_gather(rt, link_model=rnet.LinkModel.unit(), barrier=barrier)
    tres = tnet.simulate_gather(tt, link_model=tnet.LinkModel.unit(), barrier=barrier)
    assert tnet.critical_hop_count(tres, 1e-6) == rnet.critical_hop_count(rres, 1e-6)
    if barrier:
        assert tnet.critical_hop_count(tres, 1e-6) == TSchedule.build(tt).critical_path_rounds()


@pytest.mark.parametrize("d_h,variant", GRID3)
def test_analytic_model_and_link_bridge_match(d_h, variant):
    rt, tt = _topos(d_h, variant)
    sizes = [1024] * tt.total_procs
    r = rsort.model_comm_time_s(RSchedule.build(rt), sizes, rnet.LinkModel().to_core(), itemsize=4, roundtrip=False)
    t = tsort.model_comm_time_s(TSchedule.build(tt), sizes, tnet.LinkModel().to_core(), itemsize=4, roundtrip=False)
    assert t == r
    assert _plain(tnet.LinkModel.from_core(tsort.LinkModel())) == _plain(rnet.LinkModel.from_core(rsort.LinkModel()))


def test_contention_and_repeated_source_rounds_match():
    """The hand-made rounds of ``test_netsim.py``: two sends over one
    directed link (one contention event) and two sends from one source
    in one round (the payload moves once)."""
    rt, tt = _topos(1, "full")
    for link_model, chunk, sends in (
        ("unit", 1, [((0, 1), (0, 0), "electrical", "X")] * 2),
        ("default", 5, [((1, 0), (0, 1), "optical", "X"), ((1, 0), (1, 1), "electrical", "X")]),
    ):
        lm_r = rnet.LinkModel.unit() if link_model == "unit" else rnet.LinkModel()
        lm_t = tnet.LinkModel.unit() if link_model == "unit" else tnet.LinkModel()
        res = _both(
            lambda: rnet.simulate_schedule((tuple(RSend(*s) for s in sends),), rt, link_model=lm_r, chunk_sizes=chunk),
            lambda: tnet.simulate_schedule((tuple(TSend(*s) for s in sends),), tt, link_model=lm_t, chunk_sizes=chunk),
        )[1]
        if link_model == "unit":
            assert res["contention_events"] == 1 and res["total_time_s"] == pytest.approx(2e-6)
        else:
            assert sum(tr["elems"] for tr in res["traces"]) == 5


# ----------------------------------------------------------------- faults
def _scenarios(rt, tt):
    """(name, reference scenario, port scenario): every constructor."""
    out = [("empty", rfaults.FaultScenario(), tfaults.FaultScenario())]
    for g in range(1, rt.num_groups):
        out.append((f"optical{g}", rfaults.FaultScenario.optical_link_down(g), tfaults.FaultScenario.optical_link_down(g)))
    for w in (0, 1, rt.num_groups - 1):
        out.append((f"worker{w}", rfaults.FaultScenario.worker_down(w), tfaults.FaultScenario.worker_down(w)))
    out.append(("uplinks1", rfaults.FaultScenario.group_uplinks_down(rt, 1), tfaults.FaultScenario.group_uplinks_down(tt, 1)))
    for k, seed in ((2, 3), (4, 3), (1, 0), (6, 5), (12, 7)):
        out.append((f"k{k}s{seed}", rfaults.FaultScenario.random_links(rt, k, seed=seed),
                    tfaults.FaultScenario.random_links(tt, k, seed=seed)))
    return out


@pytest.mark.parametrize("d_h,variant", GRID)
def test_every_scenario_rebuilds_or_refuses_alike(d_h, variant):
    rt, tt = _topos(d_h, variant)
    chunk = max(1, (1 << 14) // tt.total_procs)
    for name, rsc, tsc in _scenarios(rt, tt):
        assert _plain(tsc) == _plain(rsc), name
        assert tsc.is_degraded == rsc.is_degraded
        rounds = _both(lambda: rfaults.degraded_gather_rounds(rt, rsc), lambda: tfaults.degraded_gather_rounds(tt, tsc))
        for barrier in (True, False):
            _both(
                lambda: rfaults.predicted_slowdown(rt, rsc, chunk_sizes=chunk, barrier=barrier),
                lambda: tfaults.predicted_slowdown(tt, tsc, chunk_sizes=chunk, barrier=barrier),
            )
        if rounds[0] != "ok":
            continue
        _both(
            lambda: rnet.simulate_schedule(rfaults.degraded_gather_rounds(rt, rsc), rt, router=rsc.router(rt), chunk_sizes=chunk),
            lambda: tnet.simulate_schedule(tfaults.degraded_gather_rounds(tt, tsc), tt, router=tsc.router(tt), chunk_sizes=chunk),
        )
    with pytest.raises(ValueError):
        tfaults.FaultScenario.worker_down(-1)


def test_group_uplinks_down_refuses_with_the_whole_group():
    for variant in ("full", "half"):
        rt, tt = _topos(1, variant)
        res = _both(
            lambda: rnet.rebuild_degraded(RSchedule.build(rt), rt, rfaults.FaultScenario.group_uplinks_down(rt, 1).router(rt)),
            lambda: tnet.rebuild_degraded(TSchedule.build(tt), tt, tfaults.FaultScenario.group_uplinks_down(tt, 1).router(tt)),
        )
        assert res[0] == "raised" and res[1] == "GatherImpossible" and "cannot be rerouted" in res[2]
        assert res[3] == sorted(tt.global_id(1, l) for l in range(tt.procs_per_group))


def test_dead_nodes_and_dead_hubs_match():
    """A dead master or hub is impossible with its node set; a dead leaf
    degrades and loses exactly its own chunk."""
    rt, tt = _topos(1, "full")
    for nodes in ([0], [rt.global_id(1, 0)]):
        res = _both(
            lambda: rnet.rebuild_degraded(RSchedule.build(rt), rt, rnet.Router(rt, failed_nodes=nodes)),
            lambda: tnet.rebuild_degraded(TSchedule.build(tt), tt, tnet.Router(tt, failed_nodes=nodes)),
        )
        assert res[:2] == ("raised", "GatherImpossible") and res[3] == nodes
    leaf = [rt.global_id(1, 5)]
    res = _both(
        lambda: rnet.simulate_schedule(rnet.rebuild_degraded(RSchedule.build(rt), rt, rnet.Router(rt, failed_nodes=leaf)),
                                       rt, router=rnet.Router(rt, failed_nodes=leaf), chunk_sizes=1),
        lambda: tnet.simulate_schedule(tnet.rebuild_degraded(TSchedule.build(tt), tt, tnet.Router(tt, failed_nodes=leaf)),
                                       tt, router=tnet.Router(tt, failed_nodes=leaf), chunk_sizes=1),
    )
    assert res[1]["master_elems"] == tt.total_procs - 1


@pytest.mark.parametrize("d_h,variant", GRID)
def test_single_optical_fault_reroutes_alike(d_h, variant):
    rt, tt = _topos(d_h, variant)
    healthy = _both(
        lambda: rnet.simulate_gather(rt, chunk_sizes=1024, barrier=True),
        lambda: tnet.simulate_gather(tt, chunk_sizes=1024, barrier=True),
    )[1]
    faulted = _both(
        lambda: rnet.simulate_gather(rt, router=rfaults.FaultScenario.optical_link_down(1).router(rt), chunk_sizes=1024, barrier=True),
        lambda: tnet.simulate_gather(tt, router=tfaults.FaultScenario.optical_link_down(1).router(tt), chunk_sizes=1024, barrier=True),
    )[1]
    assert faulted["master_elems"] == healthy["master_elems"]
    assert faulted["rerouted_messages"] == 1
    assert faulted["total_time_s"] > healthy["total_time_s"]


def test_route_error_on_a_disconnected_send_matches():
    rt, tt = _topos(1, "full")
    rr = rfaults.FaultScenario.group_uplinks_down(rt, 1).router(rt)
    tr = tfaults.FaultScenario.group_uplinks_down(tt, 1).router(tt)
    res = _both(
        lambda: rnet.simulate_gather(rt, router=rr, chunk_sizes=1),
        lambda: tnet.simulate_gather(tt, router=tr, chunk_sizes=1),
    )
    assert res[:2] == ("raised", "RouteError")


# ---------------------------------------------------------------- reports
def test_netsim_report_json_and_markdown_are_identical(tmp_path):
    for lm_r, lm_t in ((rnet.LinkModel(), tnet.LinkModel()), (rnet.LinkModel.unit(), tnet.LinkModel.unit())):
        r = rnet.netsim_report(dims=(1, 2), link_model=lm_r)
        t = tnet.netsim_report(dims=(1, 2), link_model=lm_t)
        assert t == r
        assert tnet.to_markdown(t) == rnet.to_markdown(r)
        pr = rnet.write_json(r, tmp_path / "ref.json")
        pt = tnet.write_json(t, tmp_path / "port.json")
        assert pt.read_bytes() == pr.read_bytes()
    assert t["all_rounds_validated"] and t["all_diameters_validated"] and t["all_faults_completed"]
    for d_h, variant in GRID:
        kw = dict(chunk_elems=333, itemsize=8, fault_group=3)
        assert tnet.case_report(d_h, variant, **kw) == rnet.case_report(d_h, variant, **kw)


# --------------------------------------------------------------- counters
@pytest.mark.parametrize("dist", ["random", "sorted", "reversed", "dupes", "local"])
def test_quicksort_counters_match(dist):
    x = make_array(dist, 3000, seed=41)
    for pivot in ("middle", "last"):
        assert _plain(tsort.quicksort_counters(x, pivot=pivot)) == _plain(rsort.quicksort_counters(x, pivot=pivot))
    for d_h in (1, 2):
        rt, tt = _topos(d_h, "full")
        for method in ("paper", "sampled"):
            assert _plain(tsort.parallel_quicksort_counters(x, tt, method=method)) == _plain(
                rsort.parallel_quicksort_counters(x, rt, method=method)
            )
    with pytest.raises(ValueError):
        tsort.quicksort_counters(x, pivot="first")


def test_bitonic_counters_and_counter_sums_match():
    for n in (0, 1, 2, 3, 100, 128, 4097, 1 << 20):
        assert tsort.bitonic_counters(n) == rsort.bitonic_counters(n)
    c = tsort.QuickSortCounters(1, 2, 3)
    c += tsort.QuickSortCounters(4, 5, 6)
    assert (c.recursion_calls, c.iterations, c.swaps) == (5, 7, 9)
    assert tsort.quicksort_counters(np.arange(1000)).swaps == 0
