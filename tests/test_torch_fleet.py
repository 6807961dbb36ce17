"""The port's fleet (``repro_torch.serve.fleet``) on the CPU.

The reference's ``tests/test_fleet.py`` (affinity routing, work stealing,
health and failover, chaos kills, observability) and the fleet section of
``tests/test_faults_serving.py`` (a chaos kill and ``worker_down`` are one
failover; a link fault degrades every survivor), run over the port: every
worker gets its own ``SortEngine(device="cpu")``, and short rows take the
row kernel's plain version (``REPRO_ROW_BACKEND=pallas``).  Last, the
kernels' launch counts stay exact under threads.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import SortEngine
from repro_torch.kernels import KERNELS, _launches, launch_counts, reset_launches
from repro_torch.net.faults import FaultScenario
from repro_torch.serve.fleet import (
    AffinityRouter,
    ChaosConfig,
    FleetConfig,
    FleetDown,
    HealthMonitor,
    SortdFleet,
    rendezvous_worker,
)
from repro_torch.serve.fleet.loadgen import drive_closed_loop, request_mix
from repro_torch.serve.sortd import SortdConfig, affinity_key


@pytest.fixture(autouse=True)
def row_kernel(monkeypatch):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")


def cpu_fleet(*args, **kw):
    """``SortdFleet`` whose workers' engines run on the CPU."""
    kw.setdefault("engine_factory", lambda wid: SortEngine(device="cpu"))
    return SortdFleet(*args, **kw)


WORKERS4 = FleetConfig(
    workers=4,
    # fast, deterministic failure detection for tests: the monitor probes
    # every 5ms and a crashed thread is seen on liveness, not heartbeat age
    heartbeat_interval_s=0.005,
    heartbeat_timeout_s=5.0,
)


# ----------------------------------------------------------------- routing
def test_rendezvous_is_deterministic_and_minimally_disruptive():
    live = (0, 1, 2, 3)
    keys = [("int32", 1 << b) for b in range(6, 14)] + [
        ("uint32", 1 << b) for b in range(6, 14)
    ]
    placement = {k: rendezvous_worker(k, live) for k in keys}
    assert placement == {k: rendezvous_worker(k, live) for k in keys}
    # kill worker 2: only keys that lived on 2 may move, and they must
    # land on survivors — everyone else's placement is untouched
    survivors = (0, 1, 3)
    for k, w in placement.items():
        w2 = rendezvous_worker(k, survivors)
        if w != 2:
            assert w2 == w
        else:
            assert w2 in survivors


def test_affinity_holds_until_watermark_then_steals():
    r = AffinityRouter(steal_watermark=4, steal_margin=2)
    live = (0, 1, 2)
    key = affinity_key(np.zeros(1000, np.int32))
    home = r.route(key, live, {0: 0, 1: 0, 2: 0}).worker
    # below the watermark the same key stays home regardless of imbalance
    for depth in range(4):
        d = r.route(key, live, {w: (depth if w == home else 0) for w in live})
        assert (d.worker, d.stolen) == (home, False)
    # at the watermark with an idle thief, the request is stolen
    d = r.route(key, live, {w: (4 if w == home else 0) for w in live})
    assert d.stolen and d.worker != home and d.affine == home
    # ...but NOT when every worker is equally loaded (margin gate: moving
    # the job would just cool a cache without shedding load)
    d = r.route(key, live, {w: 4 for w in live})
    assert (d.worker, d.stolen) == (home, False)


def test_route_with_single_live_worker_never_steals():
    r = AffinityRouter(steal_watermark=1, steal_margin=1)
    d = r.route(("int32", 512), (2,), {2: 10_000})
    assert (d.worker, d.stolen) == (2, False)


# ------------------------------------------------------------------ health
def test_health_monitor_crash_and_stall_verdicts_fire_once():
    dead = []
    mon = HealthMonitor(timeout_s=0.05, on_dead=lambda w, r: dead.append((w, r)))
    alive = {0: True, 1: True}
    beats = {0: time.monotonic(), 1: time.monotonic()}
    for wid in (0, 1):
        mon.register(
            wid, alive=lambda w=wid: alive[w], last_beat=lambda w=wid: beats[w]
        )
    assert mon.check_now() == [] and dead == []
    alive[0] = False  # crash: caught by liveness immediately
    beats[1] -= 1.0  # stall: heartbeat a second stale against a 50ms budget
    verdicts = mon.check_now()
    assert sorted(verdicts) == [(0, "crashed"), (1, "heartbeat-timeout")]
    assert sorted(dead) == [(0, "crashed"), (1, "heartbeat-timeout")]
    assert mon.check_now() == []  # once per worker, ever


# -------------------------------------------------------------- live fleet
def test_fleet_sorts_and_reports_metrics_shape():
    reqs = request_mix(40, seed=7)
    with cpu_fleet(WORKERS4) as fleet:
        wall, outs = drive_closed_loop(fleet.submit, reqs, clients=4)
        m = fleet.metrics()
        rep = fleet.report()
    for o, r in zip(outs, reqs):
        np.testing.assert_array_equal(o, np.sort(r))
    f = m["fleet"]
    assert f["admitted"] == f["completed"] == len(reqs)
    assert f["failed"] == 0 and f["live_workers"] == [0, 1, 2, 3]
    assert f["latency_ms"]["p99"] >= f["latency_ms"]["p50"] > 0
    assert set(m["workers"]) == {"0", "1", "2", "3"}
    assert sum(w["completed"] for w in m["workers"].values()) == len(reqs)
    assert rep["subsystem"] == "repro_torch.serve.fleet"
    assert rep["config"]["workers"] == 4 and rep["chaos"] is None


def test_mixed_dtypes_are_isolated_per_affinity_key():
    """int32 and uint32 of one size are distinct keys: they concentrate on
    their (possibly different) affine workers and NEVER share a batch."""
    n = 700
    xs = [
        np.random.default_rng(i).integers(0, 1 << 30, n).astype(
            "int32" if i % 2 else "uint32"
        )
        for i in range(24)
    ]
    with cpu_fleet(WORKERS4) as fleet:
        outs = [f.result(timeout=120) for f in [fleet.submit(x) for x in xs]]
        m = fleet.metrics()
    for o, x in zip(outs, xs):
        np.testing.assert_array_equal(o, np.sort(x))
        assert o.dtype == x.dtype
    # per-worker sortd buckets are keyed dtype/bucket: a mixed batch would
    # have to coalesce under one key, which the key itself forbids
    per_key: dict = {}
    for w in m["workers"].values():
        for bucket_key, b in w["sortd"]["buckets"].items():
            per_key[bucket_key] = per_key.get(bucket_key, 0) + b["requests"]
    assert per_key == {"int32/1024": 12, "uint32/1024": 12}
    homes = {
        k: rendezvous_worker(k, (0, 1, 2, 3))
        for k in (("int32", 1024), ("uint32", 1024))
    }
    for key, home in homes.items():
        w = m["workers"][str(home)]["sortd"]["buckets"]
        assert f"{key[0]}/{key[1]}" in w


def test_chaos_kill_mid_load_loses_nothing():
    """The acceptance scenario: 4 workers, closed-loop load, kill one
    mid-load — zero wrong/lost answers, survivors absorb the backlog."""
    reqs = request_mix(120, seed=13)
    chaos = ChaosConfig(name="kill", kill_worker_after=40)
    with cpu_fleet(WORKERS4, chaos=chaos) as fleet:
        wall, outs = drive_closed_loop(fleet.submit, reqs, clients=8)
        rep = fleet.report()
    for o, r in zip(outs, reqs):
        np.testing.assert_array_equal(o, np.sort(r))
    f = rep["fleet"]
    victim = rep["chaos"]["killed_worker"]
    assert victim is not None and f["failovers"] == 1
    assert f["live_workers"] == [w for w in range(4) if w != victim]
    assert f["completed"] == len(reqs) and f["failed"] == 0
    assert rep["chaos"]["fault_scenario"] == f"worker{victim}_down"
    assert rep["workers"][str(victim)]["state"] == "dead"
    assert rep["workers"][str(victim)]["dead_reason"] == "crashed"


def test_targeted_kill_readmits_the_victims_backlog():
    """Concentrate one key's traffic on its affine worker, kill exactly
    that worker, and require the re-admission counters to move."""
    key = affinity_key(np.zeros(900, np.int32))
    victim = rendezvous_worker(key, (0, 1, 2, 3))
    rng = np.random.default_rng(5)
    xs = [rng.integers(0, 1 << 30, 900).astype(np.int32) for _ in range(60)]
    # coalescing-only workers (no idle flush, long deadline): the victim is
    # guaranteed to still HOLD its binned backlog when the kill lands
    cfg = FleetConfig(
        workers=4,
        heartbeat_interval_s=0.005,
        heartbeat_timeout_s=5.0,
        worker_config=SortdConfig(
            max_queue=256, max_wait_s=0.4, block_on_full=False
        ),
    )
    with cpu_fleet(cfg) as fleet:
        futs = [fleet.submit(x) for x in xs]
        fleet.kill_worker(victim)
        outs = [f.result(timeout=120) for f in futs]
        m = fleet.metrics()["fleet"]
    for o, x in zip(outs, xs):
        np.testing.assert_array_equal(o, np.sort(x))
    assert m["failovers"] == 1 and m["readmitted"] > 0
    assert victim not in m["live_workers"]


def test_all_workers_dead_fails_fast_with_fleetdown():
    cfg = FleetConfig(workers=1, heartbeat_interval_s=0.005)
    with cpu_fleet(cfg) as fleet:
        fut = fleet.submit(np.arange(100, dtype=np.int32)[::-1])
        np.testing.assert_array_equal(
            fut.result(timeout=60), np.arange(100, dtype=np.int32)
        )
        fleet.kill_worker(0)
        deadline = time.monotonic() + 10.0
        while fleet.live_workers() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert fleet.live_workers() == []
        with pytest.raises(FleetDown):
            fleet.submit(np.arange(8, dtype=np.int32))


def test_close_serves_jobs_stranded_on_an_undetected_crash():
    """Kill a worker with the monitor effectively disabled, then close():
    the final inline sweep must still resolve every admitted future."""
    cfg = FleetConfig(workers=2, heartbeat_interval_s=30.0)
    key = affinity_key(np.zeros(600, np.int32))
    victim = rendezvous_worker(key, (0, 1))
    rng = np.random.default_rng(9)
    xs = [rng.integers(0, 1 << 30, 600).astype(np.int32) for _ in range(20)]
    fleet = cpu_fleet(cfg)
    try:
        fleet.kill_worker(victim)
        time.sleep(0.05)  # let the kill land before traffic arrives
        futs = [fleet.submit(x) for x in xs]
    finally:
        fleet.close()
    for f, x in zip(futs, xs):
        np.testing.assert_array_equal(f.result(timeout=0), np.sort(x))


def test_fleet_chaos_stall_recovers_via_heartbeat_timeout():
    """A stalled (not crashed) worker: liveness stays true, the heartbeat
    goes stale, failover drains it — answers still exact."""
    key = affinity_key(np.zeros(800, np.int32))
    victim = rendezvous_worker(key, (0, 1, 2, 3))
    cfg = FleetConfig(
        workers=4, heartbeat_interval_s=0.005, heartbeat_timeout_s=0.3
    )
    n_warm = 48
    chaos = ChaosConfig(
        name="stall", stall_worker_ms=1500.0, stall_worker=victim,
        stall_worker_after=n_warm + 1,
    )
    rng = np.random.default_rng(3)
    xs = [rng.integers(0, 1 << 30, 800).astype(np.int32) for _ in range(30)]
    with cpu_fleet(cfg, chaos=chaos) as fleet:
        # warm phase: a same-key burst overflows the steal watermark, so
        # every worker compiles this bucket now — a cold compile during the
        # chaos phase would hold the GIL past the heartbeat timeout and
        # fail over bystanders (the documented false-positive regime)
        warm = [
            rng.integers(0, 1 << 30, 800).astype(np.int32)
            for _ in range(n_warm)
        ]
        for f in [fleet.submit(x) for x in warm]:
            f.result(timeout=120)
        # admission n_warm+1 arms the stall; the victim falls asleep at its
        # next tick (≤ heartbeat_interval).  Send the real traffic only
        # once it is stalled, so its share is stuck behind the sleep and
        # must be failed over — not served in the pre-stall window.
        arming = fleet.submit(rng.integers(0, 1 << 30, 800).astype(np.int32))
        time.sleep(0.05)
        futs = [fleet.submit(x) for x in xs]
        outs = [f.result(timeout=120) for f in futs]
        arming.result(timeout=120)
        rep = fleet.report()
    for o, x in zip(outs, xs):
        np.testing.assert_array_equal(o, np.sort(x))
    f = rep["fleet"]
    assert f["failovers"] >= 1 and victim not in f["live_workers"]
    assert rep["workers"][str(victim)]["dead_reason"] == "heartbeat-timeout"
    assert f["readmitted"] >= 1
    assert f["completed"] == n_warm + 1 + len(xs) and f["failed"] == 0


# ------------------------------------------------ fleet failover equivalence


def _keyed_input(pred, workers: int, count: int, seed: int, avoid=None):
    """Arrays sharing one affinity key whose rendezvous worker satisfies
    ``pred`` (same (dtype, pow2 bucket) key ⇒ same bin ⇒ same worker).
    Searches dtype × pow2-size so every worker index is reachable."""
    live = tuple(range(workers))
    for dt in (np.int32, np.int64, np.uint32):
        for exp in range(6, 14):  # 64 .. 8192, all under max_bucket
            n = 1 << exp
            key = affinity_key(np.zeros(n, dt))
            if key == avoid:
                continue
            if pred(rendezvous_worker(key, live)):
                rng = np.random.default_rng(seed)
                return key, [
                    rng.integers(0, 1 << 30, n).astype(dt)
                    for _ in range(count)
                ]
    raise AssertionError("no (dtype, size) key found for the predicate")


def _fleet_cfg(backlog: int):
    return FleetConfig(
        workers=3,
        # no stealing: the victim must HOLD its binned backlog
        steal_watermark=10_000,
        heartbeat_interval_s=0.005,
        heartbeat_timeout_s=10.0,  # cold compiles must not fail over bystanders
        worker_config=SortdConfig(
            max_queue=256,
            max_batch=backlog + 8,  # never flush on batch size
            max_wait_s=1.0,  # hold the bin long enough for the kill to land
            block_on_full=False,
        ),
    )


@pytest.mark.parametrize(
    ("victim", "backlog"), [(0, 6), (1, 6), (1, 12)]
)
def test_chaos_kill_and_worker_down_are_the_same_failover(victim, backlog):
    """Chaos-killing worker ``w`` and applying ``worker_down(w)`` must be
    indistinguishable: byte-identical results and identical failover /
    re-admission counters (they are literally one code path)."""
    vkey, xs = _keyed_input(lambda w: w == victim, 3, backlog, seed=13)
    # the trigger/extra request routes to a survivor, not the victim
    _, (extra,) = _keyed_input(
        lambda w: w != victim, 3, 1, seed=14, avoid=vkey
    )
    warm = xs[0]

    def run(chaos, apply_scenario):
        cfg = _fleet_cfg(backlog)
        with cpu_fleet(cfg, chaos=chaos) as fleet:
            # warm the victim's bucket so the backlog phase is compile-free
            fleet.submit(warm).result(timeout=120)
            futs = [fleet.submit(x) for x in xs]
            fut_extra = fleet.submit(extra)  # in chaos mode: the trigger
            if apply_scenario:
                fleet.apply_fault_scenario(FaultScenario.worker_down(victim))
            outs = [f.result(timeout=120) for f in futs]
            out_extra = fut_extra.result(timeout=120)
            deadline_metrics = fleet.metrics()
            return outs, out_extra, deadline_metrics

    # run A: deterministic chaos kill on the (warm + backlog + 1)-th admission
    chaos = ChaosConfig(
        name="kill-victim",
        kill_worker_after=1 + backlog + 1,
        kill_worker=victim,
    )
    outs_a, extra_a, m_a = run(chaos, apply_scenario=False)
    # run B: the same kill expressed as a simulated topology fault
    outs_b, extra_b, m_b = run(None, apply_scenario=True)

    for x, oa, ob in zip(xs, outs_a, outs_b):
        np.testing.assert_array_equal(oa, np.sort(x))
        assert oa.tobytes() == ob.tobytes()
    np.testing.assert_array_equal(extra_a, np.sort(extra))
    assert extra_a.tobytes() == extra_b.tobytes()

    fa, fb = m_a["fleet"], m_b["fleet"]
    assert fa["failovers"] == fb["failovers"] == 1
    assert fa["readmitted"] == fb["readmitted"] == backlog
    assert m_a["workers"][str(victim)]["state"] == "dead"
    assert m_b["workers"][str(victim)]["state"] == "dead"
    # the fleet records the shared scenario vocabulary in both modes
    assert fa["fault_scenario"] == fb["fault_scenario"] == f"worker{victim}_down"


def test_fleet_residual_link_fault_degrades_survivors():
    """A pure link fault kills nobody: every worker's engine serves the
    degraded scenario (exact results, annotated plans), and clearing it
    heals the fleet."""
    rng = np.random.default_rng(21)
    xs = [rng.integers(0, 1 << 30, 1024).astype(np.int32) for _ in range(8)]
    cfg = FleetConfig(workers=2, heartbeat_timeout_s=10.0)
    with cpu_fleet(cfg) as fleet:
        for x in xs:  # warm both workers before faulting
            fleet.submit(x).result(timeout=120)
        summary = fleet.apply_fault_scenario(FaultScenario.optical_link_down(1))
        assert summary == {
            "scenario": "optical_g1_down",
            "killed_workers": [],
            "residual_faults": 1,
        }
        for x in xs:
            np.testing.assert_array_equal(
                fleet.submit(x).result(timeout=120), np.sort(x)
            )
        m = fleet.metrics()
        assert m["fleet"]["fault_scenario"] == "optical_g1_down"
        assert all(
            w["fault"] == "optical_g1_down" for w in m["workers"].values()
        )
        assert fleet.report()["faults"] == summary
        fleet.apply_fault_scenario(None)
        m = fleet.metrics()
        assert m["fleet"]["fault_scenario"] is None
        assert all(w["fault"] is None for w in m["workers"].values())
        assert m["fleet"]["failovers"] == 0


# ------------------------------------------------------------ launch counts
def test_launch_counts_are_exact_under_threads():
    """4 threads x 1,000 counted launches of every kernel lose no count;
    calls of a kernel's plain version (CPU tensors), 4 threads x 50, count
    nothing."""
    reset_launches()
    barrier = threading.Barrier(4)

    def launcher():
        barrier.wait()
        for _ in range(1000):
            for fn in KERNELS.values():
                _launches.count(fn)

    threads = [threading.Thread(target=launcher) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert launch_counts() == {name: 4000 for name in KERNELS}
    reset_launches()

    x = torch.arange(128, dtype=torch.int32).flip(0)[None].repeat(2, 1)
    lens = torch.tensor([100, 7], dtype=torch.int32)
    sorted_rows = []

    def plain_calls():
        for _ in range(50):
            out = KERNELS["batched_row_sort"](x, lens)
        sorted_rows.append(bool((out[0, :100] == x[0, :100].sort().values).all()))

    threads = [threading.Thread(target=plain_calls) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted_rows == [True] * 4
    assert launch_counts() == {name: 0 for name in KERNELS}
