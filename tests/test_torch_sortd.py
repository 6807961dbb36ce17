"""The port's sortd service (``repro_torch.serve.sortd``) on the CPU.

The first cases are the reference's ``tests/test_sortd.py`` run over the
port's ``SortEngine(device="cpu")``: coalescing, deadlines, backpressure,
oversize fallback, close/kill and metrics accounting (its ``ServeEngine``
case waits for the model layer).  Short rows take the row kernel's plain
version (``REPRO_ROW_BACKEND=pallas``), as they take the kernel on the
card.  Then one seeded request list goes through the JAX package's
``Sortd`` and the port's, and the outputs must be the same bytes; and the
degraded-serving case of ``tests/test_faults_serving.py``.
"""

import threading
import time

import numpy as np
import pytest

from repro_torch.core import OHHCTopology, SortEngine
from repro_torch.data import make_array
from repro_torch.net.faults import FaultScenario
from repro_torch.serve import QueueFull, Sortd, SortdConfig, affinity_key
from repro_torch.serve.fleet.loadgen import request_mix


@pytest.fixture(autouse=True)
def row_kernel(monkeypatch):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")


TOPO = OHHCTopology(1, "full")


def mk(n, seed=0, dtype=np.int32, dist="random"):
    return make_array(dist, n, seed=seed, dtype=np.dtype(dtype))


# ------------------------------------------------------------- basic flow
def test_submit_result_matches_oracle():
    with Sortd(SortEngine(TOPO, device="cpu")) as sd:
        xs = [mk(n, seed=n) for n in (5, 130, 1000, 2049)]
        futs = [sd.submit(x) for x in xs]
        for x, f in zip(xs, futs):
            np.testing.assert_array_equal(f.result(timeout=120), np.sort(x))
        m = sd.metrics()
    assert m["completed"] == len(xs)
    assert m["failed"] == 0


def test_sync_sort_convenience():
    with Sortd(SortEngine(TOPO, device="cpu")) as sd:
        x = mk(777, seed=3)
        np.testing.assert_array_equal(sd.sort(x), np.sort(x))


def test_flush_on_deadline_single_request():
    """A lone request must not wait for max_batch: the deadline flushes a
    batch of one within max_wait_s (plus sort time)."""
    cfg = SortdConfig(max_batch=64, max_wait_s=0.02)
    with Sortd(SortEngine(TOPO, device="cpu"), cfg) as sd:
        x = mk(512, seed=1)
        t0 = time.monotonic()
        out = sd.submit(x).result(timeout=120)
        elapsed = time.monotonic() - t0
        np.testing.assert_array_equal(out, np.sort(x))
        m = sd.metrics()
    assert m["flushes"]["deadline"] >= 1
    assert m["flushes"]["full"] == 0
    bucket = m["buckets"]["int32/512"]
    assert bucket["requests"] == 1 and bucket["mean_batch"] == 1.0
    # generous bound: deadline + one warm-ish sort, not an unbounded wait
    assert elapsed < 60.0


def test_flush_on_full_batch():
    cfg = SortdConfig(max_batch=4, max_wait_s=30.0)  # deadline can't be the trigger
    with Sortd(SortEngine(TOPO, device="cpu"), cfg, start=False) as sd:
        xs = [mk(300, seed=s) for s in range(4)]
        futs = [sd.submit(x) for x in xs]
        sd.start()
        for x, f in zip(xs, futs):
            np.testing.assert_array_equal(f.result(timeout=120), np.sort(x))
        m = sd.metrics()
    assert m["flushes"]["full"] == 1
    assert m["buckets"]["int32/512"]["mean_batch"] == 4.0


def test_oversize_falls_back_to_direct_engine_path():
    cfg = SortdConfig(max_bucket=256, max_wait_s=0.005)
    eng = SortEngine(TOPO, device="cpu")
    with Sortd(eng, cfg) as sd:
        x = mk(1000, seed=7)  # > max_bucket → never coalesced
        out = sd.submit(x).result(timeout=120)
        np.testing.assert_array_equal(out, np.sort(x))
        m = sd.metrics()
    assert m["oversize_direct"] == 1
    assert "int32/direct" in m["buckets"]
    assert m["buckets"]["int32/direct"]["pad_waste"] == 0.0
    # nothing else in that bucket namespace: no padded bin was created
    assert not any(k.startswith("int32/1024") for k in m["buckets"])


def test_mixed_dtype_requests_never_coalesce():
    """Same lengths, different dtypes → separate bins, separate batches."""
    cfg = SortdConfig(max_batch=64, max_wait_s=0.01)
    with Sortd(SortEngine(TOPO, device="cpu"), cfg, start=False) as sd:
        xi = [mk(200, seed=s, dtype=np.int32) for s in range(3)]
        xf = [mk(200, seed=s, dtype=np.float32) for s in range(3)]
        futs = [sd.submit(x) for x in xi + xf]
        sd.start()
        for x, f in zip(xi + xf, futs):
            out = f.result(timeout=120)
            assert out.dtype == x.dtype
            np.testing.assert_array_equal(out, np.sort(x))
        m = sd.metrics()
    assert set(m["buckets"]) == {"int32/256", "float32/256"}
    for b in m["buckets"].values():
        assert b["requests"] == 3 and b["batches"] == 1 and b["mean_batch"] == 3.0


def test_queue_full_backpressure():
    cfg = SortdConfig(max_queue=2, block_on_full=False)
    sd = Sortd(SortEngine(TOPO, device="cpu"), cfg, start=False)  # stalled worker: queue fills
    try:
        f1 = sd.submit(mk(100, seed=1))
        f2 = sd.submit(mk(100, seed=2))
        with pytest.raises(QueueFull):
            sd.submit(mk(100, seed=3))
        assert sd.metrics()["rejected"] == 1
        sd.start()  # backlog drains once the worker runs
        for f, seed in ((f1, 1), (f2, 2)):
            np.testing.assert_array_equal(
                f.result(timeout=120), np.sort(mk(100, seed=seed))
            )
    finally:
        sd.close()
    assert sd.metrics()["completed"] == 2


def test_close_flushes_pending_and_rejects_new():
    cfg = SortdConfig(max_batch=64, max_wait_s=30.0)  # nothing flushes on its own
    sd = Sortd(SortEngine(TOPO, device="cpu"), cfg, start=False)
    x = mk(128, seed=9)
    fut = sd.submit(x)
    sd.close()  # never-started service must still serve its backlog
    np.testing.assert_array_equal(fut.result(timeout=120), np.sort(x))
    assert sd.metrics()["flushes"]["close"] >= 1
    with pytest.raises(RuntimeError):
        sd.submit(x)


def test_close_under_queued_backlog_drains_every_future():
    """Regression for the fleet's drain lean: close() called while a real
    backlog is still queued/binned on a LIVE worker must serve all of it —
    every pre-close Future resolves exactly — before returning."""
    cfg = SortdConfig(max_batch=1024, max_wait_s=30.0)  # only close flushes
    xs = [mk(n, seed=n) for n in (70, 300, 300, 1200, 1200, 1200, 2900)]
    with Sortd(SortEngine(TOPO, device="cpu"), cfg) as sd:
        futs = [sd.submit(x) for x in xs]
        # no deadline can expire and no batch fills: the backlog is real
    for x, f in zip(xs, futs):
        np.testing.assert_array_equal(f.result(timeout=0), np.sort(x))
    m = sd.metrics()
    assert m["completed"] == len(xs) and m["failed"] == 0
    assert m["flushes"]["close"] >= 1
    assert m["flushes"]["deadline"] == 0 and m["flushes"]["full"] == 0


def test_idle_flush_beats_the_coalescing_deadline():
    """With ``idle_flush_s`` set, a lone request (empty queue ⇒ nobody to
    coalesce with) flushes on the short idle budget instead of waiting out
    ``max_wait_s`` — the fleet's throughput lever (DESIGN.md §10)."""
    cfg = SortdConfig(max_wait_s=2.0, idle_flush_s=1e-4)
    with Sortd(SortEngine(TOPO, device="cpu"), cfg) as sd:
        x = mk(512, seed=2)
        sd.sort(x)  # warm the bucket executable
        t0 = time.monotonic()
        out = sd.submit(x).result(timeout=120)
        elapsed = time.monotonic() - t0
        m = sd.metrics()
    np.testing.assert_array_equal(out, np.sort(x))
    assert m["flushes"]["idle"] >= 1
    assert elapsed < 1.0  # far below the 2s deadline it did NOT wait out


def test_kill_crashes_worker_without_draining():
    """Chaos contract: kill() aborts the worker at its next tick; queued
    futures dangle (the FLEET re-admits them, a lone sortd never will)."""
    from repro_torch.serve.sortd import WorkerKilled  # noqa: F401 — exported name

    cfg = SortdConfig(max_batch=1024, max_wait_s=30.0)
    with Sortd(SortEngine(TOPO, device="cpu"), cfg) as sd:
        fut = sd.submit(mk(256, seed=4))
        sd.kill()
        deadline = time.monotonic() + 10.0
        while sd.worker_alive and time.monotonic() < deadline:
            time.sleep(0.002)
        assert not sd.worker_alive
        assert not fut.done()  # intentionally dangling — a real crash
    assert not fut.done()  # close() must not secretly serve a crashed drain


def test_concurrent_clients_all_exact():
    cfg = SortdConfig(max_batch=16, max_wait_s=0.005, max_bucket=1 << 11)
    failures = []

    def client(cid, sd):
        rng = np.random.default_rng(cid)
        pending = []
        for i in range(15):
            n = int(rng.integers(2, 3000))  # some rows oversize (> 2048)
            x = mk(n, seed=cid * 100 + i)
            pending.append((x, sd.submit(x)))
        for x, f in pending:
            if not np.array_equal(f.result(timeout=120), np.sort(x)):
                failures.append((cid, x.size))

    with Sortd(SortEngine(TOPO, device="cpu"), cfg) as sd:
        ts = [threading.Thread(target=client, args=(c, sd)) for c in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        m = sd.metrics()
    assert not failures
    assert m["completed"] == 45
    assert 0 <= m["latency_ms"]["p50"] <= m["latency_ms"]["p99"]
    for b in m["buckets"].values():
        assert 0.0 <= b["pad_waste"] < 1.0


# ------------------------------------------------ against the JAX package
def _seeded_requests():
    """A serving mix (``loadgen.request_mix``) with both oversize paths,
    float keys, and a merge stream."""
    reqs = request_mix(48, seed=17, max_bucket=1 << 10, oversize_frac=0.1)
    rng = np.random.default_rng(18)
    reqs += [rng.standard_normal(int(n)).astype(np.float32) for n in rng.integers(1, 700, 12)]
    merges = []
    buf = np.sort(rng.integers(0, 1 << 30, 3000).astype(np.int32))
    for n in (100, 900, 2500):
        merges.append((buf, rng.integers(0, 1 << 30, n).astype(np.int32)))
    return reqs, merges


def _serve(sd, reqs, merges):
    futs = [sd.submit(x) for x in reqs] + [sd.submit_merge(b, x) for b, x in merges]
    return futs


@pytest.mark.parametrize("started", [False, True], ids=["backlog", "live"])
def test_outputs_equal_the_jax_sortd_byte_for_byte(started, monkeypatch):
    from repro.core import SortEngine as JaxSortEngine
    from repro.serve.sortd import Sortd as JaxSortd
    from repro.serve.sortd import SortdConfig as JaxSortdConfig
    from repro.serve.sortd import affinity_key as jax_affinity_key

    reqs, merges = _seeded_requests()
    kw = dict(max_batch=8, max_wait_s=0.005, max_bucket=1 << 10)
    results = {}
    for side in ("jax", "port"):
        if side == "jax":
            monkeypatch.setenv("REPRO_ROW_BACKEND", "vmap")  # the reference suite's backend
            sd = JaxSortd(JaxSortEngine(), JaxSortdConfig(**kw), start=started)
        else:
            monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
            sd = Sortd(SortEngine(TOPO, device="cpu"), SortdConfig(**kw), start=started)
        futs = _serve(sd, reqs, merges)
        sd.close()
        results[side] = ([f.result(timeout=0) for f in futs], sd.metrics())
    (jouts, jm), (touts, tm) = results["jax"], results["port"]
    for x, j, t in zip(reqs, jouts, touts):
        assert t.dtype == j.dtype == x.dtype
        assert t.tobytes() == j.tobytes() == np.sort(x).tobytes()
    for (b, x), j, t in zip(merges, jouts[len(reqs):], touts[len(reqs):]):
        assert t.tobytes() == j.tobytes() == np.sort(np.concatenate([b, x])).tobytes()
    for key in ("completed", "failed", "oversize_direct", "rejected"):
        assert tm[key] == jm[key]
    assert set(tm["buckets"]) == set(jm["buckets"])
    if not started:  # a never-started service serves its backlog in one fixed order
        assert tm["flushes"] == jm["flushes"]
        for label, b in tm["buckets"].items():
            jb = jm["buckets"][label]
            assert (b["requests"], b["batches"], b["mean_batch"], b["pad_waste"]) == (
                jb["requests"], jb["batches"], jb["mean_batch"], jb["pad_waste"])
    for x in reqs:
        assert affinity_key(x) == jax_affinity_key(x)


# ------------------------------------------------------- degraded serving
def _x(n=4096, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 31, size=n).astype(np.int32)


def test_sortd_degraded_serving_is_exact_and_reported():
    eng = SortEngine(OHHCTopology(1, "full"), device="cpu")
    xs = [_x(2048, seed=s) for s in range(4)]
    with Sortd(eng, SortdConfig(max_batch=4, max_wait_s=0.005)) as sd:
        for x in xs[:2]:
            np.testing.assert_array_equal(sd.submit(x).result(timeout=120), np.sort(x))
        m0 = sd.metrics()
        assert m0["fault_scenario"] is None
        sd.set_fault_scenario(FaultScenario.optical_link_down(1))
        for x in xs[2:]:
            np.testing.assert_array_equal(sd.submit(x).result(timeout=120), np.sort(x))
        m1 = sd.metrics()
        assert m1["fault_scenario"] == "optical_g1_down"
        assert m1["degraded_flushes"] > m0["degraded_flushes"]
        sd.set_fault_scenario(FaultScenario.worker_down(1))
        for x in xs:
            np.testing.assert_array_equal(sd.submit(x).result(timeout=120), np.sort(x))
        assert eng.last_report["plan"].path == "host"
        sd.set_fault_scenario(None)
        assert sd.metrics()["fault_scenario"] is None
