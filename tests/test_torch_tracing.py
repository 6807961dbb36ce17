"""The port's tracer (``repro_torch.tracing``) on the CPU.

It records only while a ``torch.profiler`` session is open: without one a
sort request and a train step keep nothing and make no CUDA event.  Under
a profiler a sim-path ``SortEngine.sort`` keeps ``engine.sort`` around its
stats, plan, stage, copies, device sort and unmap, one request id, each
span inside its parent, and counts the fresh host buffers it made; a train
step keeps ``train.step`` around forward, backward and optimizer, the
three phases timed by the host clock on the CPU.  Threads keep their own
stacks; the store counts what it drops past its cap.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import SortEngine
from repro_torch.kernels import ops

SORT_N = 5_000


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def tiny_step():
    """A float32 smoke step of a dense arch, its state and one batch."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = registry.get_config("minitron-4b", smoke=True).replace(dtype=torch.float32, remat=False)
    api = registry.get_model_api(cfg)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "train"), warmup_steps=0, total_steps=4)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, run, api)
    return make_train_step(cfg, run, api), state, SyntheticLMData(cfg, 2, 16, seed=0).next_batch()


def _engine():
    return SortEngine(device="cpu")


def _keys(n=SORT_N, dtype=np.int32, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 20, n).astype(dtype)


def test_off_without_a_profiler(tiny_step, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(a) or pytest.fail("an event was made"))
    assert not torch.autograd.profiler._is_profiler_enabled
    eng, x = _engine(), _keys()
    for _ in range(50):
        y = eng.sort(x)
    np.testing.assert_array_equal(y, np.sort(x))
    step, state, batch = tiny_step
    for _ in range(3):
        state, _ = step(state, batch)
    assert tracing.records() == [] and made == [] and tracing.dropped() == 0
    assert tracing.span("engine.sort") is tracing.span("train.step")  # one shared no-op


@pytest.mark.parametrize("dtype", (np.int32, np.float32, np.uint32), ids=lambda d: np.dtype(d).name)
def test_sort_spans_nest_in_order(dtype):
    eng, x = _engine(), _keys(dtype=dtype)
    with profile(activities=[ProfilerActivity.CPU]):
        y = eng.sort(x)
    np.testing.assert_array_equal(y, np.sort(x))
    assert eng.last_report["plan"].path == "sim"
    recs = sorted(tracing.records(), key=lambda r: r["t0"])
    root = recs[0]
    assert root["name"] == "engine.sort" and root["parent"] is None and root["request"] == root["id"]
    assert [r["name"] for r in recs[1:]] == ["engine.stats", "engine.plan", "engine.stage", "engine.h2d",
                                             "engine.device_sort", "engine.d2h", "engine.unmap"]
    assert {r["request"] for r in recs} == {root["id"]}
    for r in recs[1:]:
        assert r["parent"] == root["id"] and root["t0"] <= r["t0"] <= r["t1"] <= root["t1"]
        assert r["device_ms"] is None
    for a, b in zip(recs[1:], recs[2:]):
        assert a["t1"] <= b["t0"]
    item = np.dtype(dtype).itemsize
    padded = ops.bucketed_length(SORT_N)
    mapped = 2 * SORT_N * item if np.dtype(dtype).kind == "u" else 0  # the map in and the map back
    counts = {}
    for r in recs:
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    assert counts == {"engine.host_alloc_bytes": padded * item + SORT_N * item + mapped}


@pytest.mark.parametrize("dtype", (np.int32, np.uint32), ids=lambda d: np.dtype(d).name)
def test_cpu_engine_takes_no_pinned_block(dtype):
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in range(2):
            x = _keys(dtype=dtype, seed=seed)
            np.testing.assert_array_equal(eng.sort(x), np.sort(x))
    item = np.dtype(dtype).itemsize
    mapped = 2 * SORT_N * item if np.dtype(dtype).kind == "u" else 0
    per_request = {}
    for r in tracing.records():
        assert not any(k.startswith("engine.pinned") for k in r["counts"]), r
        per_request[r["request"]] = per_request.get(r["request"], 0) + r["counts"].get("engine.host_alloc_bytes", 0)
    want = ops.bucketed_length(SORT_N) * item + SORT_N * item + mapped  # a fresh padded buffer every request
    assert list(per_request.values()) == [want, want]


def test_each_request_is_its_own(monkeypatch):
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in range(3):
            eng.sort(_keys(seed=seed))
        plan = eng.plan(_keys(), eng.stats(_keys()))
        eng.sort(_keys(), plan=plan)
    recs = tracing.records()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in sorted(roots, key=lambda r: r["t0"])] == ["engine.sort"] * 3 + [
        "engine.stats", "engine.plan", "engine.sort"]
    assert len({r["request"] for r in recs}) == 6
    last = max(roots, key=lambda r: r["t0"])
    assert [r["name"] for r in recs if r["request"] == last["id"]].count("engine.stats") == 0


def test_train_step_spans(tiny_step):
    step, state, batch = tiny_step
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
    recs = sorted(tracing.records(), key=lambda r: r["t0"])
    assert [r["name"] for r in recs] == ["train.step", "train.forward", "train.backward", "train.optimizer"]
    root = recs[0]
    assert root["device_ms"] is None  # the step's root is a span of the host alone
    for r in recs[1:]:
        assert r["request"] == root["id"] and root["t0"] <= r["t0"] <= r["t1"] <= root["t1"]
        assert r["parent"] == root["id"]
        # the phases run on the CPU: their device time is the host clock's
        assert r["device_ms"] == pytest.approx((r["t1"] - r["t0"]) * 1e3)


def test_threads_keep_their_own_stacks():
    start = threading.Barrier(2, timeout=10)
    inner_open = threading.Event()

    def worker(name, wait_inner):
        start.wait()
        with tracing.span(name):
            if wait_inner:
                assert inner_open.wait(10)
            with tracing.span(name + ".inner"):
                tracing.count("n", 1)
                inner_open.set()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=worker, args=(n, w)) for n, w in (("a", True), ("b", False))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)
    recs = {r["name"]: r for r in tracing.records()}
    assert set(recs) == {"a", "a.inner", "b", "b.inner"}
    for name in "ab":
        assert recs[name]["parent"] is None
        assert recs[name + ".inner"]["parent"] == recs[name]["id"]
        assert recs[name + ".inner"]["request"] == recs[name]["id"]
        assert recs[name + ".inner"]["counts"] == {"n": 1} and recs[name]["counts"] == {}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
        tracing.count("outside every span", 1)
    assert [r["name"] for r in tracing.records()] == ["s0", "s1", "s2"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0
