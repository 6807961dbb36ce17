"""The port's ``SortEngine`` against the JAX package's, request for request.

The JAX engine runs its Pallas kernels in interpret mode
(``SortEngine(local_sort=ops.make_local_sort())``, ``REPRO_ROW_BACKEND``
set to a Pallas backend for ``sort_segments``); the port runs on the CPU
(``device="cpu"``), where its wrappers take the kernels' plain versions.
Both get the same numpy input made from a seed, and the same constructor
arguments: the system has no weights, so that is all the state there is.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SortEngine as JaxSortEngine
from repro.kernels import ops as jops
from repro_torch.core import SortEngine, SortPlan, engine
from repro_torch.data import ALL_DISTRIBUTIONS, make_array
from repro_torch.net.faults import FaultScenario

DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint32, np.float32)


@pytest.fixture(scope="module")
def jax_engine():
    # one engine for the module, so its compiled executables are reused
    return JaxSortEngine(local_sort=jops.make_local_sort())


@pytest.fixture
def port():
    return SortEngine(device="cpu")


def _plan_fields(plan):
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("dist", ALL_DISTRIBUTIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_matches_reference(dtype, dist, jax_engine, port):
    x = make_array(dist, 1000, seed=21, dtype=dtype)
    want = jax_engine.sort(x)
    got = port.sort(x)
    assert got.dtype == x.dtype
    assert np.array_equal(got, np.sort(x))
    assert np.array_equal(got, want)
    jr, r = jax_engine.last_report, port.last_report
    if np.dtype(dtype).itemsize == 8:
        # the one deliberate plan change: jax without x64 sends int64 to
        # the host; the port keeps int64 on its sim path
        assert jr["plan"].path == "host"
        assert r["plan"] == engine.choose_plan(
            port.stats(x), port.topo, host_threshold=port.host_threshold
        )
        return
    assert _plan_fields(r["plan"]) == _plan_fields(jr["plan"])
    assert r["overflow_retries"] == jr["overflow_retries"]
    assert r["counts_sum"] == jr["counts_sum"]
    if np.issubdtype(np.dtype(dtype), np.integer):
        np.testing.assert_array_equal(r["counts"], jr["counts"])


def test_int64_plans_onto_the_sim_path(port):
    x = make_array("random", 5000, seed=22, dtype=np.int64)
    got = port.sort(x)
    plan = port.last_report["plan"]
    assert plan.path == "sim" and np.array_equal(got, np.sort(x))
    assert "int64 keys stay on the device path" in plan.reason
    info = np.iinfo(np.int64)
    wide = np.random.default_rng(23).integers(info.min, info.max, 5000, dtype=np.int64, endpoint=True)
    assert np.array_equal(port.sort(wide), np.sort(wide))
    f64 = make_array("random", 5000, seed=22).astype(np.float64)
    assert np.array_equal(port.sort(f64), np.sort(f64))
    assert port.last_report["plan"].path == "host"
    assert "no sort kernel" in port.last_report["plan"].reason


@pytest.mark.parametrize("dtype", (np.int8, np.int32), ids=lambda d: np.dtype(d).name)
def test_overflow_retries_match_reference(dtype, jax_engine, port):
    x = make_array("dupes", 600, seed=24, dtype=dtype)
    plan = SortPlan("sim", "paper", 64, 1024, "forced small capacity")
    want = jax_engine.sort(x, plan=plan)
    got = port.sort(x, plan=plan)
    assert np.array_equal(got, want) and np.array_equal(got, np.sort(x))
    jr, r = jax_engine.last_report, port.last_report
    assert r["overflow_retries"] == jr["overflow_retries"] > 0
    assert r["capacity_used"] == jr["capacity_used"]
    np.testing.assert_array_equal(r["counts"], jr["counts"])


def _segments(rng, dtype, lengths):
    segs = []
    for n in lengths:
        if np.issubdtype(np.dtype(dtype), np.integer):
            info = np.iinfo(dtype)
            s = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True).astype(dtype)
            s[::7] = info.max  # keys equal to the pad sentinel
        else:
            s = rng.standard_normal(n).astype(dtype)
            s[::7] = np.inf
        segs.append(s)
    return segs


@pytest.mark.parametrize("backend", ("pallas", "pallas2op"))
@pytest.mark.parametrize("dtype", (np.int16, np.int32, np.uint32, np.float32), ids=lambda d: np.dtype(d).name)
def test_sort_segments_matches_reference(dtype, backend, jax_engine, port, monkeypatch, rng):
    monkeypatch.setenv("REPRO_ROW_BACKEND", backend)
    segs = _segments(rng, dtype, (0, 1, 127, 128, 129, 200))
    lens = [s.size for s in segs]
    keys = np.concatenate(segs)
    want = jax_engine.sort_segments(keys, lens)
    got = port.sort_segments(keys, lens)
    for g, w, s in zip(got, want, segs):
        assert g.dtype == s.dtype
        assert np.array_equal(g, w) and np.array_equal(g, np.sort(s))
    jr, r = jax_engine.last_report, port.last_report
    assert _plan_fields(r["plan"]) == _plan_fields(jr["plan"])
    assert (r["batch"], r["batch_padded"], r["pad_cells"]) == (jr["batch"], jr["batch_padded"], jr["pad_cells"])


def test_sort_segments_return_padded(port, monkeypatch, rng):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas2op")
    segs = _segments(rng, np.uint32, (5, 0, 130))
    out = port.sort_segments(np.concatenate(segs), [5, 0, 130], return_padded=True)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint32
    assert out.shape == (3, 256) and out.device.type == "cpu"
    host = out.numpy()
    for i, s in enumerate(segs):
        assert np.array_equal(host[i, : s.size], np.sort(s))
        assert (host[i, s.size :] == np.iinfo(np.uint32).max).all()
    trivial = port.sort_segments(np.array([4, 2], np.int16), [1, 1], return_padded=True)
    assert trivial.shape == (2, 128) and trivial[:, 0].tolist() == [4, 2]


def test_sort_segments_int64_stays_on_the_device(port, monkeypatch, rng):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
    info = np.iinfo(np.int64)
    segs = [rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True) for n in (9, 300)]
    out = port.sort_segments(np.concatenate(segs), [9, 300])
    assert port.last_report["plan"].method == "bitonic_pallas"
    for o, s in zip(out, segs):
        assert np.array_equal(o, np.sort(s))


def test_long_segments_take_the_bucket_path(jax_engine, port, rng):
    segs = [make_array("random", n, seed=25 + n) for n in (9000, 300, 12000)]
    lens = [s.size for s in segs]
    keys = np.concatenate(segs)
    assert _plan_fields(port.plan_segments(keys, lens)) == _plan_fields(jax_engine.plan_segments(keys, lens))
    out = port.sort_segments(keys, lens)
    assert port.last_report["plan"].method in ("paper", "sampled")
    for o, s in zip(out, segs):
        assert np.array_equal(o, np.sort(s))


@pytest.mark.parametrize("method", ("paper", "sampled"))
def test_long_segments_share_each_launch(method, jax_engine, port, rng, monkeypatch):
    # rows above the row kernel's reach go through one count/rank and
    # scatter, one local sort and one gather for the whole batch
    segs = [make_array("random", n, seed=60 + n) for n in (9000, 16384, 0)]
    lens = [s.size for s in segs]
    keys = np.concatenate(segs)
    plan = SortPlan("sim", method, 1024, 16384, "forced")
    calls = {"bcr": 0, "local_sort": 0}
    bcr = engine.partition.ops.bucket_count_rank
    def count_bcr(*a, **kw):
        calls["bcr"] += 1
        return bcr(*a, **kw)
    def count_sort(x):
        calls["local_sort"] += 1
        return engine.ops.local_sort(x)
    monkeypatch.setattr(engine.partition.ops, "bucket_count_rank", count_bcr)
    port.local_sort = count_sort
    got = port.sort_segments(keys, lens, plan=plan, return_padded=True)
    assert calls == {"bcr": 1, "local_sort": 1}
    want = np.asarray(jax_engine.sort_segments(keys, lens, plan=plan, return_padded=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert port.last_report["overflow_retries"] == jax_engine.last_report["overflow_retries"]
    for row, s in zip(got.numpy(), segs):
        assert np.array_equal(row[: s.size], np.sort(s))


def test_unforced_backend_races_only_the_row_kernel(port, monkeypatch, rng):
    monkeypatch.delenv("REPRO_ROW_BACKEND", raising=False)
    for dtype, methods in ((np.int32, ("bitonic_pallas", "bitonic2op")), (np.float32, ("bitonic_pallas",))):
        segs = _segments(rng, dtype, (100, 40))
        out = port.sort_segments(np.concatenate(segs), [100, 40])
        plan = port.last_report["plan"]
        assert plan.method in methods and "vmap" not in plan.reason
        for o, s in zip(out, segs):
            assert np.array_equal(o, np.sort(s))


def test_vmap_backend_is_the_library_sort(port, monkeypatch, rng):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "vmap")
    segs = _segments(rng, np.int32, (50, 3))
    out = port.sort_segments(np.concatenate(segs), [50, 3])
    assert port.last_report["plan"].method == "bitonic"
    for o, s in zip(out, segs):
        assert np.array_equal(o, np.sort(s))


def test_no_rebuild_within_a_shape_bucket(port, monkeypatch, rng):
    for n in (1100, 1500, 2000):
        x = make_array("random", n, seed=26)
        assert np.array_equal(port.sort(x), np.sort(x))
    assert port.trace_count == 1  # one pow2 bucket, one capacity, one executor
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
    for lens in ((300, 5), (400, 2, 7, 9)):
        segs = _segments(rng, np.int32, lens)
        port.sort_segments(np.concatenate(segs), list(lens))
    assert port.trace_count == 2


def test_sort_many_and_tensor_input(port, monkeypatch):
    monkeypatch.setenv("REPRO_ROW_BACKEND", "pallas")
    xs = [make_array("random", n, seed=27 + n, dtype=np.int16) for n in (10, 0, 300)]
    for o, x in zip(port.sort_many(xs), xs):
        assert np.array_equal(o, np.sort(x))
    x = make_array("reversed", 3000, seed=28)
    assert np.array_equal(port.sort(torch.from_numpy(x)), np.sort(x))
    assert port.sort(np.array([5], np.int32)).tolist() == [5]


def _forced_dist_plans(mesh):
    """Every dist method forced on a 1-rank mesh: (method, equal to np.sort,
    counts_sum) each; ``hier`` on a (1, 1) mesh."""
    from repro_torch.runtime import ranks

    engines = {
        "flat": SortEngine(mesh=mesh, device="cpu"),
        "hier": SortEngine(mesh=ranks.make_mesh((1, 1), ("pod", "data"), "cpu"), axis_names=("pod", "data"), device="cpu"),
    }
    x = make_array("random", 3001, seed=30)
    out = []
    for method in ("paper", "sample", "valiant", "hier"):
        eng = engines["hier" if method == "hier" else "flat"]
        y = eng.sort(x, plan=SortPlan("dist", method, None, None, "forced"))
        out.append((method, np.array_equal(y, np.sort(x)), eng.last_report["counts_sum"]))
    return out


def test_dist_and_faults_are_not_in_this_slice(port):
    """A forced dist plan on a 1-rank gloo mesh equals ``np.sort`` (the
    multi-rank dist path is held to the reference in
    test_torch_dist_engine.py); the fault ladder is held against the
    reference scenario by scenario in test_torch_faults.py."""
    from repro_torch.runtime import ranks

    (got,) = ranks.run_ranks(_forced_dist_plans, (1,), ("data",), backend="gloo", device="cpu")
    assert got == [(m, True, 3001) for m in ("paper", "sample", "valiant", "hier")]
    sc = FaultScenario.optical_link_down(1)
    assert SortEngine(device="cpu", fault_scenario=sc).fault_scenario is sc
    port.set_fault_scenario(sc)
    assert port.plan(make_array("random", 3000, seed=29)).fault == sc.name
    port.set_fault_scenario(None)
    assert port.plan(make_array("random", 3000, seed=29)).fault is None
    with pytest.raises(ValueError, match="mesh"):
        port.sort(np.arange(10), plan=SortPlan("dist", "paper", None, None, "forced"))


def test_pinned_answers_stay_under_the_ceiling(monkeypatch):
    # the ledger of pinned answers, with pageable blocks in place of pinned
    # ones (pinned memory needs CUDA): an answer counts while it or a view
    # of it lives, and past the ceiling none is handed out
    monkeypatch.setattr(engine, "_pinned_block", lambda n, dtype: torch.empty(n, dtype=dtype))
    monkeypatch.setattr(engine, "PINNED_ANSWER_CEILING", 3 * 400)
    ledger = engine._PinnedAnswers()
    src = torch.arange(100, dtype=torch.int32)
    held = [ledger.answer(src) for _ in range(3)]
    assert ledger.held == 1200 and ledger.answer(src) is None
    assert all(np.array_equal(y, np.arange(100)) and y.flags.writeable for y in held)
    held[1][:] = -1  # no answer aliases another
    assert np.array_equal(held[0], np.arange(100)) and np.array_equal(held[2], np.arange(100))
    view = held[0][10:20].view(np.uint32)
    del held[0]
    assert ledger.held == 1200
    del view
    assert ledger.held == 800
    assert np.array_equal(ledger.answer(src), np.arange(100))  # dropped at once
    held.clear()
    assert ledger.held == 0
