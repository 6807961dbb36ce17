"""The port's ``top_k`` and ``merge_sorted`` against the JAX package's.

The JAX engine runs its Pallas kernels in interpret mode
(``SortEngine(local_sort=ops.make_local_sort())``, or ``jnp.sort`` would
sort its bucket rows); the port runs on the CPU, where its wrappers take
the kernels' plain versions.  Both get the same numpy input made from a
seed, and must give the same results and the same plans: path, method,
capacity, padded length and reason, and the same report counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SortEngine as JaxSortEngine
from repro.core import TopKTooLarge as JaxTopKTooLarge
from repro.core import workloads as jworkloads
from repro.kernels import ops as jops
from repro_torch.core import (
    WORKLOAD_OPS,
    SortEngine,
    SortPlan,
    TopKTooLarge,
    host_top_k,
    merge_sorted_arrays,
    topk_cut,
    workloads,
)
from repro_torch.data import make_array
from repro_torch.kernels import launch_counts

REPORT_KEYS = ("n", "k", "overflow_retries", "skipped_buckets", "kept_count", "counts_sum", "capacity_used")


@pytest.fixture(scope="module")
def jax_engine():
    return JaxSortEngine(local_sort=jops.make_local_sort())


@pytest.fixture
def port():
    return SortEngine(device="cpu")


def _same_report(port, jax_engine):
    r, jr = port.last_report, jax_engine.last_report
    assert (r["plan"] is None) == (jr["plan"] is None)
    if r["plan"] is not None:
        assert dataclasses.asdict(r["plan"]) == dataclasses.asdict(jr["plan"])
    assert {k: r.get(k) for k in REPORT_KEYS} == {k: jr.get(k) for k in REPORT_KEYS}
    if "counts" in jr:
        np.testing.assert_array_equal(r["counts"], np.asarray(jr["counts"]))


CASES = [
    ("int32", "random", 3000, 1800),
    ("int32", "sorted", 2000, 1200),
    ("uint32", "random", 3000, 2000),
    ("float32", "local", 2500, 1500),
    ("int16", "dupes", 2000, 1100),
    ("int8", "random", 1000, 600),
    ("int32", "random", 3000, 40),
    ("float32", "reversed", 3000, 3000),
]


@pytest.mark.parametrize(
    "dtype, dist, n, k", CASES, ids=[f"{d}-{s}-{n}-{k}" for d, s, n, k in CASES]
)
def test_top_k_matches_reference(dtype, dist, n, k, jax_engine, port):
    x = make_array(dist, n, seed=31, dtype=np.dtype(dtype))
    want = jax_engine.top_k(x, k)
    got = port.top_k(x, k)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, np.sort(x)[:k])
    np.testing.assert_array_equal(got, want)
    _same_report(port, jax_engine)
    assert dataclasses.asdict(port.plan_top_k(x, k)) == dataclasses.asdict(jax_engine.plan_top_k(x, k))


def test_top_k_sim_path_runs_one_count_and_one_local_sort(port):
    x = make_array("random", 4000, seed=3)
    calls = []
    sort = port.local_sort
    port.local_sort = lambda rows: calls.append(tuple(rows.shape)) or sort(rows)
    got = port.top_k(x, 3000)
    np.testing.assert_array_equal(got, np.sort(x)[:3000])
    plan = port.last_report["plan"]
    assert plan.path == "sim"
    keep = port.topo.total_procs - port.last_report["skipped_buckets"]
    assert calls == [(keep, plan.capacity)]


def test_top_k_capacity_retry_matches_reference(jax_engine, port):
    x = make_array("random", 3000, seed=5)
    forced = SortPlan("sim", "topk", 8, 4096, "forced small capacity")
    want = jax_engine.top_k(x, 2000, plan=forced)
    got = port.top_k(x, 2000, plan=forced)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x)[:2000])
    assert port.last_report["overflow_retries"] > 0
    _same_report(port, jax_engine)


def test_top_k_keep_retry_matches_reference(jax_engine, port, monkeypatch):
    # a cut that keeps one bucket is too early for k = 2000: both engines
    # widen the kept prefix x2 until it covers rank k
    def early(counts, k):
        return 1, np.asarray(counts).size - 1

    monkeypatch.setattr(jworkloads, "topk_cut", early)
    monkeypatch.setattr(workloads, "topk_cut", early)
    x = make_array("random", 3000, seed=6)
    forced = SortPlan("sim", "topk", 512, 4096, "forced early cut")
    want = jax_engine.top_k(x, 2000, plan=forced)
    got = port.top_k(x, 2000, plan=forced)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x)[:2000])
    assert port.last_report["overflow_retries"] > 0
    _same_report(port, jax_engine)


def test_top_k_edges_match_reference(jax_engine, port):
    x = make_array("random", 500, seed=7)
    for k in (0, 1, 500):
        np.testing.assert_array_equal(port.top_k(x, k), jax_engine.top_k(x, k))
        _same_report(port, jax_engine)
    one = np.array([5], np.int32)
    np.testing.assert_array_equal(port.top_k(one, 1), jax_engine.top_k(one, 1))
    _same_report(port, jax_engine)
    assert dataclasses.asdict(port.plan_top_k(x, 0)) == dataclasses.asdict(jax_engine.plan_top_k(x, 0))


def test_top_k_too_large_and_bad_k_raise_as_the_reference(jax_engine, port):
    x = np.arange(64, dtype=np.int32)
    with pytest.raises(TopKTooLarge) as got:
        port.top_k(x, 65)
    with pytest.raises(JaxTopKTooLarge) as want:
        jax_engine.top_k(x, 65)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)
    for bad, err in ((True, TypeError), (2.0, TypeError), (-1, ValueError)):
        with pytest.raises(err) as got:
            port.top_k(x, bad)
        with pytest.raises(err) as want:
            jax_engine.top_k(x, bad)
        assert str(got.value) == str(want.value)


def test_top_k_int64_stays_on_the_kernels(port):
    # jax without x64 sends 64-bit keys to its host head; the port keeps
    # them on the sim path, held to numpy
    rng = np.random.default_rng(8)
    x = rng.integers(-(2**62), 2**62, 3000, dtype=np.int64)
    got = port.top_k(x, 2500)
    np.testing.assert_array_equal(got, np.sort(x)[:2500])
    assert port.last_report["plan"].path == "sim"
    assert port.plan_top_k(x.astype(np.float64), 2500).path == "host"


def test_top_k_takes_a_tensor(port):
    x = make_array("random", 2000, seed=9)
    np.testing.assert_array_equal(port.top_k(torch.from_numpy(x), 1500), np.sort(x)[:1500])


def test_top_k_sim_path_launches_nothing_on_cpu(port):
    before = launch_counts()
    port.top_k(make_array("random", 2000, seed=10), 1500)
    assert port.last_report["plan"].path == "sim"
    assert launch_counts() == before


# ------------------------------------------------------------------ merge
@pytest.mark.parametrize("dtype", ("int32", "uint32", "float32", "int16"))
def test_merge_sorted_matches_reference(dtype, jax_engine, port):
    dt = np.dtype(dtype)
    whole = make_array("random", 3000, seed=11, dtype=dt)
    buf_j = buf_p = np.empty(0, dt)
    for part in np.array_split(whole, 3):
        buf_j = jax_engine.merge_sorted(buf_j, part)
        buf_p = port.merge_sorted(buf_p, part)
        np.testing.assert_array_equal(buf_p, buf_j)
        r, jr = port.last_report, jax_engine.last_report
        assert dataclasses.asdict(r["plan"]) == dataclasses.asdict(jr["plan"])
        assert dataclasses.asdict(r["inner_plan"]) == dataclasses.asdict(jr["inner_plan"])
        for key in ("n", "overflow_retries", "counts_sum", "merged_new"):
            assert r[key] == jr[key]
    np.testing.assert_array_equal(buf_p, np.sort(whole))
    assert buf_p.dtype == dt


def test_merge_sorted_edges_match_reference(jax_engine, port):
    buf = np.arange(10, dtype=np.int32)
    for new in (np.empty(0, np.int32), np.array([4], np.int32)):
        np.testing.assert_array_equal(port.merge_sorted(buf, new), jax_engine.merge_sorted(buf, new))
        r, jr = port.last_report, jax_engine.last_report
        assert dataclasses.asdict(r["plan"]) == dataclasses.asdict(jr["plan"])
        assert r["merged_new"] == jr["merged_new"]


@pytest.mark.parametrize(
    "buf, new",
    [
        (np.array([3, 1, 2], np.int32), np.array([5], np.int32)),
        (np.array([1], np.int32), np.array([2], np.int64)),
    ],
    ids=["unsorted_buffer", "dtype_mismatch"],
)
def test_merge_sorted_bad_buffer_raises_as_the_reference(buf, new, jax_engine, port):
    with pytest.raises(ValueError) as got:
        port.merge_sorted(buf, new)
    with pytest.raises(ValueError) as want:
        jax_engine.merge_sorted(buf, new)
    assert str(got.value) == str(want.value)


def test_merge_sorted_takes_tensors(port):
    buf = np.sort(make_array("random", 500, seed=12))
    new = make_array("random", 300, seed=13)
    got = port.merge_sorted(torch.from_numpy(buf), torch.from_numpy(new))
    np.testing.assert_array_equal(got, np.sort(np.concatenate([buf, new])))


# -------------------------------------------------------- host arithmetic
def test_workload_copies_match_the_reference():
    assert WORKLOAD_OPS == jworkloads.WORKLOAD_OPS
    counts = np.array([4, 0, 4, 8, 0, 3])
    for k in range(0, 20):
        assert topk_cut(counts, k) == jworkloads.topk_cut(counts, k)
    rng = np.random.default_rng(14)
    for dtype in (np.int32, np.uint32, np.int64, np.float32, np.float64):
        x = make_array("random", 700, seed=15, dtype=np.dtype(dtype))
        for k in (0, 1, 350, 700):
            head, info = host_top_k(x, k, 36)
            want_head, want_info = jworkloads.host_top_k(x, k, 36)
            np.testing.assert_array_equal(head, want_head)
            assert info == want_info
    a = np.sort(rng.integers(0, 50, 40)).astype(np.int32)
    b = np.sort(rng.integers(0, 50, 30)).astype(np.int32)
    np.testing.assert_array_equal(merge_sorted_arrays(a, b), jworkloads.merge_sorted_arrays(a, b))
    for bad in ((b[::-1], a), (a, b[::-1])):
        with pytest.raises(ValueError) as got:
            merge_sorted_arrays(*bad, check=True)
        with pytest.raises(ValueError) as want:
            jworkloads.merge_sorted_arrays(*bad, check=True)
        assert str(got.value) == str(want.value)
