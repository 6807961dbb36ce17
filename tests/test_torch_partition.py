"""The port's partition layer and its copied pure-Python modules against the
JAX package: exact bucket ids, scatter, gather, topology, schedule, inputs.

Inputs are made with numpy from a seed and handed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import ohhc_sort as johhc
from repro.core import partition as jpartition
from repro.core import schedule as jschedule
from repro.core import topology as jtopology
from repro.core import workloads as jworkloads
from repro.data import distributions as jdist
from repro_torch import dtypes
from repro_torch.core import engine, ohhc_sort, partition, schedule, topology, workloads
from repro_torch.data import distributions

# jax without x64 holds 32 bits, so the JAX side of each parity test takes
# the narrower dtypes; int64 is held to the exact host rule instead.
NARROW = (np.int8, np.int16, np.int32, np.uint32, np.float32)


def _t(x):
    return dtypes.to_device(x, "cpu")


@pytest.mark.parametrize("dist", ("random", "local", "dupes"))
@pytest.mark.parametrize("dtype", NARROW, ids=lambda d: np.dtype(d).name)
def test_paper_ids_match_reference_bitwise(dtype, dist):
    n, n_pad, P = 1500, 2048, 36
    x = np.zeros(n_pad, dtype)
    x[:n] = distributions.make_array(dist, n, seed=3, dtype=dtype)
    valid = np.arange(n_pad) < n
    want = np.asarray(jengine._paper_ids(jnp.asarray(x), jnp.asarray(valid), P=P))
    got = engine._paper_ids(_t(x), torch.from_numpy(valid), P=P).numpy()
    np.testing.assert_array_equal(got, want)  # pad positions included
    np.testing.assert_array_equal(got[:n], workloads.host_bucket_ids(x[:n], P))


@pytest.mark.parametrize("P", (18, 36, 144, 2304))
def test_paper_ids_int64_full_span_match_host_rule(P, rng):
    info = np.iinfo(np.int64)
    for shift in (0, 1, 31, 40, 62):
        x = rng.integers(info.min, info.max, 3000, dtype=np.int64, endpoint=True) >> shift
        x[:2] = [info.min >> shift, info.max >> shift]
        valid = torch.ones(x.size, dtype=torch.bool)
        got = engine._paper_ids(torch.from_numpy(x), valid, P=P).numpy()
        want = jworkloads.host_bucket_ids(x, P)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(workloads.host_bucket_ids(x, P), want)


def test_udiv64_matches_python_integers(rng):
    d = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 4000, dtype=np.int64, endpoint=True)
    d[:3] = [-1, 0, np.iinfo(np.int64).min]
    for width in (1, 2, 3, 37, (1 << 31) - 1, 1 << 31, (1 << 40) + 7, (1 << 60) + 3):
        got = engine._udiv64(torch.from_numpy(d), width).numpy()
        want = np.array([(int(v) % (1 << 64)) // width for v in d], dtype=np.uint64).view(np.int64)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", NARROW + (np.int64,), ids=lambda d: np.dtype(d).name)
def test_paper_ids_of_a_batch_are_each_rows_own(dtype):
    # every row of a (B, n) batch takes its own span, as if alone
    n_pad, P = 1024, 36
    lens = np.array([1024, 700, 1, 0, 513])
    x = np.zeros((lens.size, n_pad), dtype)
    for i, n in enumerate(lens):
        x[i, :n] = distributions.make_array(("random", "local", "dupes")[i % 3], int(n), seed=40 + i, dtype=dtype)
    valid = torch.arange(n_pad)[None, :] < torch.from_numpy(lens)[:, None]
    got = engine._paper_ids(_t(x), valid, P=P).numpy()
    for i in range(lens.size):
        want = engine._paper_ids(_t(x[i]), valid[i], P=P).numpy()
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i, : lens[i]], workloads.host_bucket_ids(x[i, : lens[i]], P))


def test_udiv64_takes_one_width_per_row(rng):
    d = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, (6, 500), dtype=np.int64, endpoint=True)
    widths = [1, 37, (1 << 31) - 1, 1 << 31, (1 << 40) + 7, (1 << 60) + 3]
    got = engine._udiv64(torch.from_numpy(d), torch.tensor(widths)[:, None]).numpy()
    for row, width in zip(d, widths):
        want = np.array([(int(v) % (1 << 64)) // width for v in row], dtype=np.uint64).view(np.int64)
        np.testing.assert_array_equal(got[widths.index(width)], want)


@pytest.mark.parametrize("capacity", (48, 8), ids=("fits", "overflows"))
def test_scatter_rows_groups_rows_per_launch(capacity, rng, monkeypatch):
    # 1500 buckets a row: a launch takes two rows, so five rows take three
    rows, n, nb = 5, 1000, 1500
    x = rng.integers(-1000, 1000, (rows, n)).astype(np.int32)
    ids = rng.integers(0, nb, (rows, n)).astype(np.int32)
    calls = []
    bcr = partition.ops.bucket_count_rank
    monkeypatch.setattr(partition.ops, "bucket_count_rank", lambda i, b, **kw: calls.append(b) or bcr(i, b, **kw))
    tb, tc = partition.scatter_rows_to_buckets(torch.from_numpy(x), torch.from_numpy(ids), nb, capacity)
    assert calls == [3000, 3000, 1500]
    assert tb.shape == (rows, nb, capacity) and tc.shape == (rows, nb)
    for i in range(rows):  # each row as if alone (the one-row scatter is held to the reference above)
        b, c = partition.scatter_to_buckets(torch.from_numpy(x[i]), torch.from_numpy(ids[i]), nb, capacity)
        np.testing.assert_array_equal(tb[i].numpy(), b.numpy())
        np.testing.assert_array_equal(tc[i].numpy(), c.numpy())


def test_unscatter_gathers_every_row_at_once(rng):
    rows, P, capacity, total = 4, 9, 40, 300
    buckets = torch.from_numpy(np.sort(rng.integers(0, 99, (rows, P, capacity)).astype(np.int32), axis=-1))
    counts = torch.from_numpy(rng.integers(0, capacity + 1, (rows, P)).astype(np.int32))
    got = partition.unscatter(buckets, counts, total)
    assert got.shape == (rows, total)
    for i in range(rows):  # each row as if alone (the one-row gather is held to the reference above)
        np.testing.assert_array_equal(got[i].numpy(), partition.unscatter(buckets[i], counts[i], total).numpy())


@pytest.mark.parametrize("capacity", (64, 24), ids=("fits", "overflows"))
@pytest.mark.parametrize("dtype", (np.int32, np.float32), ids=lambda d: np.dtype(d).name)
def test_scatter_and_unscatter_match_reference(dtype, capacity, rng):
    P = 36
    x = distributions.make_array("random", 1000, seed=5, dtype=dtype)
    ids = jworkloads.host_bucket_ids(x, P).astype(np.int32)
    jb, jc = jpartition.scatter_to_buckets(jnp.asarray(x), jnp.asarray(ids), P, capacity)
    tb, tc = partition.scatter_to_buckets(_t(x), torch.from_numpy(ids), P, capacity)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (int(tc.sum()) < x.size) == (capacity == 24)  # overflow shows as sum < n
    want = np.asarray(jpartition.unscatter(jnp.sort(jb, axis=1), jc, 1000))
    got = partition.unscatter(torch.sort(tb, dim=1).values, tc, 1000).numpy()
    np.testing.assert_array_equal(got, want)


def test_counts_ranks_and_splitter_ids_match_reference(rng):
    x = rng.integers(-500, 500, 2000).astype(np.int32)
    ids = rng.integers(0, 9, 2000).astype(np.int32)
    np.testing.assert_array_equal(
        partition.bucket_counts(torch.from_numpy(ids), 9).numpy(),
        np.asarray(jpartition.bucket_counts(jnp.asarray(ids), 9)),
    )
    np.testing.assert_array_equal(
        partition.bucket_ranks(torch.from_numpy(ids), 9).numpy(),
        np.asarray(jpartition.bucket_ranks(jnp.asarray(ids), 9)),
    )
    spl = np.array(jpartition.sampled_splitters(jnp.asarray(x), 9))
    np.testing.assert_array_equal(partition.sampled_splitters(torch.from_numpy(x), 9).numpy(), spl)
    np.testing.assert_array_equal(
        partition.splitter_bucket_ids(torch.from_numpy(x), torch.from_numpy(spl)).numpy(),
        np.asarray(jpartition.splitter_bucket_ids(jnp.asarray(x), jnp.asarray(spl))),
    )


@pytest.mark.parametrize("dtype", (np.int16, np.int32, np.float32), ids=lambda d: np.dtype(d).name)
def test_paper_bucket_ids_match_reference(dtype):
    x = distributions.make_array("random", 3000, seed=7, dtype=dtype)
    np.testing.assert_array_equal(
        partition.paper_bucket_ids(torch.from_numpy(x), 36).numpy(),
        np.asarray(jpartition.paper_bucket_ids(jnp.asarray(x), 36)),
    )


def test_pack_unpack_match_reference(rng):
    lens = np.array([3, 0, 7, 1])
    keys = rng.integers(0, 100, lens.sum()).astype(np.uint32)
    for align in ("left", "right"):
        np.testing.assert_array_equal(
            partition.pack_segments(keys, lens, 8, align=align),
            jpartition.pack_segments(keys, lens, 8, align=align),
        )
    packed = partition.pack_segments(keys, lens, 8)
    for a, b in zip(partition.unpack_segments(packed, lens), jpartition.unpack_segments(packed, lens)):
        np.testing.assert_array_equal(a, b)
    assert partition.default_capacity(1000, 36) == jpartition.default_capacity(1000, 36)


def test_topology_and_schedule_copies_match_reference():
    assert topology.table_1_1() == jtopology.table_1_1()
    for d_h, variant in ((1, "full"), (2, "half"), (3, "full")):
        t, jt = topology.OHHCTopology(d_h, variant), jtopology.OHHCTopology(d_h, variant)
        assert t.summary == jt.summary
        s, js = schedule.AccumulationSchedule.build(t), jschedule.AccumulationSchedule.build(jt)
        assert s.tree_send_count() == js.tree_send_count()
        assert s.critical_path_rounds() == js.critical_path_rounds()
        sizes = [(7 * i) % 13 for i in range(t.total_procs)]
        assert schedule.payload_bytes_per_round(s, sizes) == jschedule.payload_bytes_per_round(js, sizes)


def test_make_array_matches_reference():
    assert distributions.ALL_DISTRIBUTIONS == jdist.ALL_DISTRIBUTIONS
    assert distributions.PAPER_SIZES_MB == jdist.PAPER_SIZES_MB
    for dtype in (np.int8, np.int16, np.int32, np.int64, np.uint32, np.float32):
        for dist in distributions.ALL_DISTRIBUTIONS:
            for n in (1, 777):  # never "local" at n = 0: the reference raises there
                np.testing.assert_array_equal(
                    distributions.make_array(dist, n, seed=11, dtype=dtype),
                    jdist.make_array(dist, n, seed=11, dtype=dtype),
                )


@pytest.mark.parametrize("method", ("paper", "sampled"))
def test_ohhc_sort_sim_matches_reference(method):
    topo = topology.OHHCTopology(1, "full")
    x = distributions.make_array("random", 3000, seed=13)
    jout, jcounts = johhc.ohhc_sort_sim(jnp.asarray(x), jtopology.OHHCTopology(1, "full"), method=method)
    out, counts = ohhc_sort.ohhc_sort_sim(torch.from_numpy(x), topo, method=method)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_ohhc_sort_host_matches_reference():
    x = distributions.make_array("local", 20_000, seed=17, dtype=np.int16)
    r = ohhc_sort.ohhc_sort_host(x, topology.OHHCTopology(1, "half"))
    jr = johhc.ohhc_sort_host(x, jtopology.OHHCTopology(1, "half"))
    np.testing.assert_array_equal(r.sorted_array, jr.sorted_array)
    np.testing.assert_array_equal(r.bucket_sizes, jr.bucket_sizes)
    assert r.comm_model_time_s == jr.comm_model_time_s
    assert (r.paper_steps, r.tree_sends, r.critical_rounds) == (jr.paper_steps, jr.tree_sends, jr.critical_rounds)
