"""The port's ``dist_sort`` on 8 gloo ranks against ``repro.core.dist_sort``
under ``shard_map`` on 8 fake XLA devices.

Every case of the reference's ``tests/test_dist_sort.py`` ({random,
sorted, reversed, local} × {sample, paper} at 8,192 keys and a capacity
factor of 8 on ``("data",)`` × 8; ``hier`` on (2, 4) at int32 and uint32;
``sample`` against ``valiant`` on sorted keys at a factor of 2), plus
float32 and uint32 ``paper`` cases.  Each compares the port's per-shard
values and counts with ``==`` against the reference's, on the same mesh
shape: shard *i* is rank *i*, row-major.  One case runs the reference with
its Pallas local sort (interpret mode).  The reference runs in one
subprocess (``XLA_FLAGS`` must be set before jax is imported); the port's
cases all run in one spawned group of 8 ranks, one thread each.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import dist_sort, host_check_globally_sorted
from repro_torch.data import make_array
from repro_torch.runtime import ranks

ROOT = Path(__file__).resolve().parents[1]

# name: (mesh, distribution, dtype, seed, method, capacity factor)
FLAT = ((8,), ("data",))
HIER = ((2, 4), ("pod", "data"))
CASES = {
    **{
        f"{d}-{m}": (FLAT, d, "int32", 3, m, 8.0)
        for d in ("random", "sorted", "reversed", "local")
        for m in ("sample", "paper")
    },
    "hier-int32": (HIER, "random", "int32", 5, "hier", 8.0),
    "hier-uint32": (HIER, "random", "uint32", 6, "hier", 8.0),
    "sorted-sample-cf2": (FLAT, "sorted", "int32", 3, "sample", 2.0),
    "sorted-valiant-cf2": (FLAT, "sorted", "int32", 3, "valiant", 2.0),
    "float32-sample": (FLAT, "random", "float32", 7, "sample", 8.0),
    "float32-paper": (FLAT, "random", "float32", 7, "paper", 8.0),
    "uint32-paper": (FLAT, "random", "uint32", 8, "paper", 8.0),
}
N = 8192
PALLAS_CASE = "random-sample"  # the reference sorts with its Pallas kernels here

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.core import dist_sort
from repro.data.distributions import make_array
from repro.kernels import ops
cases, n, pallas_case, out = eval(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
fns, res = {}, {}
for name, ((shape, names), d, dtype, seed, method, cf) in cases.items():
    key = (shape, method, cf, dtype, name == pallas_case)
    if key not in fns:
        mesh = compat.make_mesh(shape, names)
        kw = {"local_sort": ops.make_local_sort()} if name == pallas_case else {}
        fns[key] = jax.jit(lambda x, mesh=mesh, names=names, method=method, cf=cf, kw=kw: dist_sort(
            x, mesh=mesh, axis_names=names, method=method, capacity_factor=cf, **kw))
    v, c = fns[key](jnp.asarray(make_array(d, n, seed=seed, dtype=np.dtype(dtype))))
    res[name + "/values"], res[name + "/counts"] = np.asarray(v), np.asarray(c)
np.savez(out, **res)
"""


def _rank_cases(mesh, cases, n):
    """Each rank's shard of every case: ``{name: (values, count)}``."""
    meshes = {FLAT: mesh, HIER: ranks.make_mesh(*HIER, "cpu")}
    out = {}
    for name, (m, d, dtype, seed, method, cf) in cases.items():
        x = make_array(d, n, seed=seed, dtype=np.dtype(dtype))
        v, c = dist_sort(x, mesh=meshes[m], axis_names=m[1], method=method, capacity_factor=cf)
        out[name] = (v.numpy(), c.numpy())
    return out


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The reference's and the port's shards of every case, run at once."""
    out = tmp_path_factory.mktemp("dist") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, repr(CASES), str(N), PALLAS_CASE, str(out)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        mine = ranks.run_ranks(_rank_cases, *FLAT, backend="gloo", device="cpu", args=(CASES, N))
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    want = dict(np.load(out))
    return mine, want


@pytest.mark.parametrize("name", list(CASES))
def test_shards_equal_the_reference(name, shards):
    mine, want = shards
    values = np.stack([r[name][0] for r in mine])
    counts = np.concatenate([r[name][1] for r in mine])
    ref_values = want[name + "/values"].reshape(len(mine), -1)
    assert values.dtype == ref_values.dtype
    assert np.array_equal(counts, want[name + "/counts"].ravel()), (counts, want[name + "/counts"])
    assert np.array_equal(values, ref_values)


@pytest.mark.parametrize("name", list(CASES))
def test_valid_prefixes_are_the_sorted_array(name, shards):
    """The reference test's own assertions, on the port's shards."""
    mine, _ = shards
    (_, d, dtype, seed, method, cf) = CASES[name]
    x = make_array(d, N, seed=seed, dtype=np.dtype(dtype))
    values = np.stack([r[name][0] for r in mine])
    counts = np.concatenate([r[name][1] for r in mine])
    got = np.concatenate([values[i][: counts[i]] for i in range(len(mine))])
    assert host_check_globally_sorted(values.ravel(), counts)
    if name == "sorted-sample-cf2":
        assert counts.sum() < N, "expected direct-route overflow"
    elif name == "local-paper":
        # paper splitters under clustered values overflow capacity:
        # detectable as dropped elements, never silent corruption
        assert counts.sum() <= N
    else:
        assert np.array_equal(got, np.sort(x)), name
