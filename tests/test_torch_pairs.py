"""The port's pair kernels (K5, K6, K7) and its ``sort_pairs`` /
``argsort_keys`` against the JAX package's, on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode (``ops`` and the
engine's flat path do so on the CPU by themselves); the port runs on the
CPU, where its wrappers take the kernels' plain versions.  Every
comparison is exact: keys and payloads byte for byte.  The bitonic pair
network is data-oblivious and never swaps a tie, so the same stages give
the same permutation.  Where the two packages route differently (64-bit
keys run on the port's kernel, on JAX's host argsort; JAX without x64
downcasts 64-bit payloads), the port is held to numpy instead.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SortEngine as JaxSortEngine
from repro.kernels import batched as jbatched
from repro.kernels import bitonic as jbitonic
from repro.kernels import ops as jops
from repro_torch import dtypes
from repro_torch.core import SortEngine, SortPlan, pytree
from repro_torch.kernels import batched, bitonic, launch_counts, ops

KEY_DTYPES = (np.int8, np.int16, np.int32, np.uint32, np.float32)


def _name(d):
    return np.dtype(d).name


def _keys(rng, n, dtype):
    """Keys with ties, dtype-max (sentinel-equal) keys and, for floats,
    -0.0 beside +0.0."""
    dt = np.dtype(dtype)
    if dt.kind == "f":
        x = rng.standard_normal(n).astype(dt)
        x[::5] = -0.0
        x[1::5] = 0.0
        x[2::9] = np.inf
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True).astype(dt)
    x[::7] = info.max
    x[1::6] = x[0]
    return x


def _payload(rng, n, dtype):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        v = rng.standard_normal(n).astype(dt)
        v[::4] = -0.0
        return v
    return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(dt)


def _bytes_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _port_keys(x):
    return dtypes.to_device(x, "cpu")


# ------------------------------------------------------------------- K5
# Every key dtype, every size class and both payload types, without the
# whole product: each new shape costs the interpreted reference seconds.
LOCAL_CASES = [
    (np.int8, 10, np.int32), (np.int8, 1000, np.float32),
    (np.int16, 129, np.float32), (np.int16, 1000, np.int32),
    (np.int32, 10, np.float32), (np.int32, 129, np.int32), (np.int32, 5000, np.int32),
    (np.uint32, 129, np.int32), (np.uint32, 1000, np.float32),
    (np.float32, 10, np.int32), (np.float32, 1000, np.int32), (np.float32, 5000, np.float32),
]


@pytest.mark.parametrize(
    "dtype, n, vdtype", LOCAL_CASES, ids=[f"{_name(d)}-{n}-{_name(v)}" for d, n, v in LOCAL_CASES]
)
def test_local_sort_pairs_matches_pallas_tagged(dtype, n, vdtype, rng):
    k = _keys(rng, n, dtype)
    v = _payload(rng, n, vdtype)
    for n_valid in (n, n - 3):
        want_k, want_v = jops.local_sort_pairs(
            jnp.asarray(k), jnp.asarray(v), n_valid=n_valid, interpret=True
        )
        got_k, got_v = ops.local_sort_pairs(_port_keys(k), torch.from_numpy(v), n_valid=n_valid)
        _bytes_equal(dtypes.to_numpy(got_k, dtype), want_k)
        _bytes_equal(got_v.numpy(), want_v)


@pytest.mark.parametrize("dtype", (np.uint32, np.float32), ids=_name)
def test_sort_pairs_tile_tagged_random_tags_match_pallas(dtype, rng):
    # tags scattered through the tile, not only a pad tail
    n = 1024
    k = _keys(rng, n, dtype)
    v = _payload(rng, n, np.float32)
    t = (rng.random(n) < 0.25).astype(np.int32)
    want_k, want_v = jbitonic.sort_pairs_tile_tagged(
        jnp.asarray(k), jnp.asarray(t), jnp.asarray(v), interpret=True
    )
    got_k, got_v = bitonic.sort_pairs_tile_tagged(_port_keys(k), torch.from_numpy(t), torch.from_numpy(v))
    _bytes_equal(dtypes.to_numpy(got_k, dtype), want_k)
    _bytes_equal(got_v.numpy(), want_v)


def test_sort_pairs_tile_tagged_rows_match_pallas_per_row(rng):
    k = np.stack([_keys(rng, 256, np.int16) for _ in range(3)])
    v = np.stack([_payload(rng, 256, np.int32) for _ in range(3)])
    t = (rng.random((3, 256)) < 0.5).astype(np.int32)
    got_k, got_v = bitonic.sort_pairs_tile_tagged(torch.from_numpy(k), torch.from_numpy(t), torch.from_numpy(v))
    for i in range(3):
        want_k, want_v = jbitonic.sort_pairs_tile_tagged(
            jnp.asarray(k[i]), jnp.asarray(t[i]), jnp.asarray(v[i]), interpret=True
        )
        _bytes_equal(got_k[i].numpy(), want_k)
        _bytes_equal(got_v[i].numpy(), want_v)


@pytest.mark.parametrize(
    "vdtype", (torch.bool, torch.float16, torch.bfloat16, torch.float64, torch.uint8, torch.int64)
)
def test_payload_of_any_width_travels_as_bits(vdtype, rng):
    # the payload is moved, never compared: any dtype of 1, 2, 4 or 8 bytes
    # comes out as its own bit patterns (-0.0 and NaN included), in the
    # order an int32 index payload takes
    n = 512
    k = torch.from_numpy(_keys(rng, n, np.int32))
    t = torch.from_numpy((rng.random(n) < 0.3).astype(np.int32))
    bits = bitonic._BITS[torch.empty((), dtype=vdtype).element_size()]
    v = torch.from_numpy(rng.integers(-128, 128, n)).to(bits).view(vdtype)
    if vdtype.is_floating_point:
        v[::5] = -0.0
        v[1::7] = float("nan")
    ks, vs = bitonic.sort_pairs_tile_tagged(k, t, v)
    _, perm = bitonic.sort_pairs_tile_tagged(k, t, torch.arange(n, dtype=torch.int32))
    assert vs.dtype == vdtype
    assert torch.equal(vs.view(bits), v.view(bits)[perm.long()])
    assert torch.equal(ks, k[perm.long()])


# ------------------------------------------------------------------- K7
@pytest.mark.parametrize("dtype", (np.int8, np.int32, np.uint32, np.float32), ids=_name)
def test_sort_pairs_tile_matches_pallas(dtype, rng):
    k = _keys(rng, 1024, dtype)
    v = _payload(rng, 1024, np.int32)
    want_k, want_v = jbitonic.sort_pairs_tile(jnp.asarray(k), jnp.asarray(v), interpret=True)
    got_k, got_v = bitonic.sort_pairs_tile(_port_keys(k), torch.from_numpy(v))
    _bytes_equal(dtypes.to_numpy(got_k, dtype), want_k)
    _bytes_equal(got_v.numpy(), want_v)


def test_untagged_is_tagged_with_every_tag_zero(rng):
    k = torch.from_numpy(_keys(rng, 2048, np.float32))
    v = torch.arange(2048, dtype=torch.int32)
    a = bitonic.sort_pairs_tile(k, v)
    b = bitonic.sort_pairs_tile_tagged(k, torch.zeros(2048, dtype=torch.uint8), v)
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])


# ------------------------------------------------------------------- K6
@pytest.mark.parametrize("dtype", (np.int32, np.uint32), ids=_name)
def test_batched_row_sort_pairs_matches_pallas(dtype, rng):
    # the shape and lengths of the reference's own test, with garbage in
    # the pad cells and half the keys equal to the dtype max
    hi = np.iinfo(dtype).max
    B, L = 5, 256
    k = np.where(rng.random((B, L)) < 0.5, hi, hi - 1).astype(dtype)
    k[2, 150:] = rng.integers(0, 100, L - 150).astype(dtype)
    v = rng.integers(1, 1 << 30, (B, L)).astype(np.int32)
    lens = np.array([256, 0, 100, 255, 1], np.int32)
    want_k, want_v = jbatched.batched_row_sort_pairs(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), interpret=True
    )
    got_k, got_v = batched.batched_row_sort_pairs(_port_keys(k), torch.from_numpy(v), torch.from_numpy(lens))
    _bytes_equal(dtypes.to_numpy(got_k, dtype), want_k)
    _bytes_equal(got_v.numpy(), want_v)
    assert (got_v.numpy()[1] == 0).all()


def test_batched_row_sort_pairs_is_the_tagged_sort_of_its_fill(rng):
    k = torch.from_numpy(_keys(rng, 4 * 512, np.int64).reshape(4, 512))
    v = torch.from_numpy(_payload(rng, 4 * 512, np.float64).reshape(4, 512))
    lens = torch.tensor([512, 3, 0, 300], dtype=torch.int32)
    ks, vs = batched.batched_row_sort_pairs(k, v, lens)
    valid = torch.arange(512)[None] < lens[:, None]
    fk = torch.where(valid, k, torch.iinfo(torch.int64).max)
    fv = torch.where(valid, v, torch.zeros((), dtype=v.dtype))
    want = bitonic.sort_pairs_tile_tagged(fk, (~valid).to(torch.uint8), fv)
    assert torch.equal(ks, want[0]) and torch.equal(vs.view(torch.int64), want[1].view(torch.int64))


# ------------------------------------------------------------- wrappers
@pytest.mark.parametrize(
    "call, err",
    [
        (lambda: bitonic.sort_pairs_tile(torch.zeros(200, dtype=torch.int32), torch.zeros(200)), ValueError),
        (lambda: bitonic.sort_pairs_tile(torch.zeros(128, dtype=torch.int32), torch.zeros(256)), ValueError),
        (lambda: bitonic.sort_pairs_tile(torch.zeros(128, dtype=torch.float64), torch.zeros(128)), TypeError),
        (lambda: bitonic.sort_pairs_tile(torch.zeros(128, dtype=torch.int32), torch.zeros(128, dtype=torch.complex128)), TypeError),
        (lambda: bitonic.sort_pairs_tile_tagged(torch.zeros(128, dtype=torch.int32), torch.zeros(128), torch.zeros(128)), TypeError),
        (lambda: bitonic.sort_pairs_tile_tagged(torch.zeros(128, dtype=torch.int32), torch.zeros(64, dtype=torch.int32), torch.zeros(128)), ValueError),
        (lambda: batched.batched_row_sort_pairs(torch.zeros(2, 128, dtype=torch.int32), torch.zeros(2, 128), torch.zeros(2, dtype=torch.int64)), ValueError),
        (lambda: batched.batched_row_sort_pairs(torch.zeros(2, 128, dtype=torch.int32), torch.zeros(2, 256), torch.zeros(2, dtype=torch.int32)), ValueError),
        (lambda: ops.local_sort_pairs(torch.zeros(ops.MAX_TILE + 1, dtype=torch.int32), torch.zeros(ops.MAX_TILE + 1)), ValueError),
    ],
    ids=["not_lanes", "vals_shape", "float64_keys", "wide_payload", "float_tags", "tags_shape", "lens_dtype", "row_vals_shape", "past_max_tile"],
)
def test_pair_wrappers_reject_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


def test_pair_wrappers_on_cpu_tensors_launch_nothing(rng):
    before = launch_counts()
    k = torch.from_numpy(_keys(rng, 256, np.int32))
    v = torch.arange(256, dtype=torch.int32)
    bitonic.sort_pairs_tile(k, v)
    bitonic.sort_pairs_tile_tagged(k, torch.zeros(256, dtype=torch.bool), v)
    batched.batched_row_sort_pairs(k.view(2, 128), v.view(2, 128), torch.tensor([3, 128], dtype=torch.int32))
    ops.local_sort_pairs(k[:100], v[:100])
    assert launch_counts() == before
    for name in ("sort_pairs_tile_tagged", "batched_row_sort_pairs", "sort_pairs_tile"):
        assert name in before


# --------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def jax_engine():
    return JaxSortEngine()


@pytest.fixture
def port():
    return SortEngine(device="cpu")


def _plan(eng):
    r = eng.last_report
    return dataclasses.asdict(r["plan"]), {k: r[k] for k in ("n", "overflow_retries", "counts_sum")}


@pytest.mark.parametrize("n", (257, 1000))
@pytest.mark.parametrize("dtype", (np.int32, np.uint32, np.float32), ids=_name)
def test_sort_pairs_flat_matches_reference(dtype, n, jax_engine, port, rng):
    k = _keys(rng, n, dtype)
    v = _payload(rng, n, np.int32 if dtype != np.float32 else np.float32)
    want_k, want_v = jax_engine.sort_pairs(k, v)
    got_k, got_v = port.sort_pairs(k, v)
    assert isinstance(got_k, torch.Tensor) and got_k.device == port.device
    _bytes_equal(got_k.numpy(), want_k)
    _bytes_equal(got_v.numpy(), want_v)


def test_sort_pairs_flat_takes_tensors(port, rng):
    k = _keys(rng, 300, np.int32)
    v = _payload(rng, 300, np.float32)
    a = port.sort_pairs(k, v)
    b = port.sort_pairs(torch.from_numpy(k), torch.from_numpy(v))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=_name)
def test_argsort_keys_matches_reference(dtype, jax_engine, port, rng):
    k = _keys(rng, 700, dtype)
    want_k, want_perm = jax_engine.argsort_keys(k)
    got_k, got_perm = port.argsort_keys(k)
    _bytes_equal(got_k, want_k)
    _bytes_equal(got_perm, want_perm)
    assert _plan(port) == _plan(jax_engine)
    assert port.last_report["plan"].path == "sim"


def test_argsort_keys_past_max_tile_takes_the_reference_host_route(jax_engine, port, rng):
    k = rng.integers(-1000, 1000, ops.MAX_TILE + 1).astype(np.int32)
    want_k, want_perm = jax_engine.argsort_keys(k)
    got_k, got_perm = port.argsort_keys(torch.from_numpy(k))
    _bytes_equal(got_k, want_k)
    _bytes_equal(got_perm, want_perm)
    assert _plan(port) == _plan(jax_engine)


def _held_to_numpy(keys, ks, perm, payloads=()):
    """Keys equal np.sort, keys[perm] equals them, perm is a permutation,
    and every payload stays with its key."""
    np.testing.assert_array_equal(ks, np.sort(keys))
    np.testing.assert_array_equal(keys[perm], ks)
    np.testing.assert_array_equal(np.sort(perm), np.arange(keys.size))
    for src, got in payloads:
        assert np.asarray(got).tobytes() == src[perm].tobytes()


def test_argsort_keys_int64_runs_on_the_kernel(port, rng):
    # jax without x64 sends these to its host argsort; torch is exact on the device
    k = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 3000, dtype=np.int64, endpoint=True)
    k[::11] = np.iinfo(np.int64).max
    ks, perm = port.argsort_keys(k)
    _held_to_numpy(k, ks, perm)
    assert port.last_report["plan"].path == "sim"


@pytest.mark.parametrize("kdtype", (np.int64, np.uint64, np.int32), ids=_name)
def test_sort_pairs_flat_64bit_held_to_numpy(kdtype, port, rng):
    k = _keys(rng, 2000, kdtype) if kdtype != np.uint64 else rng.integers(0, 2**64 - 1, 2000, dtype=np.uint64, endpoint=True)
    v = _payload(rng, 2000, np.float64)
    v[::3] = np.nan
    ks, vs = port.sort_pairs(k, v)
    ks = dtypes.to_numpy(ks, kdtype) if ks.dtype not in (torch.uint64,) else ks.numpy()
    np.testing.assert_array_equal(ks, np.sort(k))
    _, perm = port.argsort_keys(k)
    assert vs.numpy().tobytes() == v[perm].tobytes()


def test_sort_pairs_float64_keys_take_the_host_argsort(port, rng):
    k = rng.standard_normal(500)
    v = np.arange(500, dtype=np.int64)
    ks, vs = port.sort_pairs(k, v)
    _held_to_numpy(k, ks.numpy(), vs.numpy())
    assert port.last_report["plan"].path == "host"
    ks, perm = port.argsort_keys(k)
    _held_to_numpy(k, ks, perm)
    assert "no pair kernel" in port.last_report["plan"].reason


@pytest.mark.parametrize("n", (4096, 5000))
def test_sort_pairs_pytree_three_leaves(n, port, rng):
    # the benchmark's tree: int64, float64 and int8 leaves
    keys = rng.integers(0, 1 << 20, n).astype(np.int32)
    flat = np.arange(n, dtype=np.int32)
    tree = {
        "idx": np.arange(n, dtype=np.int64),
        "nested": (keys.astype(np.float64), (flat % 251).astype(np.int8)),
    }
    ks, out = port.sort_pairs(keys, tree)
    perm = out["idx"]
    _held_to_numpy(keys, ks, perm, [
        (tree["idx"], out["idx"]),
        (tree["nested"][0], out["nested"][0]),
        (tree["nested"][1], out["nested"][1]),
    ])
    assert set(out) == {"idx", "nested"} and isinstance(out["nested"], tuple)


def test_sort_pairs_pytree_matches_reference(jax_engine, port, rng):
    keys = _keys(rng, 300, np.int32)
    tree = {"b": [np.arange(300, dtype=np.int32), None], "a": (_payload(rng, 300, np.float32).reshape(100, 3).repeat(3, 0),)}
    want_k, want = jax_engine.sort_pairs(keys, tree)
    got_k, got = port.sort_pairs(keys, tree)
    _bytes_equal(got_k, want_k)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _bytes_equal(g, w)


def test_sort_pairs_pytree_leaf_shape_mismatch_raises(jax_engine, port):
    x = np.arange(64, dtype=np.int32)
    with pytest.raises(ValueError, match="leading dim") as got:
        port.sort_pairs(x, {"bad": np.arange(63)})
    with pytest.raises(ValueError, match="leading dim") as want:
        jax_engine.sort_pairs(x, {"bad": np.arange(63)})
    assert str(got.value) == str(want.value)


def test_sort_pairs_flat_past_max_tile_raises_as_the_reference(jax_engine, port):
    n = ops.MAX_TILE + 1
    k = np.zeros(n, np.int32)
    v = np.zeros(n, np.int32)
    with pytest.raises(ValueError) as want:
        jax_engine.sort_pairs(k, v)
    with pytest.raises(ValueError) as got:
        port.sort_pairs(k, v)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", (300, 400, 500, 600))
def test_sort_pairs_flat_is_one_pair_sort_at_the_bucket(n, port, rng, monkeypatch):
    calls = []
    sort = bitonic.sort_pairs_tile_tagged

    def spy(keys, tags, vals):
        calls.append((keys.shape[0], int(tags.sum())))
        return sort(keys, tags, vals)

    monkeypatch.setattr(bitonic, "sort_pairs_tile_tagged", spy)
    k = _keys(rng, n, np.int32)
    ks, vs = port.sort_pairs(k, np.arange(n, dtype=np.int32))
    n_pad = ops.bucketed_length(n)
    assert calls == [(n_pad, n_pad - n)]
    _held_to_numpy(k, ks.numpy(), vs.numpy())


# --------------------------------------------------------------- pytree
_Point = collections.namedtuple("_Point", "x y")

TREES = [
    np.arange(3),
    None,
    [1, (2, None), {"b": 3, "a": [4, 5]}],
    {"z": {"y": 1, "x": (2,)}, "a": None},
    _Point(1, [2, 3]),
    (),
    {"k": torch.zeros(2)},
]


@pytest.mark.parametrize("tree", TREES, ids=range(len(TREES)))
def test_pytree_flatten_follows_jax_tree_util(tree):
    def tensor_leaf(x):
        return isinstance(x, torch.Tensor)

    seen = []
    got = pytree.tree_map(lambda leaf: seen.append(leaf) or len(seen) - 1, tree)
    want_leaves, want_def = jax.tree_util.tree_flatten(tree, is_leaf=tensor_leaf)
    assert len(seen) == len(want_leaves)
    assert all(a is b for a, b in zip(seen, want_leaves))
    assert pytree.is_leaf(tree) == (want_def == jax.tree_util.tree_structure(0))
    want = jax.tree_util.tree_unflatten(want_def, range(len(seen)))
    assert got.__class__ is want.__class__
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)


BAD_TREES = [
    5,
    [np.arange(64), np.zeros((2, 64))],
    {"b": np.arange(64), "a": _Point(np.arange(64), np.arange(65))},
]


@pytest.mark.parametrize("tree", BAD_TREES, ids=range(len(BAD_TREES)))
def test_sort_pairs_pytree_bad_leaf_raises_as_the_reference(tree, jax_engine, port):
    x = np.arange(64, dtype=np.int32)
    with pytest.raises(ValueError, match="leading dim") as got:
        port.sort_pairs(x, tree)
    with pytest.raises(ValueError, match="leading dim") as want:
        jax_engine.sort_pairs(x, tree)
    assert str(got.value) == str(want.value)


def test_sort_pairs_none_payload_returns_none(port, rng):
    k = _keys(rng, 50, np.int16)
    ks, out = port.sort_pairs(k, None)
    assert out is None
    np.testing.assert_array_equal(ks, np.sort(k))


def test_host_route_plan_is_named(port):
    k = np.arange(10, dtype=np.float16)
    port.argsort_keys(k)
    assert port.last_report["plan"] == SortPlan(
        "host", "pairs", None, None,
        "argsort: float16 n=10 host stable argsort (no pair kernel for this dtype)",
    )
