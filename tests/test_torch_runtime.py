"""``repro_torch.runtime`` on 8 gloo ranks against ``repro.runtime`` under
``shard_map`` on 8 fake XLA devices.

* ``int8_psum`` over ``("data",)`` × 8 and ``hierarchical_psum`` on
  (pod 2, data 4), with a leading dim the fast dim divides and one it does
  not (the flat fallback), each rank's result within 1e-6 of the
  reference's shard;
* ``hierarchical_psum`` hands the groups that span both pods 1/4 of the
  bytes that a flat sum hands them, counted by a wrapper over the
  collective calls;
* ``pipeline_forward`` on 4 stages (L 8, M 6, mb 2, d 16, as the
  reference's ``tests/test_pipeline.py``) against the sequential stack and
  against the reference within 1e-5, two pipelines side by side on a
  (2, 4) mesh; ``bubble_fraction``;
* ``elastic_mesh`` shrinking the pod axis and raising, beside the
  reference's shapes; the launcher and the meshes defaulting to the card
  and raising without one; the route of DTensor's gloo CUDA all-gathers
  (``ranks._gloo_cuda_gather``) along dims 0, 1 and -1, forced on CPU
  tensors; a ``reshard_state`` round trip through
  ``full_tensor()`` bit for bit; ``opt_state_specs`` equal to the
  reference's tree.

The reference runs in one subprocess, the port in one spawned group of 8
ranks, one thread each.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.models.common import Spec
from repro_torch.runtime import elastic_mesh, hierarchical_psum, int8_psum, ranks, reshard_state
from repro_torch.runtime.pipeline import bubble_fraction, pipeline_forward

ROOT = Path(__file__).resolve().parents[1]
L, M, MB, D = 8, 6, 2, 16


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {
        "int8": rng.normal(size=(8 * 16, 32)).astype(np.float32),
        "hier": rng.normal(size=(8 * 16, 32)).astype(np.float32),
        "hier_flat": rng.normal(size=(8 * 6, 8)).astype(np.float32),  # 6 rows a rank: 4 ∤ 6
        "w": (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32),
        "x": rng.normal(size=(M, MB, D)).astype(np.float32),
    }


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.runtime.collectives import hierarchical_psum, int8_psum
from repro.runtime.elastic import elastic_mesh
from repro.runtime.pipeline import pipeline_forward
inp, out = dict(np.load(sys.argv[1])), sys.argv[2]
devs = np.array(jax.devices())
mesh8, mesh24 = Mesh(devs, ("data",)), Mesh(devs.reshape(2, 4), ("pod", "data"))
res = {}
f = compat.shard_map(lambda x: int8_psum(x, "data"), mesh=mesh8, in_specs=P("data"), out_specs=P("data"))
res["int8"] = np.asarray(f(jnp.asarray(inp["int8"])))
for k in ("hier", "hier_flat"):
    f = compat.shard_map(lambda x: hierarchical_psum(x, fast_axis="data", slow_axis="pod"),
                         mesh=mesh24, in_specs=P(("pod", "data")), out_specs=P(("pod", "data")))
    res[k] = np.asarray(f(jnp.asarray(inp[k])))
res["pipe"] = np.asarray(pipeline_forward({"w": jnp.asarray(inp["w"])}, jnp.asarray(inp["x"]),
                                          lambda p, x: jnp.tanh(x @ p["w"]), mesh=Mesh(devs[:4], ("pipe",))))
res["elastic"] = np.array(elastic_mesh((4, 2, 1), ("pod", "data", "model"), devices=list(devs[:6])).devices.shape)
np.savez(out, **res)
"""


def _block(p, x):
    return torch.tanh(x @ p["w"])


def _pod_bytes(fn, pod_of):
    """Run ``fn()`` counting the bytes each collective hands a group whose
    ranks span more than one pod."""
    calls = []
    originals = {name: getattr(ranks, name) for name in ("all_reduce", "reduce_scatter", "all_gather")}

    def counting(name):
        def call(*a):
            group = a[-1]
            inp = a[1] if name != "all_reduce" else a[0]
            if len({pod_of(r) for r in dist.get_process_group_ranks(group)}) > 1:
                calls.append(inp.numel() * inp.element_size())
            return originals[name](*a)
        return call

    for name in originals:
        setattr(ranks, name, counting(name))
    try:
        out = fn()
    finally:
        for name, f in originals.items():
            setattr(ranks, name, f)
    return out, sum(calls)


def _gathers(mesh24, rank) -> dict:
    """The gloo CUDA all-gather route on CPU tensors (the route's test
    forced true): each rank's (2, 3) block gathered over ``data`` along
    dims 0, 1 and -1 as DTensor asks for it, a (mesh, mesh dim) group."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank

    def original(*a):
        raise AssertionError("the route fell through to the functional all-gather")

    routed = ranks._routed
    ranks._routed = lambda t, pg: True
    try:
        gather = ranks._gloo_cuda_gather(original)
        out = {dim: gather(x, dim, (mesh24, 1)).numpy() for dim in (0, 1, -1)}
    finally:
        ranks._routed = routed
    out["passes"] = ranks._gloo_cuda_gather(lambda *a: "functional")(x, 1, (mesh24, 1))  # a CPU tensor: not routed
    return out


def _rank_runtime(mesh8, inp):
    rank = dist.get_rank()
    mesh24 = ranks.make_mesh((2, 4), ("pod", "data"), "cpu")
    pipes = ranks.make_mesh((2, 4), ("rep", "pipe"), "cpu")

    def shard(a):
        n = a.shape[0] // 8
        return torch.from_numpy(a[rank * n : (rank + 1) * n])

    res = {"int8": int8_psum(shard(inp["int8"]), "data", mesh=mesh8).numpy()}
    for k in ("hier", "hier_flat"):
        res[k] = hierarchical_psum(shard(inp[k]), fast_axis="data", slow_axis="pod", mesh=mesh24).numpy()
    x = shard(inp["hier"])
    pod_of = lambda r: r // 4  # noqa: E731
    hier, res["hier_pod_bytes"] = _pod_bytes(
        lambda: hierarchical_psum(x, fast_axis="data", slow_axis="pod", mesh=mesh24), pod_of)
    flat, res["flat_pod_bytes"] = _pod_bytes(
        lambda: ranks.all_reduce(x.clone(), dist.ReduceOp.SUM, ranks.axis_group(mesh24, ("pod", "data"))), pod_of)
    res["hier_minus_flat"] = float((hier - flat).abs().max())
    res["gathers"] = _gathers(mesh24, rank)
    res["pipe"] = pipeline_forward({"w": torch.from_numpy(inp["w"])}, torch.from_numpy(inp["x"]), _block,
                                   mesh=pipes, pipe_axis="pipe").numpy()
    shrunk = elastic_mesh((4, 2, 1), ("pod", "data", "model"), devices=range(6), device_type="cpu")
    res["elastic"] = tuple(shrunk.mesh.shape)
    res["elastic_one"] = tuple(elastic_mesh((4, 1, 1), ("pod", "data", "model"), devices=[0],
                                            device_type="cpu").mesh.shape)
    try:
        elastic_mesh((1, 2, 2), ("pod", "data", "model"), devices=[0], device_type="cpu")
        res["elastic_raises"] = False
    except ValueError:
        res["elastic_raises"] = True
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8) / 7,
             "moments": (torch.arange(8, dtype=torch.int32), torch.full((4, 2), -0.0)),
             "count": torch.tensor(3)}
    specs = {"w": Spec(("pod", "data"), None), "moments": (Spec("data"), None), "count": Spec()}
    dt = reshard_state(state, specs, mesh24)
    res["reshard_local"] = {"w": tuple(dt["w"].to_local().shape), "m0": tuple(dt["moments"][0].to_local().shape),
                            "m1": tuple(dt["moments"][1].to_local().shape)}
    full = {"w": dt["w"].full_tensor(), "m0": dt["moments"][0].full_tensor(),
            "m1": dt["moments"][1].full_tensor(), "count": dt["count"].full_tensor()}
    want = {"w": state["w"], "m0": state["moments"][0], "m1": state["moments"][1], "count": state["count"]}
    res["reshard_bits"] = all(
        full[k].dtype == want[k].dtype and torch.equal(full[k].view(-1).view(torch.uint8), want[k].view(-1).view(torch.uint8))
        for k in want
    )
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("runtime")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"), str(d / "reference.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        mine = ranks.run_ranks(_rank_runtime, (8,), ("data",), backend="gloo", device="cpu", args=(inp,))
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return inp, mine, dict(np.load(d / "reference.npz"))


@pytest.mark.parametrize("name", ["int8", "hier", "hier_flat"])
def test_psums_equal_the_reference(name, runs):
    inp, mine, want = runs
    blocks = want[name].reshape(8, -1, *want[name].shape[1:])
    exact = inp[name].reshape(8, -1, *inp[name].shape[1:]).astype(np.float64).sum(axis=0)
    for rank, res in enumerate(mine):
        np.testing.assert_allclose(res[name], blocks[rank], rtol=1e-6, atol=1e-6)
        if name != "int8":
            np.testing.assert_allclose(res[name], exact, rtol=1e-5, atol=1e-5)


def test_int8_psum_is_the_sum_of_the_quantised_inputs(runs):
    inp, mine, _ = runs
    x = inp["int8"].reshape(8, 16, 32)
    scale = np.float32(np.abs(x).max(axis=(1, 2)).max() / np.float32(127.0) + np.float32(1e-12))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int32).sum(axis=0)
    for res in mine:
        assert np.array_equal(res["int8"], q.astype(np.float32) * scale)


def test_hierarchical_psum_cuts_the_pod_bytes_by_the_fast_dim(runs):
    inp, mine, _ = runs
    for res in mine:
        assert res["hier_minus_flat"] < 1e-5
        assert res["flat_pod_bytes"] == 16 * 32 * 4
        assert res["hier_pod_bytes"] * 4 == res["flat_pod_bytes"]


def test_pipeline_equals_the_sequential_stack_and_the_reference(runs):
    inp, mine, want = runs
    ref = torch.from_numpy(inp["x"])
    for w in torch.from_numpy(inp["w"]):
        ref = torch.tanh(ref @ w)
    for res in mine:
        assert res["pipe"].shape == (M, MB, D)
        assert float(np.abs(res["pipe"] - ref.numpy()).max()) < 1e-5
        assert float(np.abs(res["pipe"] - want["pipe"]).max()) < 1e-5


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_gloo_cuda_gather_route_concatenates_in_rank_order(dim, runs):
    _, mine, _ = runs
    for rank, res in enumerate(mine):
        pod = rank // 4
        blocks = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(4 * pod, 4 * pod + 4)]
        assert np.array_equal(res["gathers"][dim], np.concatenate(blocks, axis=dim))
        assert res["gathers"]["passes"] == "functional"


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-9
    assert bubble_fraction(1, 5) == 0.0


def test_elastic_mesh_shrinks_the_pod_axis_and_raises(runs):
    _, mine, want = runs
    for res in mine:
        assert res["elastic"] == tuple(want["elastic"]) == (3, 2, 1)
        assert res["elastic_one"] == (1, 1, 1)  # one live rank: the pod axis shrank
        assert res["elastic_raises"]


def test_ranks_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        ranks.run_ranks(_rank_runtime, (1,), ("data",), backend="gloo", args=({},))
    with pytest.raises(RuntimeError, match="none is available"):
        ranks.make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="none is available"):
        elastic_mesh((1, 1, 1), ("pod", "data", "model"), devices=[0])


def test_reshard_state_round_trips_bit_for_bit(runs):
    _, mine, _ = runs
    for res in mine:
        assert res["reshard_bits"]
        assert res["reshard_local"] == {"w": (1, 8), "m0": (2,), "m1": (4, 2)}


def test_opt_state_specs_equal_the_reference():
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import registry as jregistry
    from repro.models import common as jcommon
    from repro.optim.adamw import opt_state_specs as jopt_state_specs
    from repro_torch.configs import registry as tregistry
    from repro_torch.models.common import AxisRules
    from repro_torch.optim.adamw import opt_state_specs

    rules = AxisRules(batch=("pod", "data"), fsdp="data", tensor="model")
    jrules = jcommon.AxisRules(**{f: getattr(rules, f) for f in jcommon.AxisRules.__dataclass_fields__})
    tcfg, jcfg = tregistry.get_config("deepseek-v2-lite-16b", smoke=True), jregistry.get_config(
        "deepseek-v2-lite-16b", smoke=True)
    got = opt_state_specs(tregistry.get_model_api(tcfg).param_specs(tcfg, rules, 2))
    want = jopt_state_specs(jregistry.get_model_api(jcfg).param_specs(jcfg, jrules, 2))
    want = jax.tree.map(tuple, want, is_leaf=lambda s: isinstance(s, P))
    assert got == want
    assert isinstance(got["count"], Spec) and got["count"] == ()
