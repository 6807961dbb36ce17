"""The dry-run's sharding layer over the port against the JAX package's.

``AxisRules.spec``, the model spec trees (``param_specs`` of both model
APIs), ``launch.sharding`` (``rules_for``, ``sanitize_specs``,
``batch_specs``, ``cache_specs``), ``launch.mesh`` and the registry's cell
functions and ``input_specs``, each held to the reference on the same
configs with ``==``.  The reference's ``PartitionSpec`` is read as a
tuple; the port's ``Spec`` is one.  The reference's functions take a jax
``Mesh`` only for its axis names and shape, so they run here on a
stand-in with those two attributes (no devices are made).
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.launch import sharding as JSH
from repro.models import common as jcommon
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as SH
from repro_torch.launch.dryrun import eval_shape
from repro_torch.models.common import AxisRules, Spec, shapes_only, spec_items, spec_map, tree_leaves

ARCHS = list(tregistry.ARCHS)
MESHES = {
    "pod16x16": ((16, 16), ("data", "model")),
    "pods2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "small2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}


def jmesh(shape, names):
    """The reference's mesh as its sharding code reads it."""
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=np.int8))


def as_tuples(tree):
    """A reference spec tree with every ``PartitionSpec`` read as a tuple."""
    return jax.tree.map(lambda s: tuple(s), tree, is_leaf=lambda s: isinstance(s, P))


def spec_leaves(tree) -> list:
    return [s for _, s in spec_items(tree)]


def jrules(rules: AxisRules) -> jcommon.AxisRules:
    return jcommon.AxisRules(**{f: getattr(rules, f) for f in jcommon.AxisRules.__dataclass_fields__})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ spec()
@pytest.mark.parametrize(
    "rules",
    [
        AxisRules(),
        AxisRules(heads=None, seq="model"),
        AxisRules(batch=None, kv_seq=("data", "model"), heads=None),
        AxisRules(batch=("data",), kv_seq="model"),
    ],
    ids=["default", "sp", "long", "kvseq"],
)
def test_spec_equals_the_reference(rules):
    logical = [
        ("batch", "seq", "heads", None),
        ("batch", "seq", "tensor"),
        ("fsdp", "tensor", None),
        (None, "batch", "kv_seq", "heads", None),
        ("tensor", "fsdp"),
        ("model", "tensor"),
        (None,),
        (),
    ]
    for axes in logical:
        got = rules.spec(*axes)
        assert isinstance(got, Spec)
        assert got == tuple(jrules(rules).spec(*axes)), axes


def test_spec_is_a_leaf_of_spec_trees():
    s = Spec(("pod", "data"), None)
    assert s == (("pod", "data"), None) and repr(s) == "Spec(('pod', 'data'), None)"
    assert Spec(["data"], (), ("pod", "data")) == ("data", None, ("pod", "data"))  # PartitionSpec's canonical form
    assert spec_items({"a": (s, Spec(None)), "b": [Spec("model")]}) == [
        (("a", "0"), s), (("a", "1"), (None,)), (("b", "0"), ("model",))]


# ------------------------------------------------------------- spec trees
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("tp", [1, 2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, tp, smoke):
    tcfg, jcfg = tregistry.get_config(arch, smoke=smoke), jregistry.get_config(arch, smoke=smoke)
    mesh = ((16, tp), ("data", "model"))
    for shape in ("train_4k", "decode_32k"):
        rules = SH.rules_for(tcfg, tbase.SHAPES[shape], tmesh.MeshSpec(*mesh))
        got = tregistry.get_model_api(tcfg).param_specs(tcfg, rules, tp)
        want = jregistry.get_model_api(jcfg).param_specs(jcfg, jrules(rules), tp)
        assert got == as_tuples(want)
        assert all(isinstance(s, Spec) for s in spec_leaves(got))


@pytest.mark.parametrize("mesh", ["pod16x16", "pods2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    tcfg, jcfg = tregistry.get_config(arch), jregistry.get_config(arch)
    tm, jm = tmesh.MeshSpec(*MESHES[mesh]), jmesh(*MESHES[mesh])
    for name, shape in tbase.SHAPES.items():
        rules = SH.rules_for(tcfg, shape, tm)
        jr = JSH.rules_for(jcfg, jbase.SHAPES[name], jm)
        assert SH.batch_specs(tcfg, shape, rules) == as_tuples(JSH.batch_specs(jcfg, jbase.SHAPES[name], jr))
        if shape.kind == "train":
            continue
        tcache = eval_shape(lambda: tregistry.get_model_api(tcfg).init_cache(tcfg, 4, 64, device="meta"))
        jcache = jax.eval_shape(lambda: jregistry.get_model_api(jcfg).init_cache(jcfg, 4, 64))
        got = SH.cache_specs(tcfg, rules, tcache)
        assert got == as_tuples(JSH.cache_specs(jcfg, jr, jcache))
        assert len(spec_leaves(got)) == len(tree_leaves(tcache))


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("mesh", list(MESHES))
def test_rules_for_equals_the_reference_on_every_cell(mesh):
    tm, jm = tmesh.MeshSpec(*MESHES[mesh]), jmesh(*MESHES[mesh])
    assert SH.mesh_axis_sizes(tm) == JSH.mesh_axis_sizes(jm)
    for arch, shape in tregistry.all_cells():
        got = SH.rules_for(tregistry.get_config(arch), tbase.SHAPES[shape], tm)
        want = JSH.rules_for(jregistry.get_config(arch), jbase.SHAPES[shape], jm)
        for field in jcommon.AxisRules.__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), (arch, shape, field)
        assert got.seq_shards == 1


@pytest.mark.parametrize("mesh", ["pod16x16", "pods2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sanitize_specs_on_full_parameter_shapes(arch, mesh):
    tcfg, jcfg = tregistry.get_config(arch), jregistry.get_config(arch)
    tm, jm = tmesh.MeshSpec(*MESHES[mesh]), jmesh(*MESHES[mesh])
    tapi, japi = tregistry.get_model_api(tcfg), jregistry.get_model_api(jcfg)
    rules = SH.rules_for(tcfg, tbase.SHAPES["train_4k"], tm)
    tshape = eval_shape(tapi.init, tcfg, torch.Generator())
    jshape = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg))
    got = SH.sanitize_specs(tapi.param_specs(tcfg, rules, tm.shape[-1]), tshape, tm)
    want = JSH.sanitize_specs(japi.param_specs(jcfg, jrules(rules), tm.shape[-1]), jshape, jm)
    assert got == as_tuples(want)
    # every sanitized spec divides its tensor, and local_shape says how
    for s, t in zip(spec_leaves(got), tree_leaves(_by_specs(got, tshape))):
        local = SH.local_shape(tuple(t.shape), s, tm)
        assert np.prod(t.shape) == np.prod(local) * SH.shard_factor(s, tm)


def _by_specs(specs, tree):
    """``tree``'s leaves in the spec tree's key order."""
    return spec_map(lambda s, t: t, specs, tree)


def test_local_shape_and_shard_factor():
    m = tmesh.MeshSpec((2, 4, 8), ("pod", "data", "model"))
    assert SH.local_shape((64, 32, 5), Spec(("pod", "data"), "model"), m) == (8, 4, 5)
    assert SH.shard_factor(Spec(("pod", "data"), "model", None), m) == 64
    assert SH.local_shape((3,), Spec(None), m) == (3,) and SH.shard_factor(Spec(), m) == 1
    with pytest.raises(ValueError, match="sanitize"):
        SH.local_shape((6,), Spec("model"), m)


# ------------------------------------------------------------ mesh, cells
def test_meshes():
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.size) == ((16, 16), ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.size) == ((2, 16, 16), ("pod", "data", "model"), 512)
    smoke = tmesh.make_smoke_mesh()
    assert smoke.axis_names == ("data",) and smoke.size == max(torch.cuda.device_count(), 1)
    assert tmesh.make_smoke_mesh(3).shape == (3,) and tmesh.make_smoke_mesh(["a", "b"]).shape == (2,)
    with pytest.raises(ValueError, match="rank"):
        tmesh.MeshSpec((2, 2), ("data",))


def test_cell_functions_equal_the_reference():
    assert tregistry.LONG_CONTEXT_OK == jregistry.LONG_CONTEXT_OK
    assert tregistry.all_cells() == jregistry.all_cells()
    assert tregistry.supported_cells() == jregistry.supported_cells()
    assert len(tregistry.supported_cells()) == 34
    for arch, shape in tregistry.all_cells():
        assert tregistry.cell_supported(arch, shape) == jregistry.cell_supported(arch, shape)
        assert tregistry.shape_for(shape) == tbase.SHAPES[shape]
        assert dataclasses_equal(tregistry.shape_for(shape), jregistry.shape_for(shape))


def dataclasses_equal(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in b.__dataclass_fields__)


# the documented dtype mapping: token ids and labels int64 (the port's
# models index with int64), the rest as the reference's
DTYPES = {jax.numpy.dtype("int32"): torch.int32, jax.numpy.dtype("bfloat16"): torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    tcfg, jcfg = tregistry.get_config(arch), jregistry.get_config(arch)
    for name, shape in tbase.SHAPES.items():
        got = tregistry.input_specs(tcfg, shape)
        want = jregistry.input_specs(jcfg, jbase.SHAPES[name])
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta" and tuple(t.shape) == want[k].shape, (name, k)
            expect = torch.int64 if k in ("tokens", "labels") else DTYPES[want[k].dtype]
            assert t.dtype == expect, (name, k)


def test_shapes_only_draws_nothing_and_matches_a_real_init():
    """Inside ``shapes_only()`` an init makes meta tensors and leaves the
    generator where it was; outside it, the same init draws as before."""
    cfg = tregistry.get_config("deepseek-v2-lite-16b", smoke=True)
    api = tregistry.get_model_api(cfg)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with shapes_only():
        meta = api.init(cfg, gen)
    assert torch.equal(gen.get_state(), state)
    real = api.init(cfg, torch.Generator().manual_seed(0))
    again = api.init(cfg, torch.Generator().manual_seed(0))
    for m, r, a in zip(tree_leaves(meta), tree_leaves(real), tree_leaves(again)):
        assert m.device.type == "meta" and r.device.type == "cpu"
        assert (m.shape, m.dtype) == (r.shape, r.dtype)
        assert torch.equal(r, a)
