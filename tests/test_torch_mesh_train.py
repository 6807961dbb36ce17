"""The port's train step over a mesh (``jit_train_step(step, mesh, ...)``,
FSDP × TP on DTensor) against the reference's jitted sharded step,
executed on 8 fake XLA devices, on a (2, 2, 2) ``pod/data/model`` mesh.

Three cases, two steps each, from the reference's
``init_train_state(PRNGKey(0))`` carried across with ``state_from_numpy``
and the same ``SyntheticLMData`` batches at ``ShapeConfig("t", 32, 8,
"train")``, float32 compute:

1. minitron-4b smoke with ``grad_accum=2``; the port's step also takes
   ``grad_specs`` (every gradient replicated: the reference's 'gradrs'
   constraint, which moves layouts, not values);
2. deepseek-v2-lite smoke with ``dispatch="shard_map"`` (the reference's
   ``moesm`` lever), whose MoE runs K1 on each rank's own tokens;
3. the same with ``master_weights`` and ``grad_compression="int8"``.

Each step's loss, ``grad_norm`` and ``clip_scale`` (every metric) and
every parameter after step 2 are held to the tolerances of
``tests/test_torch_train_parity.py``, with its helpers; every leaf of the
state comes back laid out as ``launch.sharding.named(state_specs)``
says (the reference's ``out_shardings``).  One more case:
case 2's state after step 1, saved on the (2, 2, 2) ranks, restored onto
4 ranks at (1, 2, 2) and onto one unsharded process: its leaves equal
the saved ones bit for bit, and its next step matches case 2's step 2.

The reference runs in one subprocess; the port in one spawned group of 8
gloo ranks and one of 4, one thread a rank.  The reference's helpers are
imported inside the tests, so that the ranks, which import this module,
import no jax.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import sharding as SH
from repro_torch.models.common import Spec, tree_leaves, tree_map
from repro_torch.models.convert import state_from_numpy
from repro_torch.runtime import ranks, reshard_state
from repro_torch.train.train_step import jit_train_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]
B, S, LR = 8, 32, 3e-4
MESH = ((2, 2, 2), ("pod", "data", "model"))
CASES = {
    "dense_accum": ("minitron-4b", None, {"grad_accum": 2}),
    "moe_shard_map": ("deepseek-v2-lite-16b", "shard_map", {}),
    "moe_master_int8": ("deepseek-v2-lite-16b", "shard_map", {"master_weights": True, "grad_compression": "int8"}),
}

REFERENCE = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import registry
from repro.configs.base import RunConfig, ShapeConfig
from repro.data.pipeline import SyntheticLMData
from repro.launch import sharding as SH
from repro.train.train_step import init_train_state, make_train_step
cases, out_path = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
shape = ShapeConfig("t", 32, 8, "train")
out = {}
for name, (arch, dispatch, kw) in cases.items():
    cfg = registry.get_config(arch, smoke=True).replace(dtype=jnp.float32)
    if dispatch:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    run = RunConfig(model=cfg, shape=shape, learning_rate=3e-4, warmup_steps=1, total_steps=4, **kw)
    api = registry.get_model_api(cfg)
    rules = SH.rules_for(cfg, shape, mesh)
    state = init_train_state(jax.random.PRNGKey(0), cfg, run, api)
    start = jax.tree.map(np.asarray, state)
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, 2), state["params"], mesh)
    opt = {"m": pspecs, "v": pspecs, "count": P()}
    if run.master_weights:
        opt["master"] = pspecs
    sspecs = {"params": pspecs, "opt": opt, "step": P()}
    if run.grad_compression == "int8":
        sspecs["error_fb"] = pspecs
    bspecs = SH.sanitize_specs(SH.batch_specs(cfg, shape, rules), registry.input_specs(cfg, shape), mesh)
    with compat.set_mesh(mesh):
        step = jax.jit(make_train_step(cfg, run, api, rules),
                       in_shardings=(SH.named(sspecs, mesh), SH.named(bspecs, mesh)),
                       out_shardings=(SH.named(sspecs, mesh), None))
        state = jax.device_put(state, SH.named(sspecs, mesh))
        data = SyntheticLMData(cfg, 8, 32, seed=0)
        metrics = []
        for _ in range(2):
            state, m = step(state, data.next_batch())
            metrics.append({k: float(v) for k, v in m.items()})
    out[name] = (start, metrics, jax.tree.map(np.asarray, state))
pickle.dump(out, open(out_path, "wb"))
"""


def configs(arch: str, dispatch, **kw):
    cfg = registry.get_config(arch, smoke=True).replace(dtype=torch.float32)
    if dispatch:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    shape = ShapeConfig("t", S, B, "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=LR, warmup_steps=1, total_steps=4, **kw)
    return cfg, shape, run


def _quiet():
    # DTensor warns at every reduction over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)


def _host(tree):
    """A state's leaves as plain CPU tensors (DTensors gathered whole)."""
    return tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().cpu().clone(), tree)


def _rank_cases(mesh, starts, ckpt_dir):
    """Two steps of every case on the (2, 2, 2) ranks; case 2 saves its
    state after step 1.  Rank 0 returns the states."""
    _quiet()
    out = {}
    for name, (arch, dispatch, kw) in CASES.items():
        cfg, shape, run = configs(arch, dispatch, **kw)
        state = state_from_numpy(starts[name], "cpu")
        rules, sspecs, bspecs = SH.train_specs(cfg, shape, run, mesh, state["params"])
        grad_specs = SH.spec_map(lambda s: Spec(), sspecs["params"]) if name == "dense_accum" else None
        step = jit_train_step(make_train_step(cfg, run, registry.get_model_api(cfg), rules, grad_specs), mesh,
                              sspecs, bspecs)
        data = SyntheticLMData(cfg, B, S, seed=0)
        metrics, saved = [], None
        for i in range(2):
            state, m = step(state, data.next_batch())
            metrics.append({k: float(v) for k, v in m.items()})
            if name == "moe_shard_map" and i == 0:
                Checkpointer(ckpt_dir).save(1, state)
                saved = _host(state)
        laid_out = SH.spec_map(lambda s, pl, x: tuple(pl) == tuple(x.placements), sspecs, SH.named(sspecs, mesh), state)
        metrics.append({"laid_out": all(tree_leaves(laid_out))})
        final = _host(state)
        out[name] = (metrics, final, saved) if torch.distributed.get_rank() == 0 else (metrics, None, None)
    return out


def _rank_restore(mesh, ckpt_dir, skeleton):
    """Case 2's checkpoint restored onto this mesh, then its step 2."""
    _quiet()
    restored, _ = Checkpointer(ckpt_dir).restore(1, skeleton)
    arch, dispatch, kw = CASES["moe_shard_map"]
    cfg, shape, run = configs(arch, dispatch, **kw)
    rules, sspecs, bspecs = SH.train_specs(cfg, shape, run, mesh, restored["params"])
    state = reshard_state(restored, sspecs, mesh)
    leaves = _host(state)
    step = jit_train_step(make_train_step(cfg, run, registry.get_model_api(cfg), rules), mesh, sspecs, bspecs)
    data = SyntheticLMData(cfg, B, S, seed=0)
    data.next_batch()
    state, m = step(state, data.next_batch())
    return leaves, {k: float(v) for k, v in m.items()}, _host(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(CASES, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "cases.pkl"), str(d / "reference.pkl")],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    with open(d / "reference.pkl", "rb") as f:
        want = pickle.load(f)
    starts = {name: want[name][0] for name in CASES}
    ckpt = str(d / "ckpt")
    mine = ranks.run_ranks(_rank_cases, *MESH, backend="gloo", device="cpu", args=(starts, ckpt))
    skeleton = mine[0]["moe_shard_map"][2]
    four = ranks.run_ranks(_rank_restore, (1, 2, 2), MESH[1], backend="gloo", device="cpu", args=(ckpt, skeleton))
    return want, mine, four, ckpt, skeleton


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_the_reference(name, runs):
    from test_torch_train_parity import bf16_ulp, check_float_leaves, check_metrics, flat

    want, mine, _, _, _ = runs
    _, want_metrics, want_state = want[name]
    master = CASES[name][2].get("master_weights", False)
    for r in mine:  # every rank reports the same metrics, and its state laid out by the specs
        assert r[name][0][-1] == {"laid_out": True}
        check_metrics(r[name][0][:-1], want_metrics, bf16_grads=master)
    assert all(r[name][0] == mine[0][name][0] for r in mine)
    state = mine[0][name][1]
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    if not master:
        check_float_leaves(flat(state["params"]), flat(want_state["params"]))
        return
    check_float_leaves(flat(state["opt"]["master"]), flat(want_state["opt"]["master"]))
    got, bf = flat(state["params"]), flat(want_state["params"])
    for k, w in bf.items():
        assert np.all(np.abs(got[k] - w) <= bf16_ulp(w) + 2 * LR * 1.0004), k


def test_int8_error_feedback_matches_the_reference(runs):
    from test_torch_train_parity import flat

    want, mine, _, _, _ = runs
    got, fb = flat(mine[0]["moe_master_int8"][1]["error_fb"]), flat(want["moe_master_int8"][2]["error_fb"])
    assert set(got) == set(fb)
    for k, w in fb.items():
        largest = max(float(np.abs(w).max()), float(np.abs(got[k]).max()))
        err = np.abs(got[k] - w)
        assert float(np.mean(err > 1e-4 * 127 * 2 * largest)) <= 0.01, k
        assert float(err.max()) <= 2 * largest * (1 + 1e-6), k


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_checkpoint_restores_bit_for_bit_onto_other_meshes(runs):
    _, mine, four, ckpt, skeleton = runs
    saved = mine[0]["moe_shard_map"][2]
    restored, _ = Checkpointer(ckpt).restore(1, skeleton)
    assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(saved)))
    for leaves, _, _ in four:
        assert all(_bits_equal(a, b) for a, b in zip(tree_leaves(leaves), tree_leaves(saved)))


def test_restored_step_matches_the_sharded_step_2(runs):
    from test_torch_train_parity import check_float_leaves, check_metrics, flat

    want, mine, four, ckpt, skeleton = runs
    sharded = mine[0]["moe_shard_map"][0][:2]  # the (2, 2, 2) ranks' two steps
    final = flat(mine[0]["moe_shard_map"][1]["params"])
    for _, metrics, state in four:
        check_metrics([sharded[0], metrics], sharded)
        check_float_leaves(flat(state["params"]), final)
    # one unsharded process: no mesh, so the shard_map dispatch runs 'sorted'
    restored, _ = Checkpointer(ckpt).restore(1, skeleton)
    arch, dispatch, kw = CASES["moe_shard_map"]
    cfg, _, run = configs(arch, dispatch, **kw)
    step = jit_train_step(make_train_step(cfg, run, registry.get_model_api(cfg)))
    data = SyntheticLMData(cfg, B, S, seed=0)
    data.next_batch()
    state, m = step(restored, data.next_batch())
    check_metrics([sharded[0], {k: float(v) for k, v in m.items()}], sharded)
    check_float_leaves(flat(state["params"]), flat(want["moe_shard_map"][2]["params"]))
