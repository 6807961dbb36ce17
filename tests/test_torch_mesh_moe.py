"""MoE over a mesh: the port's ``shard_map`` dispatch (``local_map``, K1 on
each rank's own tokens at the local capacity, one all-reduce over the
tensor axis) and its pjit-style ``sorted``/``argsort`` dispatch, on 8 gloo
ranks at (2, 2, 2) ``pod/data/model``, against the reference under
``shard_map`` / ``jit`` on 8 fake XLA devices.

* ``_moe_shard_map``'s output within 1e-5 of the reference's, and the
  kept-assignment mask each rank's dispatch used (recorded from
  ``moe._dispatch``) identical to the one the reference's body keeps
  (``bucket_ranks`` of that batch shard's own assignments under the local
  capacity), at ``capacity_factor`` 4.0 and at 1.0, where tokens drop;
* ``apply_moe`` (router, dispatch, shared experts) with ``sorted``,
  ``sorted`` with ``dispatch_sharded`` and ``expert_parallel``, and
  ``argsort``, within 1e-5 of the reference's under its mesh;
* under a mesh with rules enabled, the encdec and vlm families' forward
  under sequence parallelism (``rules.seq``), and prefill and decode with
  the ``dense`` MoE oracle, which the port once refused, give the
  unsharded calls' logits within 1e-5 (``tests/test_torch_mesh_sp.py``
  holds them to the reference), and ``shard`` raises on a plain tensor;
  with the rules disabled ``shard`` is the identity.

The reference runs in one subprocess, the port in one spawned group of 8
ranks, one thread each; float32 compute, the deepseek-v2-lite smoke
widths (d 64, 8 experts, top-2, expert d_ff 32, 2 shared experts).
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

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import sharding as SH
from repro_torch.models import moe
from repro_torch.models.common import Spec, distribute, set_mesh, shard
from repro_torch.runtime import ranks
from test_torch_mesh_serve import serve_gap

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 32
FACTORS = (4.0, 1.0)
DISPATCHES = {  # name → (dispatch, dispatch_sharded, expert_parallel)
    "sorted": ("sorted", False, False),
    "sorted_sharded_ep": ("sorted", True, True),
    "argsort": ("argsort", False, False),
}

REFERENCE = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.core import partition as core_partition
from repro.launch import sharding as SH
from repro.models import moe
inp, factors, dispatches = pickle.load(open(sys.argv[1], "rb"))
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
base = registry.get_config("deepseek-v2-lite-16b", smoke=True).replace(dtype=jnp.float32)
rules = SH.rules_for(base, ShapeConfig("t", 32, 8, "train"), mesh)
p = {k: jnp.asarray(v) for k, v in inp["p"].items()}
x = jnp.asarray(inp["x"])
B, S, _ = x.shape
out = {}
for cf in factors:
    cfg = base.replace(moe=dataclasses.replace(base.moe, dispatch="shard_map", capacity_factor=cf))
    top_p, top_e, _ = moe._router(p, x, cfg)
    with compat.set_mesh(mesh):
        y = jax.jit(lambda p, x, tp, te: moe._moe_shard_map(p, x, cfg, rules, tp, te))(p, x, top_p, top_e)
    k, E = cfg.moe.num_experts_per_tok, cfg.moe.num_experts
    cap = int(-(-(B // 4) * S * k * cf // E))
    cap += (-cap) % 8
    keep = [np.asarray(core_partition.bucket_ranks(top_e[j * B // 4:(j + 1) * B // 4].reshape(-1), E) < cap)
            for j in range(4)]
    out[cf] = {"y": np.asarray(y), "top_p": np.asarray(top_p), "top_e": np.asarray(top_e),
               "keep": np.concatenate(keep), "cap": cap}
for name, (dispatch, sharded, ep) in dispatches.items():
    cfg = base.replace(moe=dataclasses.replace(base.moe, dispatch=dispatch, dispatch_sharded=sharded,
                                               expert_parallel=ep))
    with compat.set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe.apply_moe(p, x, cfg, rules))(p, x)
    out[name] = {"y": np.asarray(y), "aux": float(aux)}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    d, E, f = 64, 8, 32
    ff = 32 * 2  # shared_d_ff · num_shared_experts
    w = lambda *shape: (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)  # noqa: E731
    p = {"router": w(d, E), "wi": w(E, d, f), "wg": w(E, d, f), "wo": w(E, f, d),
         "shared_wi": w(d, ff), "shared_wg": w(d, ff), "shared_wo": w(ff, d)}
    return {"p": p, "x": rng.normal(size=(B, S, d)).astype(np.float32)}


def _cfg(**moe_kw):
    cfg = registry.get_config("deepseek-v2-lite-16b", smoke=True).replace(dtype=torch.float32)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _forward_gap(cfg, rules, mesh) -> float:
    """The largest logit gap of ``forward`` on a batch of ``B`` x ``S``
    tokens with the family's inputs, laid out as a train step takes it,
    over ``mesh`` under ``rules`` against ``forward`` unsharded, on the
    port's own weights."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.common import lay_out, whole

    api = registry.get_model_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    batch = SyntheticLMData(cfg, B, S, seed=0).next_batch()
    bspecs = SH.sanitize_specs(SH.batch_specs(cfg, ShapeConfig("t", S, B, "train"), rules), batch, mesh)
    with torch.no_grad():
        want, _ = api.forward(params, batch, cfg)
        got, _ = api.forward(lay_out(params, SH.param_layout(cfg, rules, mesh, params), mesh),
                             lay_out(batch, bspecs, mesh), cfg, rules)
    return float((whole(got) - want).abs().max())


def _rank_moe(mesh, inp, want):
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    base = _cfg()
    rules = SH.rules_for(base, ShapeConfig("t", S, B, "train"), mesh)
    pspecs = SH.sanitize_specs(SH.spec_map(lambda s: rules.spec(*s), moe.moe_specs(base, 2)), inp["p"], mesh)
    p = {k: distribute(torch.from_numpy(v), pspecs[k], mesh) for k, v in inp["p"].items()}
    rows = Spec(rules.batch, None, None)
    x = distribute(torch.from_numpy(inp["x"]), rows, mesh)
    # the batch shard this rank's rows are: (pod, data) major to minor
    res = {"shard": mesh.get_local_rank("pod") * mesh.mesh.shape[1] + mesh.get_local_rank("data")}
    kept = []  # the kept mask of every dispatch this rank's body runs
    real_dispatch = moe._dispatch

    def recording(*a, **k):
        y, keep = real_dispatch(*a, **k)
        kept.append(keep.clone())
        return y, keep

    moe._dispatch = recording
    try:
        with set_mesh(mesh):
            for cf in FACTORS:
                cfg = _cfg(dispatch="shard_map", capacity_factor=cf)
                tp, te = (distribute(torch.from_numpy(want[cf][k]), rows, mesh) for k in ("top_p", "top_e"))
                kept.clear()
                y = moe._moe_shard_map(p, x, cfg, rules, tp, te)
                (keep,) = kept
                res[cf] = {"y": y.full_tensor().numpy(), "keep": keep.numpy(), "y_rows": tuple(y.to_local().shape)}
    finally:
        moe._dispatch = real_dispatch
    with set_mesh(mesh):
        for name, (dispatch, sharded, ep) in DISPATCHES.items():
            cfg = _cfg(dispatch=dispatch, dispatch_sharded=sharded, expert_parallel=ep)
            y, aux = moe.apply_moe(p, x, cfg, rules)
            res[name] = {"y": y.full_tensor().numpy(), "aux": float(aux.full_tensor())}
        ran = {}
        seq = dataclasses.replace(rules, seq="model")  # attention under SP on both families
        for arch in ("whisper-tiny", "qwen2-vl-7b"):
            ran[arch] = _forward_gap(registry.get_config(arch, smoke=True).replace(dtype=torch.float32), seq, mesh)
        gaps = serve_gap(_cfg(dispatch="dense"), rules, mesh)  # the dense MoE oracle
        ran["prefill"], ran["decode"] = gaps["prefill"], gaps["decode_step"]
        res["ran"] = ran
        plain = torch.zeros(B, S, 64)
        res["plain_at_shard"] = _raises(lambda: shard(plain, rules, "batch", "seq", None), TypeError)
        res["disabled_is_identity"] = shard(plain, dataclasses.replace(rules, enabled=False), "batch") is plain
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_moe")
    inp = _inputs()
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump((inp, FACTORS, DISPATCHES), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "inputs.pkl"), str(d / "reference.pkl")],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    with open(d / "reference.pkl", "rb") as f:
        want = pickle.load(f)
    return want, ranks.run_ranks(_rank_moe, (2, 2, 2), ("pod", "data", "model"), backend="gloo", device="cpu",
                                 args=(inp, want))


@pytest.mark.parametrize("cf", FACTORS)
def test_shard_map_dispatch_matches_the_reference(cf, runs):
    want, mine = runs
    for res in mine:
        np.testing.assert_allclose(res[cf]["y"], want[cf]["y"], rtol=1e-5, atol=1e-5)
        assert res[cf]["y_rows"] == (B // 4, S, 64)  # each rank keeps its own rows


@pytest.mark.parametrize("cf", FACTORS)
def test_shard_map_keeps_the_reference_assignments(cf, runs):
    want, mine = runs
    for res in mine:  # the mask the rank's dispatch used, against the reference's for its batch shard
        assert res[cf]["keep"].dtype == np.bool_
        assert np.array_equal(res[cf]["keep"], want[cf]["keep"].reshape(4, -1)[res["shard"]])
    dropped = int((~want[cf]["keep"]).sum())
    assert (dropped > 0) == (cf == 1.0), dropped  # local drops at cf 1.0 only


@pytest.mark.parametrize("name", list(DISPATCHES))
def test_pjit_dispatch_matches_the_reference(name, runs):
    want, mine = runs
    for res in mine:
        np.testing.assert_allclose(res[name]["y"], want[name]["y"], rtol=1e-5, atol=1e-5)
        assert abs(res[name]["aux"] - want[name]["aux"]) <= 1e-6


@pytest.mark.parametrize("what", ["whisper-tiny", "qwen2-vl-7b", "prefill", "decode"])
def test_once_refused_paths_run_as_unsharded(what, runs):
    """The encdec and vlm forward under ``seq="model"`` and the dense MoE
    oracle's prefill and decode step, once refused over a mesh."""
    _, mine = runs
    assert all(res["ran"][what] <= 1e-5 for res in mine), [res["ran"] for res in mine]


@pytest.mark.parametrize("what", ["plain_at_shard", "disabled_is_identity"])
def test_shard_raises_on_a_plain_tensor_and_is_the_identity_when_disabled(what, runs):
    _, mine = runs
    assert all(res[what] for res in mine)
