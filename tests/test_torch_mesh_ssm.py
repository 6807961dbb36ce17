"""The ssm and hybrid families over a mesh: the port's train step,
``prefill``, ``decode_step`` and ``ServeEngine(rules=...)`` for
mamba2-370m and zamba2-2.7b smoke on a (2, 2, 2) ``pod/data/model`` mesh
of 8 gloo ranks, against the reference's calls jitted with the in- and
out-shardings of ``repro.launch.dryrun.build_lowered``, executed on 8 fake
XLA devices.  Every rule comes from ``rules_for``.

Weights from the reference's ``init_train_state(PRNGKey(0))``
(``state_from_numpy``; its parameters are ``init(PRNGKey(0))``), prompts
drawn with numpy from a seed, float32 compute.  Cases:

1. mamba2-370m training: two steps at ``ShapeConfig("t", 32, 8,
   "train")``; ``num_heads`` 1 does not divide the tensor axis, so
   ``rules_for`` splits the activations along the sequence over
   ``model`` (SP);
2. zamba2-2.7b training, the same: 4 layers, ``hybrid_period`` 2, so the
   shared block runs twice a step;
3. mamba2-370m serving: prefill at B = 8 of a 24-token prompt under the
   prefill rules (SP), ``max_len`` 48, then 3 decode steps under the
   decode rules (heads split only);
4. zamba2-2.7b serving, the same;
5. zamba2-2.7b at global batch 1 under the decode rules (``kv_seq="data"``:
   the shared block's cache split along its sequence), from the
   reference's unsharded prefill of a 40-token prompt, ``max_len`` 64, 3
   decode steps;
6. ``ServeEngine(rules=...)``: zamba2 smoke, 8 requests of the launcher's
   mix, 4 new tokens, against the reference's engine under its mesh and
   the port's unsharded engine.

Training holds every metric of both steps and every parameter after step 2
to ``tests/test_torch_train_parity.py``'s tolerances, and the state laid
out as ``named(state_specs)``; serving holds the last-position logits and
every cache leaf (gathered) within 1e-4, the greedy tokens equal and the
cache laid out as ``named(cache_specs)``.  Zamba2's training and batch-8
serving are held to the reference's unsharded jitted calls, its sharded
ones being partitioned wrongly (``HELD_TO``); their forward metrics and
prefill to the sharded ones as well.  Each rank's SSD runs on nh / tp
of the heads (recorded from inside the region's body), and four faults
planted in the same ranks each miss the 1e-4 tolerance on case 3: the
gated norm over the rank's own channels, B and C from the rank's
contiguous columns of ``in_proj``, the conv state written into another
rank's channels, and under SP a local slice in place of the
reduce-scatter.

The reference's unsharded pieces (the state, case 5's prefill, the calls
``HELD_TO`` names) run in this process; its sharded runs in one
subprocess, which compiles them from shapes meanwhile, at the same time as
the port's one spawned group of 8 ranks (one thread each).  The rank
function imports no jax.
"""

from __future__ import annotations

import concurrent.futures
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
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import sharding as SH
from repro_torch.launch.serve import synthetic_requests
from repro_torch.models import common, lm, ssm
from repro_torch.models.common import lay_out, set_mesh, tree_map
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.runtime import ranks
from repro_torch.serve import ServeEngine
from repro_torch.train.train_step import jit_train_step, make_train_step
from test_torch_mesh_serve import _await_file, _host, _laid_out, prompts, serve_gap

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 2, 2), ("pod", "data", "model"))
TP = 2
TOL = 1e-4
STEPS = 3
ARCHS = ("mamba2-370m", "zamba2-2.7b")
TRAIN = {"mamba2_train": "mamba2-370m", "zamba2_train": "zamba2-2.7b"}
# the reference's call each case is held to.  Zamba2's shared block, its in_proj (2d, d) laid out by
# param_specs as ("data", "model"), the 2d rows split over data at the seam of concat(x, embeddings), is
# partitioned wrongly by the reference's GSPMD on 8 fake XLA devices (jax 0.9, CPU): jitted with the
# parameters' in-shardings, the block alone gives its unsharded output's parameter gradients but cotangents
# for x and the embeddings off by up to 4.4 (of values near 1), and a decode step from the unsharded
# prefill's cache gives logits off by 1.35; the same calls jitted under the mesh without in-shardings, and
# its prefill, agree with the unsharded ones.  So zamba2's training and its batch-8 serving are held to the
# reference's unsharded jitted calls, with step 1's forward metrics and the prefill held to the sharded
# ones as well.
FORWARD_METRICS = ("loss", "ce", "z_loss", "accuracy", "aux")
HELD_TO = {"mamba2_train": "sharded", "zamba2_train": "unsharded", "mamba2": "sharded", "zamba2": "unsharded",
           "zamba2_kv_seq": "sharded"}
B_TRAIN, S_TRAIN, LR = 8, 32, 3e-4
# name → (arch, batch, prompt, max_len, starts from the reference's unsharded prefill)
SERVE = {
    "mamba2": ("mamba2-370m", 8, 24, 48, False),
    "zamba2": ("zamba2-2.7b", 8, 24, 48, False),
    "zamba2_kv_seq": ("zamba2-2.7b", 1, 40, 64, True),
}
ENGINE = ("zamba2-2.7b", 8, 4, 64)  # arch, requests, new tokens, max_len
FAULT_CASE = "mamba2"
FAULTS = ("norm_own_channels", "bc_contiguous", "conv_other_channels", "sp_local_slice")
# attention under SP, which the port once refused, under a hand-made seq rule: the hybrid and encdec families
ONCE_REFUSED = {"hybrid_rules_seq": "zamba2-2.7b", "encdec": "whisper-tiny"}

REFERENCE = r"""
import os, sys, pickle, time
T0 = time.time()
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import registry
from repro.configs.base import RunConfig, ShapeConfig
from repro.data.pipeline import SyntheticLMData
from repro.launch import sharding as SH
from repro.serve.engine import Request, ServeEngine
from repro.train.loss import lm_loss
from repro.train.train_step import make_train_step
plan, inputs_path, out_path = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], sys.argv[3]
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))

def config(arch):
    return registry.get_config(arch, smoke=True).replace(dtype=jnp.float32)

def serve_call(cfg, api, kind, B, S, max_len):
    # the call jitted with dryrun.build_lowered's in- and out-shardings, compiled from shapes alone
    shape = ShapeConfig(kind, S, B, kind)
    rules = SH.rules_for(cfg, shape, mesh)
    pshape = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    rows = jax.ShapeDtypeStruct((B, S if kind == "prefill" else 1), jnp.int32)
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, 2), pshape, mesh)
    bspecs = SH.sanitize_specs(SH.batch_specs(cfg, shape, rules), {"tokens": rows}, mesh)
    cshape = jax.eval_shape(lambda: api.init_cache(cfg, B, max_len))
    cspecs = SH.sanitize_specs(SH.cache_specs(cfg, rules, cshape), cshape, mesh)
    ps, ts, cs = (SH.named(x, mesh) for x in (pspecs, bspecs["tokens"], cspecs))
    if kind == "prefill":
        f = jax.jit(lambda p, t, c: api.prefill(p, {"tokens": t}, cfg, rules, c), in_shardings=(ps, ts, cs),
                    out_shardings=(None, cs))
        return f.lower(pshape, rows, cshape).compile(), (ps, ts, cs)
    f = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, cfg, rules, c, pos), in_shardings=(ps, ts, cs, None),
                out_shardings=(None, cs))
    return f.lower(pshape, rows, cshape, jax.ShapeDtypeStruct((), jnp.int32)).compile(), (ps, ts, cs)

def train_call(name, cfg, api):
    # the sharded step, or where the case is held to the unsharded step, the sharded forward's loss metrics
    # (FORWARD_METRICS), compiled from shapes alone
    shape = ShapeConfig("t", plan["S"], plan["B"], "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=plan["lr"], warmup_steps=1, total_steps=4)
    rules = SH.rules_for(cfg, shape, mesh)
    pshape = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, 2), pshape, mesh)
    sspecs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "count": P()}, "step": P()}
    bshape = registry.input_specs(cfg, shape)
    bspecs = SH.named(SH.sanitize_specs(SH.batch_specs(cfg, shape, rules), bshape, mesh), mesh)
    sshape = {"params": pshape, "opt": {"m": pshape, "v": pshape, "count": jax.ShapeDtypeStruct((), jnp.int32)},
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    if plan["held"][name] == "sharded":
        step = jax.jit(make_train_step(cfg, run, api, rules), in_shardings=(SH.named(sspecs, mesh), bspecs),
                       out_shardings=(SH.named(sspecs, mesh), None))
        return step.lower(sshape, bshape).compile(), SH.named(sspecs, mesh)

    def forward_metrics(params, batch):
        logits, aux = api.forward(params, batch, cfg, rules)
        loss, m = lm_loss(logits, batch["labels"])
        return dict(m, loss=loss + aux, aux=aux)

    f = jax.jit(forward_metrics, in_shardings=(SH.named(pspecs, mesh), bspecs))
    return f.lower(pshape, bshape).compile(), SH.named(pspecs, mesh)

calls = {}
with compat.set_mesh(mesh):
    for name, (arch, B, S, max_len, from_unsharded) in plan["serve"].items():
        cfg = config(arch)
        api = registry.get_model_api(cfg)
        # the sharded decode only where the case is held to it; the prefill always
        kinds = ("prefill",) * (not from_unsharded) + ("decode",) * (plan["held"][name] == "sharded")
        calls[name] = {kind: serve_call(cfg, api, kind, B, S, max_len) for kind in kinds}
    for name, arch in plan["train"].items():
        cfg = config(arch)
        calls[name] = train_call(name, cfg, registry.get_model_api(cfg))
while not os.path.exists(inputs_path):
    if os.path.exists(inputs_path + ".failed") or time.time() - T0 > 600:
        sys.exit("no inputs from the test process")
    time.sleep(0.05)
inp = pickle.load(open(inputs_path, "rb"))
put = jax.device_put
out = {}
for name, arch in plan["train"].items():
    cfg = config(arch)
    f, sh = calls[name]
    data = SyntheticLMData(cfg, plan["B"], plan["S"], seed=0)
    with compat.set_mesh(mesh):
        state = put(jax.tree.map(jnp.asarray, inp["start"][arch]), sh if plan["held"][name] == "sharded" else None)
        if plan["held"][name] != "sharded":
            m = f(put(state["params"], sh), data.next_batch())
            out[name] = {"sharded": ([{k: float(v) for k, v in m.items()}], None)}
            continue
        metrics = []
        for _ in range(2):
            state, m = f(state, data.next_batch())
            metrics.append({k: float(v) for k, v in m.items()})
    out[name] = {"sharded": (metrics, jax.tree.map(np.asarray, state))}
for name, (arch, B, S, max_len, from_unsharded) in plan["serve"].items():
    cfg = config(arch)
    api = registry.get_model_api(cfg)
    params = jax.tree.map(jnp.asarray, inp["start"][arch]["params"])
    run = {"logits": [], "tokens": []}
    with compat.set_mesh(mesh):
        if from_unsharded:
            logits, cache = inp["unsharded"][name]
            cache = jax.tree.map(jnp.asarray, cache)
        else:
            f, (ps, ts, cs) = calls[name]["prefill"]
            logits, cache = f(put(params, ps), put(jnp.asarray(plan["prompts"][name]), ts),
                              put(api.init_cache(cfg, B, max_len), cs))
            run["prefill_cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
        run["logits"].append(np.asarray(logits))
        if "decode" in calls[name]:
            step, (ps, ts, cs) = calls[name]["decode"]
            for j in range(plan["steps"]):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
                run["tokens"].append(np.asarray(tok))
                logits, cache = step(put(params, ps), put(tok, ts), put(cache, cs), jnp.int32(S + j))
                run["logits"].append(np.asarray(logits))
            run["cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
    out[name] = {"sharded": run}
arch, n, new, max_len = plan["engine"]
cfg = config(arch)
api = registry.get_model_api(cfg)
reqs = [Request(i, p, max_new_tokens=new) for i, p in enumerate(plan["engine_prompts"])]
rules = SH.rules_for(cfg, ShapeConfig("serve", max_len, n, "decode"), mesh)
with compat.set_mesh(mesh):
    eng = ServeEngine(cfg, jax.tree.map(jnp.asarray, inp["start"][arch]["params"]), api, rules=rules, max_len=max_len)
    out["engine"] = eng.generate(reqs)
pickle.dump(out, open(out_path, "wb"))
"""


def config(arch: str):
    return registry.get_config(arch, smoke=True).replace(dtype=torch.float32)


# ------------------------------------------------------------ planted faults
def _plant(fault: str):
    """Patch ``fault`` into ``repro_torch.models.ssm``; returns the undo."""
    names = {"norm_own_channels": "_mean_square", "bc_contiguous": "_head_columns",
             "conv_other_channels": "_owned_channels", "sp_local_slice": "scatter_sum_dim"}
    name = names[fault]
    original = getattr(ssm, name)
    if fault == "norm_own_channels":  # the mean of squares over the rank's own channels
        def patched(gf, group, d_inner):
            return gf.square().mean(-1, keepdim=True)
    elif fault == "bc_contiguous":  # B and C from the first columns of the rank's stored shard of in_proj
        def patched(cfg, r, size):
            runs = original(cfg, r, size)
            width = (2 * cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state + cfg.ssm_heads) // size
            n = runs[2][1]
            return [runs[0], runs[1], (r * width, n), (r * width + n, n), runs[4]]
    elif fault == "conv_other_channels":  # the conv state written into the next rank's channels
        def patched(r, width):
            return original((r + 1) % TP, width)
    else:  # each rank keeps its own block of its partial sums, unsummed
        def patched(x, dim, group):
            return x.chunk(torch.distributed.get_world_size(group), dim)[torch.distributed.get_rank(group)]
    setattr(ssm, name, patched)
    return lambda: setattr(ssm, name, original)


# ------------------------------------------------------------------ the ranks
def _serve_case(name, inp, mesh, res_heads):
    arch, B, S, max_len, from_unsharded = inp["serve"][name]
    cfg = config(arch)
    params = params_from_numpy(inp["start"][arch]["params"], "cpu")
    run = {"logits": [], "tokens": [], "laid_out": []}
    if from_unsharded:
        logits, cache = inp["unsharded"][name]
        logits, cache = torch.from_numpy(logits), tree_map(lambda a: torch.from_numpy(np.asarray(a)), cache)
    else:
        cache = lm.init_cache(cfg, B, max_len, device="cpu")
        rules = SH.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
        pspecs, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, {"tokens": (B, S)}, cache)
        params = lay_out(params, pspecs, mesh)
        run["prefill_rules"] = (rules.seq, rules.heads)
        del res_heads[:]
        logits, cache = lm.prefill(params, {"tokens": torch.from_numpy(inp["prompts"][name]).long()}, cfg, rules,
                                   cache)
        run["prefill_heads"] = list(res_heads)
        run["laid_out"].append(_laid_out(cache, cspecs, mesh))
        run["prefill_cache"] = _host(cache)
    run["logits"].append(logits.numpy())
    rules = SH.rules_for(cfg, ShapeConfig("decode", S, B, "decode"), mesh)
    _, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, {"tokens": (B, 1)}, cache)
    run["rules"] = (rules.batch, rules.kv_seq, rules.seq)
    del res_heads[:]
    for j in range(inp["steps"]):
        tok = torch.argmax(logits, -1)[:, None]
        run["tokens"].append(tok.int().numpy())
        logits, cache = lm.decode_step(params, tok, cfg, rules, cache, S + j)
        run["logits"].append(logits.numpy())
        run["laid_out"].append(_laid_out(cache, cspecs, mesh))
    run["decode_heads"] = list(res_heads)
    run["cache"] = _host(cache)  # a collective: every rank gathers, rank 0 returns it
    if torch.distributed.get_rank():
        run.pop("cache"), run.pop("prefill_cache", None)
    return run


def _train_case(arch, inp, mesh, heads):
    cfg = config(arch)
    shape = ShapeConfig("t", S_TRAIN, B_TRAIN, "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=LR, warmup_steps=1, total_steps=4)
    state = state_from_numpy(inp["start"][arch], "cpu")
    rules, sspecs, bspecs = SH.train_specs(cfg, shape, run, mesh, state["params"])
    step = jit_train_step(make_train_step(cfg, run, lm, rules), mesh, sspecs, bspecs)
    data = SyntheticLMData(cfg, B_TRAIN, S_TRAIN, seed=0)
    metrics = []
    del heads[:]
    for _ in range(2):
        state, m = step(state, data.next_batch())
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "heads": list(heads), "rules": (rules.seq, rules.heads),
           "laid_out": _laid_out(state, sspecs, mesh)}
    final = tree_map(lambda t: common.whole(t).detach().cpu().clone(), state)
    out["state"] = final if torch.distributed.get_rank() == 0 else None
    return out


def _rank_ssm(mesh, plan, inputs_path):
    import dataclasses

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    # DTensor's first collective loads its modules: done while the weights are drawn
    common.distribute(torch.zeros((8, 4)), common.Spec(("pod", "data"), None), mesh).full_tensor()
    _await_file(inputs_path)
    with open(inputs_path, "rb") as f:
        inp = dict(plan, **pickle.load(f))
    heads = []  # the heads of every SSD call, from inside the region's body
    chunked, step = ssm.ssd_chunked, ssm.ssd_step

    def counted_chunked(x, *a, **k):
        heads.append(x.shape[2])
        return chunked(x, *a, **k)

    def counted_step(state, x, *a):
        heads.append(x.shape[1])
        return step(state, x, *a)

    ssm.ssd_chunked, ssm.ssd_step = counted_chunked, counted_step
    res = {}
    with set_mesh(mesh):
        for name, arch in inp["train"].items():
            res[name] = _train_case(arch, inp, mesh, heads)
        for name in inp["serve"]:
            res[name] = _serve_case(name, inp, mesh, heads)
        res["faults"] = {}
        for fault in FAULTS:
            undo = _plant(fault)
            try:
                case = dict(inp, steps=1)
                res["faults"][fault] = _serve_case(FAULT_CASE, case, mesh, heads)["logits"]
            finally:
                undo()
        arch, n, new, max_len = inp["engine"]
        cfg = config(arch)
        rules = SH.rules_for(cfg, ShapeConfig("serve", max_len, n, "decode"), mesh)
        eng = ServeEngine(cfg, params_from_numpy(inp["start"][arch]["params"], "cpu"), lm, rules=rules,
                          max_len=max_len, device="cpu")
        res["engine"] = eng.generate(synthetic_requests(n, cfg.vocab_size, new))
        res["once_refused"] = {}
        for what, arch in ONCE_REFUSED.items():
            cfg = config(arch)
            rules = SH.rules_for(cfg, ShapeConfig("p", 8, 8, "prefill"), mesh)
            res["once_refused"][what] = serve_gap(cfg, dataclasses.replace(rules, seq="model"), mesh)
    return res


# ------------------------------------------------------------ the reference
def _reference_inputs(plan: dict) -> dict:
    """The reference's start state (``init_train_state(PRNGKey(0))``) of
    each arch and case 5's unsharded prefill, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.models.common import NO_SHARD
    from repro.train.train_step import init_train_state

    start = {}
    for arch in ARCHS:
        cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32)
        run = JRunConfig(model=cfg, shape=JShapeConfig("t", S_TRAIN, B_TRAIN, "train"), learning_rate=LR,
                         warmup_steps=1, total_steps=4)
        api = jregistry.get_model_api(cfg)
        start[arch] = jax.tree.map(np.asarray, jax.jit(lambda k: init_train_state(k, cfg, run, api))(
            jax.random.PRNGKey(0)))
    unsharded = {}
    for name, (arch, B, S, max_len, from_unsharded) in SERVE.items():
        if not from_unsharded:
            continue
        cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32)
        api = jregistry.get_model_api(cfg)
        f = jax.jit(lambda p, t, c: api.prefill(p, {"tokens": t}, cfg, NO_SHARD, c))
        logits, cache = f(start[arch]["params"], jnp.asarray(plan["prompts"][name]), api.init_cache(cfg, B, max_len))
        unsharded[name] = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    return {"start": start, "unsharded": unsharded}


def _reference_unsharded(plan: dict, start: dict) -> dict:
    """The reference's unsharded jitted calls of the cases ``HELD_TO``
    holds to them: two train steps, or a prefill and the decode steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.data.pipeline import SyntheticLMData as JData
    from repro.models.common import NO_SHARD
    from repro.train.train_step import make_train_step as jmake_step

    out = {}
    for name, arch in TRAIN.items():
        if HELD_TO[name] != "unsharded":
            continue
        cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32)
        run = JRunConfig(model=cfg, shape=JShapeConfig("t", S_TRAIN, B_TRAIN, "train"), learning_rate=LR,
                         warmup_steps=1, total_steps=4)
        step = jax.jit(jmake_step(cfg, run, jregistry.get_model_api(cfg)))
        state, data, metrics = jax.tree.map(jnp.asarray, start[arch]), JData(cfg, B_TRAIN, S_TRAIN, seed=0), []
        for _ in range(2):
            state, m = step(state, data.next_batch())
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = (metrics, jax.tree.map(np.asarray, state))
    for name, (arch, B, S, max_len, _) in SERVE.items():
        if HELD_TO[name] != "unsharded":
            continue
        cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32)
        api = jregistry.get_model_api(cfg)
        prefill = jax.jit(lambda p, t, c: api.prefill(p, {"tokens": t}, cfg, NO_SHARD, c))
        decode = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, cfg, NO_SHARD, c, pos))
        params = start[arch]["params"]
        logits, cache = prefill(params, jnp.asarray(plan["prompts"][name]), api.init_cache(cfg, B, max_len))
        run = {"logits": [np.asarray(logits)], "tokens": [], "prefill_cache": [np.asarray(a) for a in jax.tree.leaves(cache)]}
        for j in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            run["tokens"].append(np.asarray(tok))
            logits, cache = decode(params, tok, cache, jnp.int32(S + j))
            run["logits"].append(np.asarray(logits))
        run["cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
        out[name] = run
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess compiles its calls from shapes and the
    ranks start while this process draws the weights; both then wait for
    ``inputs.pkl``."""
    d = tmp_path_factory.mktemp("mesh_ssm")
    vocab = {a: registry.get_config(a, smoke=True).vocab_size for a in ARCHS}
    plan = {"train": TRAIN, "serve": SERVE, "held": HELD_TO, "steps": STEPS, "engine": ENGINE, "B": B_TRAIN, "S": S_TRAIN, "lr": LR,
            "prompts": {n: prompts(vocab[c[0]], c[1], c[2], seed=i + 1) for i, (n, c) in enumerate(SERVE.items())},
            "engine_prompts": [r.prompt for r in synthetic_requests(ENGINE[1], vocab[ENGINE[0]], ENGINE[2])]}
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    inputs = str(d / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d / "plan.pkl"), inputs, str(d / "reference.pkl")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    group = pool.submit(ranks.run_ranks, _rank_ssm, *MESH, backend="gloo", device="cpu", args=(plan, inputs))
    try:
        try:
            inp = _reference_inputs(plan)
        except BaseException:
            open(inputs + ".failed", "w").close()
            raise
        with open(inputs + ".part", "wb") as f:
            pickle.dump(inp, f)
        os.replace(inputs + ".part", inputs)
        unsharded = _reference_unsharded(plan, inp["start"])  # while the ranks and the subprocess run
        mine = group.result()
        _, err = ref.communicate(timeout=600)
    finally:
        pool.shutdown()
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    with open(d / "reference.pkl", "rb") as f:
        want = pickle.load(f)
    for name, run in unsharded.items():
        want[name]["unsharded"] = run
    return dict(plan, **inp), want, mine


def _err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_steps_match_the_reference(name, runs):
    """Both steps' metrics, the parameters and first moments after step 2
    against the reference's jitted step ``HELD_TO`` names, and step 1's
    forward metrics against its sharded step."""
    from test_torch_train_parity import check_float_leaves, check_metrics, flat

    _, want, mine = runs
    want_metrics, want_state = want[name][HELD_TO[name]]
    sharded = want[name]["sharded"][0][0]
    for r in mine:
        check_metrics(r[name]["metrics"], want_metrics)
        for k in FORWARD_METRICS:  # check_metrics' tolerance
            assert abs(r[name]["metrics"][0][k] - sharded[k]) <= 1e-4 * max(1.0, abs(sharded[k])), k
    assert all(r[name]["metrics"] == mine[0][name]["metrics"] for r in mine)
    state = mine[0][name]["state"]
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    check_float_leaves(flat(state["params"]), flat(want_state["params"]))
    check_float_leaves(flat(state["opt"]["m"]), flat(want_state["opt"]["m"]))


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_state_is_laid_out_by_state_specs(name, runs):
    _, _, mine = runs
    assert all(r[name]["laid_out"] for r in mine)


def test_mamba2_trains_with_its_sequence_split_and_zamba2_without(runs):
    """``num_heads`` 1 of mamba2 does not divide the tensor axis: SP; zamba2's 4 do."""
    _, _, mine = runs
    for r in mine:
        assert r["mamba2_train"]["rules"] == ("model", None)
        assert r["zamba2_train"]["rules"] == (None, "_default")


# ------------------------------------------------------------------- serving
@pytest.mark.parametrize("name", list(SERVE))
def test_logits_match_the_reference_on_every_rank(name, runs):
    """Every forward's logits against the reference's call ``HELD_TO``
    names, the prefill's against its sharded one too."""
    _, want, mine = runs
    ref = want[name][HELD_TO[name]]["logits"]
    for res in mine:
        assert len(res[name]["logits"]) == len(ref) == STEPS + 1
        for got, r in zip(res[name]["logits"], ref):
            assert _err(got, r) <= TOL
        assert _err(res[name]["logits"][0], want[name]["sharded"]["logits"][0]) <= TOL


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_matches_the_reference(name, runs):
    _, want, mine = runs
    ref = want[name][HELD_TO[name]]
    pairs = list(zip(mine[0][name]["cache"], ref["cache"]))
    if "prefill_cache" in ref:
        pairs += list(zip(mine[0][name]["prefill_cache"], ref["prefill_cache"]))
        pairs += list(zip(mine[0][name]["prefill_cache"], want[name]["sharded"]["prefill_cache"]))
    assert len(pairs) == len(ref["cache"]) * (3 if "prefill_cache" in ref else 1)
    for got, r in pairs:
        assert _err(got, r) <= TOL


@pytest.mark.parametrize("name", list(SERVE))
def test_greedy_tokens_equal_the_reference(name, runs):
    _, want, mine = runs
    for res in mine:
        assert [t.tolist() for t in res[name]["tokens"]] == [t.tolist() for t in want[name][HELD_TO[name]]["tokens"]]


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_is_laid_out_by_cache_specs(name, runs):
    _, _, mine = runs
    for res in mine:
        assert res[name]["laid_out"] and all(res[name]["laid_out"])


def test_serving_rules(runs):
    """mamba2's prefill splits the sequence, its decode does not; zamba2
    at global batch 1 splits the shared cache along its sequence over
    ``data`` and leaves the batch whole."""
    _, _, mine = runs
    for res in mine:
        assert res["mamba2"]["prefill_rules"] == ("model", None)
        assert res["mamba2"]["rules"] == (("pod", "data"), "model", None)
        assert res["zamba2_kv_seq"]["rules"] == (None, "data", None)


def test_serve_engine_over_the_mesh_matches_the_reference_and_unsharded(runs):
    inp, want, mine = runs
    arch, n, new, max_len = ENGINE
    cfg = config(arch)
    plain = ServeEngine(cfg, params_from_numpy(inp["start"][arch]["params"], "cpu"), lm, max_len=max_len,
                        device="cpu").generate(synthetic_requests(n, cfg.vocab_size, new))
    assert sorted(plain) == list(range(n)) and all(len(t) == new for t in plain.values())
    assert {i: list(t) for i, t in want["engine"].items()} == plain
    for res in mine:
        assert res["engine"] == plain


# ----------------------------------------------------------------- the split
@pytest.mark.parametrize("name", [*TRAIN, *SERVE])
def test_each_rank_runs_its_share_of_the_heads(name, runs):
    """Every SSD call inside the region ran on nh / tp heads."""
    _, _, mine = runs
    arch = TRAIN.get(name) or SERVE[name][0]
    layers = config(arch).num_layers
    share = config(arch).ssm_heads // TP
    for res in mine:
        r = res[name]
        calls = r["heads"] if name in TRAIN else r.get("prefill_heads", []) + r["decode_heads"]
        assert len(calls) >= layers and set(calls) == {share}, calls


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_miss_the_tolerance(fault, runs):
    """Each fault, planted in the same ranks, moves case 3's prefill or
    first decode step past 1e-4."""
    _, want, mine = runs
    ref = want[FAULT_CASE][HELD_TO[FAULT_CASE]]["logits"][:2]
    for res in mine:
        got = res["faults"][fault]
        assert len(got) == 2
        assert max(_err(g, r) for g, r in zip(got, ref)) > TOL


@pytest.mark.parametrize("what", list(ONCE_REFUSED))
def test_attention_under_rules_seq_serves_as_unsharded(what, runs):
    """Zamba2's shared attention block and whisper's attention under a
    hand-made ``seq="model"`` rule, which the port once refused: a
    prefill and a decode step give the unsharded calls' logits."""
    _, _, mine = runs
    for res in mine:
        assert max(res["once_refused"][what].values()) <= TOL, res["once_refused"][what]
