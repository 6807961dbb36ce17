"""The encdec and vlm families over a mesh: the port's train step,
``prefill``, ``decode_step`` and ``ServeEngine(rules=...)`` for
whisper-tiny and qwen2-vl-7b smoke on a (2, 2, 2) ``pod/data/model`` mesh
of 8 gloo ranks, against the reference's calls jitted with the in- and
out-shardings of ``repro.launch.dryrun.build_lowered``, executed on 8 fake
XLA devices.  Every rule comes from ``rules_for``.

Weights from the reference's ``init_train_state(PRNGKey(0))``
(``state_from_numpy``; its parameters are ``init(PRNGKey(0))``), every
input drawn with numpy from a seed, float32 compute.  qwen2-vl-7b's smoke
config runs at ``rope_theta`` 100 (``CONFIG_CHANGES``; 1e6 as published):
with its 16-wide heads and ids below 32, theta 1e6 leaves the h and w
bands (frequencies 1e-3 to 5.6e-6) all but unrotated, so a fault in the h
or w ids could not show, and the key bias's entries in those bands have
an analytically zero gradient (the softmax cancels a bias that every key
shares alike), whose AdamW update is rounding noise in both packages: the
reference moves one past the parameter tolerance against itself between
two XLA thread settings.  Cases:

1. whisper-tiny training: two steps at ``ShapeConfig("t", 32, 8,
   "train")`` with 16 encoder frames a row;
2. qwen2-vl-7b training, the same, with 8 vision tokens a row: each row's
   vision embeddings and (t, h, w) grid its own (its image at temporal id
   the row's index, on a patch grid 2 to 4 wide), so a rank that read
   another rank's rows would show;
3. whisper-tiny serving: prefill at B = 8 of a 24-token prompt against
   random encoder frames, ``max_len`` 48, then 3 greedy decode steps;
4. qwen2-vl-7b serving, the same, the prefill with vision inputs as in 2;
5. whisper-tiny at global batch 1 under the decode rules (``kv_seq="data"``:
   the self and the cross caches both split along their sequence), from
   the reference's unsharded prefill of a 40-token prompt, ``max_len`` 64,
   3 decode steps;
6. ``ServeEngine(rules=...)``: both archs, 8 requests of the launcher's
   mix, 4 new tokens, against the reference's engine under its mesh and
   the port's unsharded engine.

Training holds every metric of both steps and every parameter after step 2
to ``tests/test_torch_train_parity.py``'s tolerances, and the state laid
out as ``named(state_specs)``; serving holds the last-position logits and
every cache leaf (gathered) within 1e-4, the greedy tokens equal and the
cache laid out as ``named(cache_specs)``, the ``cross`` entry included.
Each rank's encoder self-attention and cross-attention run on H / tp
heads (recorded from inside the region's body), and four faults planted in
the same ranks each miss the 1e-4 tolerance: cross K/V from another rank's
heads' columns of ``wk`` / ``wv`` (case 3), the rank's own cross slice
attended without ``lse_combine`` (case 5), ``positions_thw`` and the
vision splice each taken from the global first rows, not the rank's own
(case 4).

The reference's unsharded pieces (the state, case 5's prefill) run in this
process; its sharded runs in one subprocess, which compiles them from
shapes meanwhile, at the same time as the port's one spawned group of 8
ranks (one thread each).  The rank function imports no jax.
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
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.serve import synthetic_requests
from repro_torch.models import common, encdec, lm
from repro_torch.models.common import Spec, lay_out, set_mesh, tree_map
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.runtime import ranks
from repro_torch.serve import ServeEngine
from repro_torch.train.train_step import jit_train_step, make_train_step
from test_torch_mesh_serve import _await_file, _host, _laid_out

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 2, 2), ("pod", "data", "model"))
TP = 2
TOL = 1e-4
STEPS = 3
ARCHS = ("whisper-tiny", "qwen2-vl-7b")
TRAIN = {"whisper_train": "whisper-tiny", "qwen2vl_train": "qwen2-vl-7b"}
B_TRAIN, S_TRAIN, LR = 8, 32, 3e-4
# name → (arch, batch, prompt, max_len, starts from the reference's unsharded prefill)
SERVE = {
    "whisper": ("whisper-tiny", 8, 24, 48, False),
    "qwen2vl": ("qwen2-vl-7b", 8, 24, 48, False),
    "whisper_kv_seq": ("whisper-tiny", 1, 40, 64, True),
}
ENGINE = (8, 4, 64)  # requests, new tokens, max_len: for each arch
CONFIG_CHANGES = {"qwen2-vl-7b": {"rope_theta": 100.0}}  # every M-RoPE band rotates over ids below 32
# fault → the serving case it is planted in (prefill and one decode step)
FAULTS = {"cross_kv_other_heads": "whisper", "kv_seq_without_combine": "whisper_kv_seq",
          "thw_first_rows": "qwen2vl", "splice_first_rows": "qwen2vl"}

REFERENCE = r"""
import os, sys, pickle, time
T0 = time.time()
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import registry
from repro.configs.base import RunConfig, ShapeConfig
from repro.launch import sharding as SH
from repro.serve.engine import Request, ServeEngine
from repro.train.train_step import make_train_step
plan, inputs_path, out_path = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], sys.argv[3]
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))

def config(arch):
    return registry.get_config(arch, smoke=True).replace(dtype=jnp.float32, **plan["config_changes"].get(arch, {}))

def shapes(tree):
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in tree.items()}

def serve_call(cfg, api, kind, B, S, max_len, batch):
    # the call jitted with dryrun.build_lowered's in- and out-shardings, compiled from shapes alone
    shape = ShapeConfig(kind, S, B, kind)
    rules = SH.rules_for(cfg, shape, mesh)
    pshape = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, 2), pshape, mesh)
    bshape = shapes(batch if kind == "prefill" else {"tokens": np.zeros((B, 1), np.int32)})
    bspecs = SH.sanitize_specs({k: v for k, v in SH.batch_specs(cfg, shape, rules).items() if k in bshape}, bshape,
                               mesh)
    cshape = jax.eval_shape(lambda: api.init_cache(cfg, B, max_len))
    cspecs = SH.sanitize_specs(SH.cache_specs(cfg, rules, cshape), cshape, mesh)
    ps, bs, cs = (SH.named(x, mesh) for x in (pspecs, bspecs, cspecs))
    if kind == "prefill":
        f = jax.jit(lambda p, b, c: api.prefill(p, b, cfg, rules, c), in_shardings=(ps, bs, cs),
                    out_shardings=(None, cs))
        return f.lower(pshape, bshape, cshape).compile(), (ps, bs, cs)
    f = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, cfg, rules, c, pos),
                in_shardings=(ps, bs["tokens"], cs, None), out_shardings=(None, cs))
    return f.lower(pshape, bshape["tokens"], cshape, jax.ShapeDtypeStruct((), jnp.int32)).compile(), (ps, bs, cs)

def train_call(cfg, api, batch):
    shape = ShapeConfig("t", plan["S"], plan["B"], "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=plan["lr"], warmup_steps=1, total_steps=4)
    rules = SH.rules_for(cfg, shape, mesh)
    pshape = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, 2), pshape, mesh)
    sspecs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "count": P()}, "step": P()}
    bshape = shapes(batch)
    bspecs = SH.named(SH.sanitize_specs(SH.batch_specs(cfg, shape, rules), bshape, mesh), mesh)
    sshape = {"params": pshape, "opt": {"m": pshape, "v": pshape, "count": jax.ShapeDtypeStruct((), jnp.int32)},
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    step = jax.jit(make_train_step(cfg, run, api, rules), in_shardings=(SH.named(sspecs, mesh), bspecs),
                   out_shardings=(SH.named(sspecs, mesh), None))
    return step.lower(sshape, bshape).compile(), SH.named(sspecs, mesh)

calls = {}
with compat.set_mesh(mesh):
    for name, (arch, B, S, max_len, from_unsharded) in plan["serve"].items():
        cfg = config(arch)
        api = registry.get_model_api(cfg)
        kinds = ("decode",) if from_unsharded else ("prefill", "decode")
        calls[name] = {k: serve_call(cfg, api, k, B, S, max_len, plan["serve_batches"][name]) for k in kinds}
    for name, arch in plan["train"].items():
        cfg = config(arch)
        calls[name] = train_call(cfg, registry.get_model_api(cfg), plan["train_batches"][name][0])
while not os.path.exists(inputs_path):
    if os.path.exists(inputs_path + ".failed") or time.time() - T0 > 600:
        sys.exit("no inputs from the test process")
    time.sleep(0.05)
inp = pickle.load(open(inputs_path, "rb"))
put = jax.device_put
out = {}
for name, arch in plan["train"].items():
    f, sh = calls[name]
    with compat.set_mesh(mesh):
        state = put(jax.tree.map(jnp.asarray, inp["start"][arch]), sh)
        metrics = []
        for batch in plan["train_batches"][name]:
            state, m = f(state, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    out[name] = (metrics, jax.tree.map(np.asarray, state))
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
            f, (ps, bs, cs) = calls[name]["prefill"]
            batch = {k: jnp.asarray(v) for k, v in plan["serve_batches"][name].items()}
            logits, cache = f(put(params, ps), put(batch, bs), put(api.init_cache(cfg, B, max_len), cs))
            run["prefill_cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
        run["logits"].append(np.asarray(logits))
        step, (ps, bs, cs) = calls[name]["decode"]
        for j in range(plan["steps"]):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            run["tokens"].append(np.asarray(tok))
            logits, cache = step(put(params, ps), put(tok, bs["tokens"]), put(cache, cs), jnp.int32(S + j))
            run["logits"].append(np.asarray(logits))
        run["cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
    out[name] = run
n, new, max_len = plan["engine"]
out["engine"] = {}
for arch in plan["archs"]:
    cfg = config(arch)
    api = registry.get_model_api(cfg)
    reqs = [Request(i, p, max_new_tokens=new) for i, p in enumerate(plan["engine_prompts"][arch])]
    rules = SH.rules_for(cfg, ShapeConfig("serve", max_len, n, "decode"), mesh)
    with compat.set_mesh(mesh):
        eng = ServeEngine(cfg, jax.tree.map(jnp.asarray, inp["start"][arch]["params"]), api, rules=rules,
                          max_len=max_len)
        out["engine"][arch] = eng.generate(reqs)
pickle.dump(out, open(out_path, "wb"))
"""


def config(arch: str):
    return registry.get_config(arch, smoke=True).replace(dtype=torch.float32, **CONFIG_CHANGES.get(arch, {}))


def _rows(cfg, B: int, S: int, seed: int, labels: bool) -> dict:
    """One batch as numpy, drawn from ``seed``: tokens (and labels), then
    the family's inputs.  whisper: random encoder frames.  qwen2-vl: random
    vision embeddings over the first ``vision_tokens`` positions, row r's
    image at temporal id r on a patch grid ``2 + r % 3`` wide, then text
    positions equal on all three axes (which decode's broadcast position
    continues)."""
    g = np.random.default_rng(seed)
    out = {"tokens": g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if labels:
        out["labels"] = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "encdec":
        out["enc_frames"] = g.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        V = cfg.vision_tokens
        out["vision_embeds"] = g.normal(size=(B, V, cfg.d_model)).astype(np.float32)
        thw = np.broadcast_to(np.arange(S), (3, B, S)).copy()
        idx = np.arange(V)
        for r in range(B):
            width = 2 + r % 3
            thw[0, r, :V], thw[1, r, :V], thw[2, r, :V] = r, idx // width, idx % width
        out["positions_thw"] = thw.astype(np.int32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


# ------------------------------------------------------------ planted faults
def _plant(fault: str, mesh):
    """Patch ``fault`` into the model modules; returns the undo."""
    if fault == "kv_seq_without_combine":  # each rank's own slice of the frames, its softmax not joined
        original = encdec.lse_combine
        encdec.lse_combine = lambda out, lse, mesh, axes: out
        return lambda: setattr(encdec, "lse_combine", original)
    if fault == "cross_kv_other_heads":  # wk and wv rolled by one rank's heads: each rank computes the next's
        original = encdec.tp_region

        def rolled(body, x, weights, rules, mesh, extra=(), inputs=(), **kw):
            if body.__qualname__.startswith("_cross_on_mesh"):
                weights = list(weights)
                for i in (1, 2):
                    w = weights[i]
                    whole = torch.roll(common.whole(w), -w.shape[1] // TP, 1)
                    weights[i] = common.distribute(whole, common.axes_of(w, mesh), mesh)
            return original(body, x, weights, rules, mesh, extra, inputs, **kw)

        encdec.tp_region = rolled
        return lambda: setattr(encdec, "tp_region", original)
    if fault == "thw_first_rows":  # every rank rotates by the (t, h, w) ids of the global first rows
        original = lm.tp_region

        def first_rows(body, x, weights, rules, mesh, extra=(), inputs=(), **kw):
            if inputs:
                (thw, _), rows = inputs[0], common.local(x).shape[0]
                inputs = ((common.whole(thw)[:, :rows].contiguous(), Spec()),)
            return original(body, x, weights, rules, mesh, extra, inputs, **kw)

        lm.tp_region = first_rows
        return lambda: setattr(lm, "tp_region", original)
    original = lm.region  # splice_first_rows: every rank splices the global first rows' vision embeddings

    def first_splice(fn, args, in_specs, out_specs, **kw):
        if fn is lm._splice:
            x, ve = args
            args, in_specs = (x, common.whole(ve)[: common.local(x).shape[0]].contiguous()), (in_specs[0], None)
        return original(fn, args, in_specs, out_specs, **kw)

    lm.region = first_splice
    return lambda: setattr(lm, "region", original)


# ------------------------------------------------------------------ the ranks
def _serve_case(name, inp, mesh):
    arch, B, S, max_len, from_unsharded = inp["serve"][name]
    cfg = config(arch)
    api = registry.get_model_api(cfg)
    params = params_from_numpy(inp["start"][arch]["params"], "cpu")
    run = {"logits": [], "tokens": [], "laid_out": []}
    if from_unsharded:
        logits, cache = inp["unsharded"][name]
        logits, cache = torch.from_numpy(logits), tree_map(lambda a: torch.from_numpy(np.asarray(a)), cache)
    else:
        cache = api.init_cache(cfg, B, max_len, device="cpu")
        batch = _torch_batch(inp["serve_batches"][name])
        rules = SH.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
        pspecs, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, batch, cache)
        params = lay_out(params, pspecs, mesh)
        logits, cache = api.prefill(params, batch, cfg, rules, cache)
        run["laid_out"].append(_laid_out(cache, cspecs, mesh))
        run["prefill_cache"] = _host(dict(sorted(cache.items())))  # the reference's leaf order
    run["logits"].append(logits.numpy())
    rules = SH.rules_for(cfg, ShapeConfig("decode", S, B, "decode"), mesh)
    _, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, {"tokens": (B, 1)}, cache)
    run["rules"] = (rules.batch, rules.kv_seq)
    for j in range(inp["steps"]):
        tok = torch.argmax(logits, -1)[:, None]
        run["tokens"].append(tok.int().numpy())
        logits, cache = api.decode_step(params, tok, cfg, rules, cache, S + j)
        run["logits"].append(logits.numpy())
        run["laid_out"].append(_laid_out(cache, cspecs, mesh))
    run["local_cross"] = [tuple(common.local(t).shape) for t in common.tree_leaves(cache.get("cross", ()))]
    run["cache"] = _host(dict(sorted(cache.items())))  # a collective: every rank gathers, rank 0 returns it
    if torch.distributed.get_rank():
        run.pop("cache"), run.pop("prefill_cache", None)
    return run


def _train_case(name, arch, inp, mesh):
    cfg = config(arch)
    shape = ShapeConfig("t", S_TRAIN, B_TRAIN, "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=LR, warmup_steps=1, total_steps=4)
    state = state_from_numpy(inp["start"][arch], "cpu")
    rules, sspecs, bspecs = SH.train_specs(cfg, shape, run, mesh, state["params"])
    step = jit_train_step(make_train_step(cfg, run, registry.get_model_api(cfg), rules), mesh, sspecs, bspecs)
    metrics = []
    for batch in inp["train_batches"][name]:
        state, m = step(state, _torch_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "laid_out": _laid_out(state, sspecs, mesh), "bspecs": bspecs}
    final = tree_map(lambda t: common.whole(t).detach().cpu().clone(), state)
    out["state"] = final if torch.distributed.get_rank() == 0 else None
    return out


def _recording(heads: list):
    """Wrap the attention calls of the two modules to append (kind, the
    heads of q) from inside each region's body: ``enc`` the encoder's
    self-attention (non-causal, no cache), ``cross`` the cross-attention;
    returns the undo."""
    originals = (lm.attention, encdec.attention, encdec.attention_with_lse)

    def self_attn(q, k, v, **kw):
        if not kw.get("causal", True) and kw.get("kv_len") is None and kw.get("k_positions") is None:
            heads.append(("enc", q.shape[2]))
        return originals[0](q, k, v, **kw)

    def cross(fn):
        def call(q, k, v, **kw):
            heads.append(("cross", q.shape[2]))
            return fn(q, k, v, **kw)
        return call

    lm.attention, encdec.attention, encdec.attention_with_lse = self_attn, cross(originals[1]), cross(originals[2])

    def undo():
        lm.attention, encdec.attention, encdec.attention_with_lse = originals

    return undo


def _rank_encdec(mesh, plan, inputs_path):
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    # DTensor's first collective loads its modules: done while the weights are drawn
    common.distribute(torch.zeros((8, 4)), common.Spec(("pod", "data"), None), mesh).full_tensor()
    _await_file(inputs_path)
    with open(inputs_path, "rb") as f:
        inp = dict(plan, **pickle.load(f))
    heads: list = []
    undo = _recording(heads)
    res = {}
    try:
        with set_mesh(mesh):
            for name, arch in inp["train"].items():
                del heads[:]
                res[name] = _train_case(name, arch, inp, mesh)
                res[name]["heads"] = list(heads)
            for name in inp["serve"]:
                del heads[:]
                res[name] = _serve_case(name, inp, mesh)
                res[name]["heads"] = list(heads)
    finally:
        undo()
    res["faults"] = {}
    with set_mesh(mesh):
        for fault, case in FAULTS.items():
            undo = _plant(fault, mesh)
            try:
                res["faults"][fault] = _serve_case(case, dict(inp, steps=1), mesh)["logits"]
            finally:
                undo()
        n, new, max_len = inp["engine"]
        res["engine"] = {}
        for arch in inp["archs"]:
            cfg = config(arch)
            rules = SH.rules_for(cfg, ShapeConfig("serve", max_len, n, "decode"), mesh)
            eng = ServeEngine(cfg, params_from_numpy(inp["start"][arch]["params"], "cpu"),
                              registry.get_model_api(cfg), rules=rules, max_len=max_len, device="cpu")
            res["engine"][arch] = eng.generate(synthetic_requests(n, cfg.vocab_size, new))
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
        cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32, **CONFIG_CHANGES.get(arch, {}))
        run = JRunConfig(model=cfg, shape=JShapeConfig("t", S_TRAIN, B_TRAIN, "train"), learning_rate=LR,
                         warmup_steps=1, total_steps=4)
        api = jregistry.get_model_api(cfg)
        start[arch] = jax.tree.map(np.asarray, jax.jit(lambda k: init_train_state(k, cfg, run, api))(
            jax.random.PRNGKey(0)))
    unsharded = {}
    for name, (arch, B, S, max_len, from_unsharded) in SERVE.items():
        if not from_unsharded:
            continue
        cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32, **CONFIG_CHANGES.get(arch, {}))
        api = jregistry.get_model_api(cfg)
        f = jax.jit(lambda p, b, c: api.prefill(p, b, cfg, NO_SHARD, c))
        batch = {k: jnp.asarray(v) for k, v in plan["serve_batches"][name].items()}
        logits, cache = f(start[arch]["params"], batch, api.init_cache(cfg, B, max_len))
        unsharded[name] = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    return {"start": start, "unsharded": unsharded}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess compiles its calls from shapes and the
    ranks start while this process draws the weights; both then wait for
    ``inputs.pkl``."""
    d = tmp_path_factory.mktemp("mesh_encdec")
    n, new, _ = ENGINE
    plan = {"train": TRAIN, "serve": SERVE, "steps": STEPS, "engine": ENGINE, "archs": ARCHS, "B": B_TRAIN,
            "S": S_TRAIN, "lr": LR, "config_changes": CONFIG_CHANGES,
            "train_batches": {name: [_rows(config(a), B_TRAIN, S_TRAIN, 10 * i + j, labels=True) for j in range(2)]
                              for i, (name, a) in enumerate(TRAIN.items())},
            "serve_batches": {name: _rows(config(c[0]), c[1], c[2], 100 + i, labels=False)
                              for i, (name, c) in enumerate(SERVE.items())},
            "engine_prompts": {a: [r.prompt for r in synthetic_requests(n, config(a).vocab_size, new)] for a in ARCHS}}
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    inputs = str(d / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d / "plan.pkl"), inputs, str(d / "reference.pkl")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    group = pool.submit(ranks.run_ranks, _rank_encdec, *MESH, backend="gloo", device="cpu", args=(plan, inputs))
    try:
        try:
            inp = _reference_inputs(plan)
        except BaseException:
            open(inputs + ".failed", "w").close()
            raise
        with open(inputs + ".part", "wb") as f:
            pickle.dump(inp, f)
        os.replace(inputs + ".part", inputs)
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
    return dict(plan, **inp), want, mine


def _err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_steps_match_the_reference(name, runs):
    """Both steps' metrics, the parameters and first moments after step 2
    against the reference's sharded jitted step."""
    from test_torch_train_parity import check_float_leaves, check_metrics, flat

    _, want, mine = runs
    want_metrics, want_state = want[name]
    for r in mine:
        check_metrics(r[name]["metrics"], want_metrics)
    assert all(r[name]["metrics"] == mine[0][name]["metrics"] for r in mine)
    state = mine[0][name]["state"]
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    check_float_leaves(flat(state["params"]), flat(want_state["params"]))
    check_float_leaves(flat(state["opt"]["m"]), flat(want_state["opt"]["m"]))


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_state_is_laid_out_by_state_specs(name, runs):
    _, _, mine = runs
    assert all(r[name]["laid_out"] for r in mine)


# ------------------------------------------------------------------- serving
@pytest.mark.parametrize("name", list(SERVE))
def test_logits_match_the_reference_on_every_rank(name, runs):
    _, want, mine = runs
    for res in mine:
        assert len(res[name]["logits"]) == len(want[name]["logits"]) == STEPS + 1
        for got, ref in zip(res[name]["logits"], want[name]["logits"]):
            assert _err(got, ref) <= TOL


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_matches_the_reference(name, runs):
    """Every leaf, the ``cross`` entry's included, after the prefill and
    after the last decode step."""
    _, want, mine = runs
    pairs = list(zip(mine[0][name]["cache"], want[name]["cache"]))
    if "prefill_cache" in want[name]:
        pairs += list(zip(mine[0][name]["prefill_cache"], want[name]["prefill_cache"]))
    assert len(pairs) == len(want[name]["cache"]) * (2 if "prefill_cache" in want[name] else 1)
    for got, ref in pairs:
        assert _err(got, ref) <= TOL


@pytest.mark.parametrize("name", list(SERVE))
def test_greedy_tokens_equal_the_reference(name, runs):
    _, want, mine = runs
    for res in mine:
        assert [t.tolist() for t in res[name]["tokens"]] == [t.tolist() for t in want[name]["tokens"]]


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_is_laid_out_by_cache_specs(name, runs):
    _, _, mine = runs
    for res in mine:
        assert res[name]["laid_out"] and all(res[name]["laid_out"])


def test_kv_seq_splits_both_caches_along_their_sequence(runs):
    """Global batch 1: the batch whole, the self cache (64 positions) and
    the cross cache (16 frames) each split in half over ``data``, the
    heads over ``model``, through every step."""
    _, _, mine = runs
    cfg = config("whisper-tiny")
    L, F, KV, hd = cfg.num_layers, cfg.encoder_seq_len, cfg.num_kv_heads, cfg.resolved_head_dim
    for res in mine:
        assert res["whisper_kv_seq"]["rules"] == (None, "data")
        assert res["whisper_kv_seq"]["local_cross"] == [(L, 1, F // 2, KV // TP, hd)] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_over_the_mesh_matches_the_reference_and_unsharded(arch, runs):
    inp, want, mine = runs
    n, new, max_len = ENGINE
    cfg = config(arch)
    plain = ServeEngine(cfg, params_from_numpy(inp["start"][arch]["params"], "cpu"), registry.get_model_api(cfg),
                        max_len=max_len, device="cpu").generate(synthetic_requests(n, cfg.vocab_size, new))
    assert sorted(plain) == list(range(n)) and all(len(t) == new for t in plain.values())
    assert {i: list(t) for i, t in want["engine"][arch].items()} == plain
    for res in mine:
        assert res["engine"][arch] == plain


# ----------------------------------------------------------------- the split
@pytest.mark.parametrize("name", ["whisper_train", "whisper", "whisper_kv_seq"])
def test_each_rank_runs_its_share_of_the_heads(name, runs):
    """Every encoder self-attention and cross-attention call inside its
    region ran on H / tp heads (case 5 starts from a prefill, so it has
    decode's cross-attention alone)."""
    _, _, mine = runs
    cfg = config("whisper-tiny")
    share = cfg.num_heads // TP
    for res in mine:
        calls = res[name]["heads"]
        enc = [h for kind, h in calls if kind == "enc"]
        cross = [h for kind, h in calls if kind == "cross"]
        assert len(cross) >= cfg.num_layers and set(cross) == {share}, calls
        if name != "whisper_kv_seq":
            assert len(enc) >= cfg.encoder_layers and set(enc) == {share}, calls


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_miss_the_tolerance(fault, runs):
    """Each fault, planted in the same ranks, moves its case's prefill or
    first decode step past 1e-4."""
    _, want, mine = runs
    ref = want[FAULTS[fault]]["logits"][:2]
    for res in mine:
        got = res["faults"][fault]
        assert len(got) == 2
        assert max(_err(g, r) for g, r in zip(got, ref)) > TOL


# ------------------------------------------------------- the layout functions
LAYOUT_CASES = {  # name → (arch, kind, global batch)
    "whisper_train": ("whisper-tiny", "train", 8),
    "qwen2vl_train": ("qwen2-vl-7b", "train", 8),
    "qwen2vl_train_rows_indivisible": ("qwen2-vl-7b", "train", 2),
    "whisper_prefill": ("whisper-tiny", "prefill", 8),
    "qwen2vl_prefill": ("qwen2-vl-7b", "prefill", 8),
    "qwen2vl_decode": ("qwen2-vl-7b", "decode", 8),
}


@pytest.mark.parametrize("name", list(LAYOUT_CASES))
def test_layout_functions_give_every_batch_leaf_its_batch_spec(name):
    """``train_specs`` and ``serve_layout`` on a (2, 2, 2) mesh spec: every
    leaf of the family's batch gets ``batch_specs``' spec, sanitized
    against its shape (rows that the 4 batch shards do not divide stay
    whole); a decode's batch is the tokens alone."""
    arch, kind, B = LAYOUT_CASES[name]
    cfg = registry.get_config(arch, smoke=True)
    mesh = MeshSpec(*MESH)
    shape = ShapeConfig(kind, 16, B, kind)
    rules = SH.rules_for(cfg, shape, mesh)
    rows = ("pod", "data") if B % 4 == 0 else None
    want = {"tokens": Spec(rows, None)}
    if kind == "train":
        want["labels"] = Spec(rows, None)
    if cfg.family == "encdec":
        want["enc_frames"] = Spec(rows, None, None)
    if cfg.family == "vlm" and kind != "decode":
        want |= {"vision_embeds": Spec(rows, None, None), "positions_thw": Spec(None, rows, None)}
    inputs = registry.input_specs(cfg, shape)
    with common.shapes_only():
        params = registry.get_model_api(cfg).init(cfg, torch.Generator())
    if kind == "train":
        _, _, got = SH.train_specs(cfg, shape, RunConfig(model=cfg, shape=shape), mesh, params)
    else:
        cache = tree_map(lambda t: tuple(t.shape), registry.get_model_api(cfg).init_cache(cfg, B, 32, device="meta"))
        _, got, _ = SH.serve_layout(cfg, rules, mesh, params, inputs, cache)
    assert set(inputs) == set(want) and got == want
