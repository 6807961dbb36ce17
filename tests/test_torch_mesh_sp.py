"""Attention under sequence parallelism, ``heads=None`` layouts and the
dense MoE oracle over a mesh: the port's train step, ``prefill``,
``decode_step`` and ``ServeEngine(rules=...)`` on 8 gloo ranks against the
reference's calls jitted with the in- and out-shardings of
``repro.launch.dryrun.build_lowered``, executed on 8 fake XLA devices.
Every rule comes from ``rules_for``, on three meshes built over the same 8
ranks: (1, 2, 4) ``pod/data/model``, where the smoke configs' 2 KV heads
give ``heads=None`` and, where the sequence divides 4, ``seq="model"``;
(1, 1, 8), where their 4 heads do; and (2, 2, 2), where nothing does.

Weights from the reference's ``init_train_state(PRNGKey(0))``
(``state_from_numpy``), every input drawn with numpy from a seed, float32
compute; qwen2-vl-7b's smoke config at ``rope_theta`` 100, as in
``tests/test_torch_mesh_encdec.py``.  Cases:

1. gemma3-4b on (1, 2, 4) at ``ShapeConfig("t", 30, 8, "train")``:
   ``heads=None, seq=None`` (30 does not divide 4), the layout whose
   attention region once saw 1 query head against 2 KV heads;
2. gemma3-4b on (1, 2, 4) under SP at S = 64: its 32-wide windows cross
   the 16-token chunks;
3. mixtral-8x22b under SP, ``dispatch="shard_map"`` (K1 on each rank's
   tokens, the sequence gathered at the dispatch's boundary);
4. mixtral-8x22b with ``dispatch="dense"``: on (2, 2, 2) without SP (each
   rank a ``d_ff`` slice of every expert) and on (1, 2, 4) under SP;
5. qwen2-vl-7b under SP: training, and a prefill of 16 tokens whose 8
   vision tokens span two ranks' 4-token chunks, then 3 decode steps;
6. whisper-tiny on (1, 1, 8) under SP, its encoder's 16 frames split too:
   training, a prefill and 3 decode steps (the caches under ``kv_seq``);
7. deepseek-v2-lite on (1, 1, 8) (MLA and the ``shard_map`` dispatch):
   training;
8. zamba2-2.7b on (1, 1, 8) (the Mamba2 blocks and the shared attention
   block): training;
9. ``ServeEngine(rules=...)`` for gemma3-4b on (1, 2, 4) under the
   prefill rules (SP, ``kv_seq``), 8 requests of the launcher's mix, the
   longest prompt extended to 48 tokens so the padded batch splits in 4,
   against the reference's engine under its mesh and the port's unsharded
   engine.

Every training case takes two steps; it holds both steps' metrics and the
parameters and first moments after step 2 to
``tests/test_torch_train_parity.py``'s tolerances, and the state laid out
as ``named(state_specs)``.  Serving holds the last-position logits and
every cache leaf (gathered) within 1e-4, the greedy tokens equal and
every cache leaf laid out as ``named(cache_specs)``.  Each rank's
attention, recorded from inside the region's body, runs S / tp queries
against S keys under SP (all heads, whole sequence under case 1's
layout), and four faults planted in the same ranks each move case 5's
prefill or first decode step past 1e-4: ``q_offset`` left at 0, K/V not
gathered, the M-RoPE positions of the first chunk on every rank, and the
vision splice written from position 0 on every rank.

The reference's start states are made in this process; its sharded runs
in one subprocess, which compiles them from shapes meanwhile, at the same
time as the port's one spawned group of 8 ranks (one thread each).  The
rank function imports no jax.
"""

from __future__ import annotations

import concurrent.futures
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
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.serve import synthetic_requests
from repro_torch.models import common, encdec, lm, mla
from repro_torch.models.common import Spec, lay_out, set_mesh, tree_map
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.runtime import ranks
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import Request
from repro_torch.train.train_step import jit_train_step, make_train_step
from test_torch_mesh_encdec import _rows, _torch_batch
from test_torch_mesh_serve import _await_file, _host, _laid_out

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("pod", "data", "model")
MESHES = {"1x2x4": (1, 2, 4), "1x1x8": (1, 1, 8), "2x2x2": (2, 2, 2)}
TOL = 1e-4
STEPS = 3
LR = 3e-4
# name → (arch, MoE dispatch, mesh, batch, sequence)
TRAIN = {
    "gemma3_heads_none": ("gemma3-4b", None, "1x2x4", 8, 30),
    "gemma3_sp": ("gemma3-4b", None, "1x2x4", 8, 64),
    "mixtral_sp_shard_map": ("mixtral-8x22b", "shard_map", "1x2x4", 8, 64),
    "mixtral_dense": ("mixtral-8x22b", "dense", "2x2x2", 8, 64),
    "mixtral_dense_sp": ("mixtral-8x22b", "dense", "1x2x4", 8, 64),
    "qwen2vl_sp": ("qwen2-vl-7b", None, "1x2x4", 8, 64),
    "whisper_sp": ("whisper-tiny", None, "1x1x8", 8, 32),
    "deepseek_sp": ("deepseek-v2-lite-16b", "shard_map", "1x1x8", 8, 32),
    "zamba2_sp": ("zamba2-2.7b", None, "1x1x8", 8, 32),
}
# the rules each training case must get from rules_for: (heads, seq)
TRAIN_RULES = {"gemma3_heads_none": (None, None), "mixtral_dense": ("_default", None)}
# name → (arch, mesh, batch, prompt, max_len)
SERVE = {
    "qwen2vl": ("qwen2-vl-7b", "1x2x4", 8, 16, 32),
    "whisper": ("whisper-tiny", "1x1x8", 8, 16, 32),
}
ENGINE = ("gemma3-4b", "1x2x4", 8, 4, 64, 48)  # arch, mesh, requests, new tokens, max_len, longest prompt
CONFIG_CHANGES = {"qwen2-vl-7b": {"rope_theta": 100.0}}  # every M-RoPE band rotates over ids below 32
FAULTS = ("q_offset_zero", "kv_not_gathered", "positions_not_offset", "splice_on_every_rank")
FAULT_CASE = "qwen2vl"
ARCHS = sorted({a for a, *_ in TRAIN.values()} | {a for a, *_ in SERVE.values()} | {ENGINE[0]})

REFERENCE = r"""
import os, sys, pickle, time, dataclasses
T0 = time.time()
# without the concurrency-optimized scheduler: with it, a loaded host deadlocked whisper-tiny's step on (1, 1, 8)
# (each device ran two collectives at once, the pool's 8 threads all blocked in rendezvous, 2 devices never ran)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false "
                           "--xla_cpu_enable_concurrency_optimized_scheduler=false")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import registry
from repro.configs.base import RunConfig, ShapeConfig
from repro.launch import sharding as SH
from repro.serve.engine import Request, ServeEngine
from repro.train.train_step import make_train_step
plan, inputs_path, out_path = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], sys.argv[3]
meshes = {k: compat.make_mesh(v, ("pod", "data", "model")) for k, v in plan["meshes"].items()}

def config(arch, dispatch=None):
    cfg = registry.get_config(arch, smoke=True).replace(dtype=jnp.float32, **plan["config_changes"].get(arch, {}))
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch)) if dispatch else cfg

def shapes(tree):
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in tree.items()}

def serve_call(cfg, api, mesh, kind, B, S, max_len, batch):
    shape = ShapeConfig(kind, S, B, kind)
    rules = SH.rules_for(cfg, shape, mesh)
    pshape = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, mesh.devices.shape[-1]), pshape, mesh)
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

def train_call(cfg, api, mesh, B, S, batch):
    shape = ShapeConfig("t", S, B, "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=plan["lr"], warmup_steps=1, total_steps=4)
    rules = SH.rules_for(cfg, shape, mesh)
    pshape = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0), cfg))
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, mesh.devices.shape[-1]), pshape, mesh)
    sspecs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "count": P()}, "step": P()}
    bshape = shapes(batch)
    bspecs = SH.named(SH.sanitize_specs(SH.batch_specs(cfg, shape, rules), bshape, mesh), mesh)
    sshape = {"params": pshape, "opt": {"m": pshape, "v": pshape, "count": jax.ShapeDtypeStruct((), jnp.int32)},
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    step = jax.jit(make_train_step(cfg, run, api, rules), in_shardings=(SH.named(sspecs, mesh), bspecs),
                   out_shardings=(SH.named(sspecs, mesh), None))
    return step.lower(sshape, bshape).compile(), SH.named(sspecs, mesh)

calls = {}
for name, (arch, dispatch, m, B, S) in plan["train"].items():
    cfg = config(arch, dispatch)
    with compat.set_mesh(meshes[m]):
        calls[name] = train_call(cfg, registry.get_model_api(cfg), meshes[m], B, S, plan["train_batches"][name][0])
for name, (arch, m, B, S, max_len) in plan["serve"].items():
    cfg = config(arch)
    api = registry.get_model_api(cfg)
    with compat.set_mesh(meshes[m]):
        calls[name] = {k: serve_call(cfg, api, meshes[m], k, B, S, max_len, plan["serve_batches"][name])
                       for k in ("prefill", "decode")}
while not os.path.exists(inputs_path):
    if os.path.exists(inputs_path + ".failed") or time.time() - T0 > 600:
        sys.exit("no inputs from the test process")
    time.sleep(0.05)
inp = pickle.load(open(inputs_path, "rb"))
put = jax.device_put
out = {}
for name, (arch, dispatch, m, B, S) in plan["train"].items():
    f, sh = calls[name]
    with compat.set_mesh(meshes[m]):
        state = put(jax.tree.map(jnp.asarray, inp["start"][arch]), sh)
        metrics = []
        for batch in plan["train_batches"][name]:
            state, mt = f(state, {k: jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in mt.items()})
    out[name] = (metrics, jax.tree.map(np.asarray, state))
for name, (arch, m, B, S, max_len) in plan["serve"].items():
    cfg = config(arch)
    api = registry.get_model_api(cfg)
    params = jax.tree.map(jnp.asarray, inp["start"][arch]["params"])
    run = {"logits": [], "tokens": []}
    with compat.set_mesh(meshes[m]):
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
arch, m, n, new, max_len, longest = plan["engine"]
cfg = config(arch)
reqs = [Request(i, p, max_new_tokens=new) for i, p in enumerate(plan["engine_prompts"])]
rules = SH.rules_for(cfg, ShapeConfig("serve", longest, n, "prefill"), meshes[m])
with compat.set_mesh(meshes[m]):
    eng = ServeEngine(cfg, jax.tree.map(jnp.asarray, inp["start"][arch]["params"]), registry.get_model_api(cfg),
                      rules=rules, max_len=max_len)
    out["engine"] = eng.generate(reqs)
pickle.dump(out, open(out_path, "wb"))
"""


def config(arch: str, dispatch=None):
    cfg = registry.get_config(arch, smoke=True).replace(dtype=torch.float32, **CONFIG_CHANGES.get(arch, {}))
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch)) if dispatch else cfg


def engine_prompts() -> list:
    """The launcher's mix of ``ENGINE``'s requests, the longest prompt
    extended with seeded tokens to ``ENGINE``'s longest length."""
    arch, _, n, new, _, longest = ENGINE
    vocab = config(arch).vocab_size
    out = [r.prompt for r in synthetic_requests(n, vocab, new)]
    i = max(range(n), key=lambda j: len(out[j]))
    extra = np.random.default_rng(7).integers(0, vocab, longest - len(out[i])).astype(np.int32)
    out[i] = np.concatenate([out[i], extra])
    return out


# ------------------------------------------------------------ planted faults
def _plant(fault: str):
    """Patch ``fault`` into the model modules; returns the undo."""
    if fault == "q_offset_zero":  # every chunk's queries attend as if they were the sequence's first
        original = lm.attention

        def at_zero(q, k, v, **kw):
            if k.shape[1] > q.shape[1] and kw.get("kv_len") is None and kw.get("k_positions") is None:
                kw["q_offset"] = 0
            return original(q, k, v, **kw)

        lm.attention = at_zero
        return lambda: setattr(lm, "attention", original)
    if fault == "kv_not_gathered":  # each chunk attends over its own keys
        original = lm.gather_dim
        lm.gather_dim = lambda x, dim, group: x
        return lambda: setattr(lm, "gather_dim", original)
    if fault == "positions_not_offset":  # every chunk rotated by the (t, h, w) ids of the first chunk
        original = lm.tp_region

        def first_chunk(body, x, weights, rules, mesh, extra=(), inputs=(), **kw):
            if inputs:
                (thw, spec), n = inputs[0], common.local(x).shape[1]
                first = common.whole(thw)[:, :, :n]
                whole = first.repeat(1, 1, thw.shape[2] // n)
                inputs = ((common.distribute(whole, spec, mesh), spec),)
            return original(body, x, weights, rules, mesh, extra, inputs, **kw)

        lm.tp_region = first_chunk
        return lambda: setattr(lm, "tp_region", original)
    original = lm.region  # splice_on_every_rank: every chunk takes the vision embeddings from position 0

    def from_zero(fn, args, in_specs, out_specs, **kw):
        if fn is lm._splice and len(args) == 3:
            args = (*args[:2], 0)
        return original(fn, args, in_specs, out_specs, **kw)

    lm.region = from_zero
    return lambda: setattr(lm, "region", original)


# ------------------------------------------------------------------ the ranks
def _recording(calls: list):
    """Wrap the attention of the three modules to append (module, query
    positions, key positions, query heads) of every training or prefill
    call from inside its region's body; returns the undo."""
    mods = (lm, mla, encdec)
    originals = [m.attention for m in mods]

    def wrap(name, fn):
        def call(q, k, v, **kw):
            if kw.get("kv_len") is None and kw.get("k_positions") is None:
                calls.append((name, q.shape[1], k.shape[1], q.shape[2]))
            return fn(q, k, v, **kw)
        return call

    for m, fn in zip(mods, originals):
        m.attention = wrap(m.__name__.rsplit(".", 1)[1], fn)

    def undo():
        for m, fn in zip(mods, originals):
            m.attention = fn

    return undo


def _train_case(name, inp, mesh):
    arch, dispatch, _, B, S = inp["train"][name]
    cfg = config(arch, dispatch)
    shape = ShapeConfig("t", S, B, "train")
    run = RunConfig(model=cfg, shape=shape, learning_rate=LR, warmup_steps=1, total_steps=4)
    state = state_from_numpy(inp["start"][arch], "cpu")
    rules, sspecs, bspecs = SH.train_specs(cfg, shape, run, mesh, state["params"])
    step = jit_train_step(make_train_step(cfg, run, registry.get_model_api(cfg), rules), mesh, sspecs, bspecs)
    metrics = []
    for batch in inp["train_batches"][name]:
        state, m = step(state, _torch_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "laid_out": _laid_out(state, sspecs, mesh), "rules": (rules.heads, rules.seq)}
    final = tree_map(lambda t: common.whole(t).detach().cpu().clone(), state)
    out["state"] = final if torch.distributed.get_rank() == 0 else None
    return out


def _serve_case(name, inp, mesh, steps):
    arch, _, B, S, max_len = inp["serve"][name]
    cfg = config(arch)
    api = registry.get_model_api(cfg)
    params = params_from_numpy(inp["start"][arch]["params"], "cpu")
    run = {"logits": [], "tokens": [], "laid_out": []}
    cache = api.init_cache(cfg, B, max_len, device="cpu")
    batch = _torch_batch(inp["serve_batches"][name])
    rules = SH.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
    run["prefill_rules"] = (rules.heads, rules.seq, rules.kv_seq)
    pspecs, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, batch, cache)
    params = lay_out(params, pspecs, mesh)
    logits, cache = api.prefill(params, batch, cfg, rules, cache)
    run["laid_out"].append(_laid_out(cache, cspecs, mesh))
    run["prefill_cache"] = _host(dict(sorted(cache.items())))  # the reference's leaf order
    run["logits"].append(logits.numpy())
    rules = SH.rules_for(cfg, ShapeConfig("decode", S, B, "decode"), mesh)
    _, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, {"tokens": (B, 1)}, cache)
    for j in range(steps):
        tok = torch.argmax(logits, -1)[:, None]
        run["tokens"].append(tok.int().numpy())
        logits, cache = api.decode_step(params, tok, cfg, rules, cache, S + j)
        run["logits"].append(logits.numpy())
        run["laid_out"].append(_laid_out(cache, cspecs, mesh))
    run["cache"] = _host(dict(sorted(cache.items())))  # a collective: every rank gathers, rank 0 returns it
    if torch.distributed.get_rank():
        run.pop("cache"), run.pop("prefill_cache")
    return run


def _rank_sp(mesh, plan, inputs_path):
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    meshes = {k: mesh if v == tuple(mesh.mesh.shape) else ranks.make_mesh(v, NAMES, device_type="cpu")
              for k, v in MESHES.items()}
    # DTensor's first collective loads its modules: done while the weights are drawn
    common.distribute(torch.zeros((8, 4)), Spec(("pod", "data"), None), mesh).full_tensor()
    _await_file(inputs_path)
    with open(inputs_path, "rb") as f:
        inp = dict(plan, **pickle.load(f))
    calls: list = []
    undo = _recording(calls)
    res = {}
    try:
        for name, (_, _, m, _, _) in inp["train"].items():
            del calls[:]
            with set_mesh(meshes[m]):
                res[name] = _train_case(name, inp, meshes[m])
            res[name]["calls"] = list(calls)
        for name, (_, m, _, _, _) in inp["serve"].items():
            del calls[:]
            with set_mesh(meshes[m]):
                res[name] = _serve_case(name, inp, meshes[m], inp["steps"])
            res[name]["calls"] = list(calls)
    finally:
        undo()
    res["faults"] = {}
    m = inp["serve"][FAULT_CASE][1]
    with set_mesh(meshes[m]):
        for fault in FAULTS:
            undo = _plant(fault)
            try:
                res["faults"][fault] = _serve_case(FAULT_CASE, inp, meshes[m], 1)["logits"]
            finally:
                undo()
    arch, m, n, new, max_len, longest = inp["engine"]
    cfg = config(arch)
    rules = SH.rules_for(cfg, ShapeConfig("serve", longest, n, "prefill"), meshes[m])
    with set_mesh(meshes[m]):
        eng = ServeEngine(cfg, params_from_numpy(inp["start"][arch]["params"], "cpu"), registry.get_model_api(cfg),
                          rules=rules, max_len=max_len, device="cpu")
        res["engine"] = eng.generate([Request(i, p, max_new_tokens=new) for i, p in enumerate(inp["engine_prompts"])])
    res["engine_rules"] = (rules.heads, rules.seq, rules.kv_seq)
    return res


# ------------------------------------------------------------ the reference
def _reference_start() -> dict:
    """The reference's start state (``init_train_state(PRNGKey(0))``) of
    each arch, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.configs.base import RunConfig as JRunConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.train.train_step import init_train_state

    start = {}
    for arch in ARCHS:
        cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32, **CONFIG_CHANGES.get(arch, {}))
        run = JRunConfig(model=cfg, shape=JShapeConfig("t", 32, 8, "train"), learning_rate=LR, warmup_steps=1,
                         total_steps=4)
        api = jregistry.get_model_api(cfg)
        start[arch] = jax.tree.map(np.asarray, jax.jit(lambda k: init_train_state(k, cfg, run, api))(
            jax.random.PRNGKey(0)))
    return {"start": start}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess compiles its calls from shapes and the
    ranks start while this process draws the weights; both then wait for
    ``inputs.pkl``."""
    d = tmp_path_factory.mktemp("mesh_sp")
    plan = {"train": TRAIN, "serve": SERVE, "steps": STEPS, "engine": ENGINE, "meshes": MESHES, "lr": LR,
            "config_changes": CONFIG_CHANGES, "engine_prompts": engine_prompts(),
            "train_batches": {name: [_rows(config(c[0]), c[3], c[4], 10 * i + j, labels=True) for j in range(2)]
                              for i, (name, c) in enumerate(TRAIN.items())},
            "serve_batches": {name: _rows(config(c[0]), c[2], c[3], 100 + i, labels=False)
                              for i, (name, c) in enumerate(SERVE.items())}}
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    inputs = str(d / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d / "plan.pkl"), inputs, str(d / "reference.pkl")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    group = pool.submit(ranks.run_ranks, _rank_sp, MESHES["1x2x4"], NAMES, backend="gloo", device="cpu",
                        args=(plan, inputs))
    try:
        try:
            inp = _reference_start()
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


def _tp(name: str) -> int:
    """The tensor axis's size on the case's mesh."""
    m = TRAIN[name][2] if name in TRAIN else SERVE[name][1]
    return MESHES[m][-1]


# ------------------------------------------------------------------ training
@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_steps_match_the_reference(name, runs):
    """Both steps' metrics, the parameters and first moments after step 2
    against the reference's sharded jitted step (the repaired
    ``heads=None`` layout fails here on the parent: its attention region
    reshaped 1 query head against 2 KV heads)."""
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


@pytest.mark.parametrize("name", list(TRAIN))
def test_rules_for_gives_the_layout_under_test(name, runs):
    """Every case but two falls into SP under ``rules_for``: ``heads=None``
    with the sequence split over ``model``."""
    _, _, mine = runs
    want = TRAIN_RULES.get(name, (None, "model"))
    assert all(r[name]["rules"] == want for r in mine)


@pytest.mark.parametrize("name", [n for n in TRAIN if TRAIN_RULES.get(n, (None, "model"))[1]])
def test_each_rank_attends_its_chunk_against_the_whole_sequence(name, runs):
    """Inside every attention region under SP each rank's queries are its
    S / tp positions and its keys all S (the encoder's frames F / tp
    against F, the cross-attention's S / tp against F), every head."""
    _, _, mine = runs
    arch, _, _, _, S = TRAIN[name]
    cfg = config(arch)
    tp = _tp(name)
    want = {(S // tp, S)}
    if cfg.family == "encdec":
        F = cfg.encoder_seq_len
        want |= {(F // tp, F), (S // tp, F)}
    for r in mine:
        calls = r[name]["calls"]
        assert calls and {(q, k) for _, q, k, _ in calls} == want, calls
        assert {h for *_, h in calls} == {cfg.num_heads}, calls


def test_heads_none_without_sp_attends_every_head_of_the_whole_sequence(runs):
    _, _, mine = runs
    cfg = config("gemma3-4b")
    for r in mine:
        calls = r["gemma3_heads_none"]["calls"]
        assert calls and set(calls) == {("lm", 30, 30, cfg.num_heads)}, calls


# ------------------------------------------------------------------- serving
@pytest.mark.parametrize("name", list(SERVE))
def test_logits_match_the_reference_on_every_rank(name, runs):
    _, want, mine = runs
    for res in mine:
        assert res[name]["prefill_rules"] == (None, "model", "model")
        assert len(res[name]["logits"]) == len(want[name]["logits"]) == STEPS + 1
        for got, ref in zip(res[name]["logits"], want[name]["logits"]):
            assert _err(got, ref) <= TOL


@pytest.mark.parametrize("name", list(SERVE))
def test_cache_matches_the_reference(name, runs):
    """Every leaf after the prefill (the prompt's chunks written into the
    cache's ``kv_seq`` shards) and after the last decode step."""
    _, want, mine = runs
    pairs = list(zip(mine[0][name]["cache"], want[name]["cache"]))
    pairs += list(zip(mine[0][name]["prefill_cache"], want[name]["prefill_cache"]))
    assert len(pairs) == 2 * len(want[name]["cache"])
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


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_attends_each_chunk_against_the_whole_prompt(name, runs):
    _, _, mine = runs
    arch, _, _, S, _ = SERVE[name]
    cfg = config(arch)
    tp = _tp(name)
    want = {(S // tp, S)}
    if cfg.family == "encdec":
        F = cfg.encoder_seq_len
        want |= {(F // tp, F), (S // tp, F)}
    for res in mine:
        assert {(q, k) for _, q, k, _ in res[name]["calls"]} == want


def test_serve_engine_over_the_mesh_matches_the_reference_and_unsharded(runs):
    inp, want, mine = runs
    arch, _, n, new, max_len, _ = ENGINE
    cfg = config(arch)
    reqs = [Request(i, p, max_new_tokens=new) for i, p in enumerate(inp["engine_prompts"])]
    plain = ServeEngine(cfg, params_from_numpy(inp["start"][arch]["params"], "cpu"), registry.get_model_api(cfg),
                        max_len=max_len, device="cpu").generate(reqs)
    assert sorted(plain) == list(range(n)) and all(len(t) == new for t in plain.values())
    assert {i: list(t) for i, t in want["engine"].items()} == plain
    for res in mine:
        assert res["engine_rules"] == (None, "model", "model")
        assert res["engine"] == plain


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_miss_the_tolerance(fault, runs):
    """Each fault, planted in the same ranks, moves the qwen2-vl prefill or
    its first decode step past 1e-4."""
    _, want, mine = runs
    ref = want[FAULT_CASE]["logits"][:2]
    for res in mine:
        got = res["faults"][fault]
        assert len(got) == 2
        assert max(_err(g, r) for g, r in zip(got, ref)) > TOL
