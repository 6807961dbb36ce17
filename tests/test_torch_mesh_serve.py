"""Serving over a mesh: the port's ``prefill``, ``decode_step`` and
``ServeEngine(rules=...)`` on a (2, 2, 2) ``pod/data/model`` mesh of 8
gloo ranks, against the reference's prefill and decode jitted with the
in- and out-shardings of ``repro.launch.dryrun.build_lowered`` (its
``param_specs``, batch rows and ``cache_specs``), executed on 8 fake XLA
devices.

Weights from the reference's ``init(PRNGKey(0))`` (``params_from_numpy``),
prompts drawn with numpy from a seed, float32 compute.  Cases:

1. minitron-4b smoke: dense GQA, 2 KV heads on tensor 2; prefill at B = 8
   of a 24-token prompt, ``max_len`` 48, then 3 greedy decode steps;
2. deepseek-v2-lite smoke, ``dispatch="shard_map"``: the MLA latent cache
   (replicated over the tensor axis) and K1 on each rank's own tokens in
   prefill and at S = 1;
3. mixtral-8x22b smoke: its ring cache of 32 behind a 40-token prompt (the
   ring wraps), its ``sorted`` dispatch under the mesh;
4. ``kv_seq``: decode at global batch 1 under ``rules_for(..., decode)``,
   which gives ``kv_seq="data"``, for gemma3-4b smoke (GQA with windowed
   layers) and deepseek-v2-lite smoke (the latent): from the reference's
   unsharded prefill of a 40-token prompt (``max_len`` 64, so the window
   of 32 reaches into the first shard), 3 decode steps, each rank
   attending over its half of the cache and the halves joined by
   log-sum-exp;
5. ``ServeEngine(rules=...)`` on the mesh: deepseek smoke with
   ``shard_map``, 8 requests of the launcher's mix, 4 new tokens, against
   the reference's engine under its mesh and the port's unsharded engine.

Each holds the last-position logits and every cache leaf (gathered) within
1e-4 of the reference's (``tests/test_torch_models.py``'s tolerance), the
greedy tokens equal, and every cache leaf laid out as
``launch.sharding.named(cache_specs)``.  The paths the port once refused
over a mesh (attention under ``rules.seq``, on the dense, encdec and vlm
families alike, and the dense MoE oracle) serve a prefill and a decode
step with the unsharded calls' logits (``tests/test_torch_mesh_sp.py``
holds them to the reference).

The reference's unsharded pieces (init, the kv_seq cases' prefill) run in
this process; its sharded runs in one subprocess, which compiles them
from shapes meanwhile, at the same time as the port's one spawned group
of 8 ranks (one thread each).  The rank function imports no jax.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import sharding as SH
from repro_torch.kernels import ops
from repro_torch.launch.serve import synthetic_requests
from repro_torch.models import common, lm, mla
from repro_torch.models.common import lay_out, set_mesh, tree_leaves, tree_map
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import ranks
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 2, 2), ("pod", "data", "model"))
TOL = 1e-4
STEPS = 3
# name → (arch, dispatch, batch, prompt, max_len, starts from the reference's unsharded prefill)
CASES = {
    "minitron": ("minitron-4b", None, 8, 24, 48, False),
    "deepseek": ("deepseek-v2-lite-16b", "shard_map", 8, 24, 48, False),
    "mixtral_ring": ("mixtral-8x22b", None, 8, 40, 48, False),
    "gemma3_kv_seq": ("gemma3-4b", None, 1, 40, 64, True),
    "deepseek_kv_seq": ("deepseek-v2-lite-16b", "shard_map", 1, 40, 64, True),
}
ENGINE = ("deepseek-v2-lite-16b", "shard_map", 8, 4, 64)  # arch, dispatch, requests, new tokens, max_len
# paths the port once refused under a mesh → (arch, dispatch, a hand-made seq="model" rule): attention under
# sequence parallelism on the encdec, vlm and dense families, and the dense MoE oracle; each is held to the
# reference in tests/test_torch_mesh_sp.py and here to the port's unsharded calls
ONCE_REFUSED = {"whisper-tiny": ("whisper-tiny", None, True), "qwen2-vl-7b": ("qwen2-vl-7b", None, True),
                "rules.seq": ("minitron-4b", None, True), "dispatch=dense": ("deepseek-v2-lite-16b", "dense", False)}

REFERENCE = r"""
import os, sys, pickle, dataclasses, time
T0 = time.time()
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
import numpy as np, jax, jax.numpy as jnp
from repro import compat
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import sharding as SH
from repro.serve.engine import Request, ServeEngine
plan, inputs_path, out_path = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], sys.argv[3]
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))

def config(arch, dispatch):
    cfg = registry.get_config(arch, smoke=True).replace(dtype=jnp.float32)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch)) if dispatch else cfg

def compiled(cfg, api, kind, B, S, max_len):
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

# compile every call while the test process draws the weights, then wait for them
calls = {}
with compat.set_mesh(mesh):
    for name, (arch, dispatch, B, S, max_len, from_unsharded) in plan["cases"].items():
        cfg = config(arch, dispatch)
        api = registry.get_model_api(cfg)
        kinds = ("decode",) if from_unsharded else ("prefill", "decode")
        calls[name] = {kind: compiled(cfg, api, kind, B, S, max_len) for kind in kinds}
while not os.path.exists(inputs_path):
    if os.path.exists(inputs_path + ".failed") or time.time() - T0 > 600:
        sys.exit("no inputs from the test process")
    time.sleep(0.05)
inp = pickle.load(open(inputs_path, "rb"))
put = jax.device_put
out = {}
for name, (arch, dispatch, B, S, max_len, from_unsharded) in plan["cases"].items():
    cfg = config(arch, dispatch)
    api = registry.get_model_api(cfg)
    params = jax.tree.map(jnp.asarray, inp["params"][arch])
    run = {"logits": [], "tokens": []}
    with compat.set_mesh(mesh):
        if from_unsharded:
            logits, cache = inp["start"][name]
            cache = jax.tree.map(jnp.asarray, cache)
        else:
            f, (ps, ts, cs) = calls[name]["prefill"]
            logits, cache = f(put(params, ps), put(jnp.asarray(plan["prompts"][name]), ts),
                              put(api.init_cache(cfg, B, max_len), cs))
            run["prefill_cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
        run["logits"].append(np.asarray(logits))
        step, (ps, ts, cs) = calls[name]["decode"]
        for j in range(plan["steps"]):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            run["tokens"].append(np.asarray(tok))
            logits, cache = step(put(params, ps), put(tok, ts), put(cache, cs), jnp.int32(S + j))
            run["logits"].append(np.asarray(logits))
    run["cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
    out[name] = run
arch, dispatch, n, new, max_len = plan["engine"]
cfg = config(arch, dispatch)
api = registry.get_model_api(cfg)
reqs = [Request(i, p, max_new_tokens=new) for i, p in enumerate(plan["engine_prompts"])]
rules = SH.rules_for(cfg, ShapeConfig("serve", max_len, n, "decode"), mesh)
with compat.set_mesh(mesh):
    eng = ServeEngine(cfg, jax.tree.map(jnp.asarray, inp["params"][arch]), api, rules=rules, max_len=max_len)
    out["engine"] = eng.generate(reqs)
pickle.dump(out, open(out_path, "wb"))
"""


def config(arch: str, dispatch):
    cfg = registry.get_config(arch, smoke=True).replace(dtype=torch.float32)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch)) if dispatch else cfg


def prompts(vocab: int, B: int, S: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _host(tree):
    return [common.whole(t).detach().cpu().numpy() for t in tree_leaves(tree)]


def _laid_out(cache, cspecs, mesh) -> bool:
    """Every cache leaf a DTensor with the placements of ``named(cspecs)``."""
    want = [tuple(common.placements(s, mesh)) for _, s in common.spec_items(cspecs)]
    return all(common.is_dtensor(t) and tuple(t.placements) == pl for t, pl in zip(tree_leaves(cache), want))


def serve_gap(cfg, rules, mesh, B: int = 8, S: int = 8, seed: int = 0) -> dict:
    """The largest logit gap of a prefill of ``S`` tokens (with the
    family's inputs) and of one decode step over ``mesh`` under ``rules``
    against the same calls unsharded, on the port's own weights drawn from
    ``seed``: ``{"prefill": gap, "decode_step": gap}`` on every rank."""
    from repro_torch.data.pipeline import SyntheticLMData

    api = registry.get_model_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(seed))
    batch = {k: v for k, v in SyntheticLMData(cfg, B, S, seed=seed).next_batch().items() if k != "labels"}
    with torch.no_grad():
        want, wcache = api.prefill(params, batch, cfg, common.NO_SHARD, api.init_cache(cfg, B, 2 * S, device="cpu"))
        got, gcache = api.prefill(params, batch, cfg, rules, api.init_cache(cfg, B, 2 * S, device="cpu"))
        out = {"prefill": float((got - want).abs().max())}
        tok = torch.argmax(want, -1)[:, None]
        want, _ = api.decode_step(params, tok, cfg, common.NO_SHARD, wcache, S)
        got, _ = api.decode_step(params, tok, cfg, rules, gcache, S)
    out["decode_step"] = float((got - want).abs().max())
    return out


def _once_refused(mesh) -> dict:
    """Each once-refused path's gaps to the unsharded calls, by (path,
    prefill or decode_step)."""
    out = {}
    for what, (arch, dispatch, seq) in ONCE_REFUSED.items():
        cfg = config(arch, dispatch)
        rules = SH.rules_for(cfg, ShapeConfig("p", 8, 8, "prefill"), mesh)
        gaps = serve_gap(cfg, dataclasses.replace(rules, seq="model") if seq else rules, mesh)
        out.update({(what, fn): g for fn, g in gaps.items()})
    return out


def _await_file(path: str, timeout: float = 600.0) -> None:
    """Wait for ``path``; raise if ``path + ".failed"`` appears first or
    the time runs out (the test process could not write it)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if os.path.exists(path + ".failed") or time.monotonic() - t0 > timeout:
            raise RuntimeError(f"no {path} from the test process")
        time.sleep(0.05)


def _rank_serve(mesh, plan, inputs_path):
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    # DTensor's first collective loads its modules: done while the weights are drawn
    common.distribute(torch.zeros((8, 4)), common.Spec(("pod", "data"), None), mesh).full_tensor()
    _await_file(inputs_path)
    with open(inputs_path, "rb") as f:
        inp = dict(plan, **pickle.load(f))
    k1_ids = []  # the ids of every K1 call: each rank's own assignments under shard_map
    bcr = ops.bucket_count_rank

    def counted(ids, num_buckets):
        k1_ids.append(int(ids.numel()))
        return bcr(ids, num_buckets)

    combines = []
    combine = common.lse_combine

    def counted_combine(out, lse, mesh, axes):
        combines.append(tuple(axes))
        return combine(out, lse, mesh, axes)

    ops.bucket_count_rank = counted
    lm.lse_combine = mla.lse_combine = counted_combine
    res = {}
    with set_mesh(mesh):
        for name, (arch, dispatch, B, S, max_len, from_unsharded) in inp["cases"].items():
            cfg = config(arch, dispatch)
            params = params_from_numpy(inp["params"][arch], "cpu")
            run = {"logits": [], "tokens": [], "laid_out": [], "k1": [], "combines": [], "local_seq": []}
            if from_unsharded:
                logits, cache = inp["start"][name]
                logits, cache = torch.from_numpy(logits), tree_map(lambda a: torch.from_numpy(np.asarray(a)), cache)
            else:
                cache = lm.init_cache(cfg, B, max_len, device="cpu")
                rules = SH.rules_for(cfg, ShapeConfig("prefill", S, B, "prefill"), mesh)
                pspecs, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, {"tokens": (B, S)}, cache)
                params = lay_out(params, pspecs, mesh)
                del k1_ids[:]
                logits, cache = lm.prefill(params, {"tokens": torch.from_numpy(inp["prompts"][name]).long()}, cfg, rules,
                                           cache)
                run["k1"].append(list(k1_ids))
                run["laid_out"].append(_laid_out(cache, cspecs, mesh))
                run["prefill_cache"] = _host(cache)
            run["logits"].append(logits.numpy())
            rules = SH.rules_for(cfg, ShapeConfig("decode", S, B, "decode"), mesh)
            _, _, cspecs = SH.serve_layout(cfg, rules, mesh, params, {"tokens": (B, 1)}, cache)
            run["rules"] = (rules.batch, rules.kv_seq)
            for j in range(inp["steps"]):
                tok = torch.argmax(logits, -1)[:, None]
                run["tokens"].append(tok.int().numpy())
                del k1_ids[:], combines[:]
                logits, cache = lm.decode_step(params, tok, cfg, rules, cache, S + j)
                run["logits"].append(logits.numpy())
                run["k1"].append(list(k1_ids))
                run["combines"].append(list(combines))
                run["laid_out"].append(_laid_out(cache, cspecs, mesh))
                run["local_seq"].append([tuple(common.local(t).shape) for t in tree_leaves(cache)])
            run["cache"] = _host(cache)  # a collective: every rank gathers, rank 0 returns it
            if torch.distributed.get_rank():
                run.pop("cache"), run.pop("prefill_cache", None)
            res[name] = run
        arch, dispatch, n, new, max_len = inp["engine"]
        cfg = config(arch, dispatch)
        reqs = synthetic_requests(n, cfg.vocab_size, new)
        rules = SH.rules_for(cfg, ShapeConfig("serve", max_len, n, "decode"), mesh)
        eng = ServeEngine(cfg, params_from_numpy(inp["params"][arch], "cpu"), lm, rules=rules, max_len=max_len,
                          device="cpu")
        res["engine"] = eng.generate(reqs)
        res["once_refused"] = _once_refused(mesh)
    return res


def _reference_unsharded(arch: str, dispatch, toks: np.ndarray, max_len: int, params):
    """The reference's unsharded jitted prefill: (last logits, cache) as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.models.common import NO_SHARD

    cfg = jregistry.get_config(arch, smoke=True).replace(dtype=jnp.float32)
    if dispatch:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    api = jregistry.get_model_api(cfg)
    f = jax.jit(lambda p, t, c: api.prefill(p, {"tokens": t}, cfg, NO_SHARD, c))
    logits, cache = f(params, jnp.asarray(toks), api.init_cache(cfg, toks.shape[0], max_len))
    return np.asarray(logits), jax.tree.map(np.asarray, cache)


def _reference_inputs(plan: dict) -> dict:
    """The reference's weights (``init(PRNGKey(0))``) and the ``kv_seq``
    cases' unsharded prefill, as numpy."""
    import jax
    from repro.configs import registry as jregistry

    archs = sorted({c[0] for c in CASES.values()} | {ENGINE[0]})
    jparams = {a: jregistry.get_model_api(jregistry.get_config(a, smoke=True)).init(
        jax.random.PRNGKey(0), jregistry.get_config(a, smoke=True)) for a in archs}
    start = {n: _reference_unsharded(c[0], c[1], plan["prompts"][n], c[4], jparams[c[0]])
             for n, c in CASES.items() if c[5]}
    return {"params": {a: jax.tree.map(np.asarray, p) for a, p in jparams.items()}, "start": start}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess compiles its calls from shapes and the
    ranks start while this process draws the weights; both then wait for
    ``inputs.pkl``."""
    d = tmp_path_factory.mktemp("mesh_serve")
    vocab = {a: registry.get_config(a, smoke=True).vocab_size for a in {c[0] for c in CASES.values()} | {ENGINE[0]}}
    plan = {"cases": CASES, "steps": STEPS, "engine": ENGINE,
            "prompts": {n: prompts(vocab[c[0]], c[2], c[3], seed=i + 1) for i, (n, c) in enumerate(CASES.items())},
            "engine_prompts": [r.prompt for r in synthetic_requests(ENGINE[2], vocab[ENGINE[0]], ENGINE[3])]}
    with open(d / "plan.pkl", "wb") as f:
        pickle.dump(plan, f)
    inputs = str(d / "inputs.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, str(d / "plan.pkl"), inputs, str(d / "reference.pkl")],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    group = pool.submit(ranks.run_ranks, _rank_serve, *MESH, backend="gloo", device="cpu", args=(plan, inputs))
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


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_the_reference_on_every_rank(name, runs):
    _, want, mine = runs
    for res in mine:
        assert len(res[name]["logits"]) == STEPS + 1
        for got, ref in zip(res[name]["logits"], want[name]["logits"]):
            assert _err(got, ref) <= TOL


@pytest.mark.parametrize("name", list(CASES))
def test_cache_matches_the_reference(name, runs):
    _, want, mine = runs
    pairs = list(zip(mine[0][name]["cache"], want[name]["cache"]))
    if "prefill_cache" in want[name]:
        pairs += list(zip(mine[0][name]["prefill_cache"], want[name]["prefill_cache"]))
    assert len(pairs) == len(want[name]["cache"]) * (2 if "prefill_cache" in want[name] else 1)
    for got, ref in pairs:
        assert _err(got, ref) <= TOL


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal_the_reference(name, runs):
    _, want, mine = runs
    for res in mine:
        assert [t.tolist() for t in res[name]["tokens"]] == [t.tolist() for t in want[name]["tokens"]]


@pytest.mark.parametrize("name", list(CASES))
def test_cache_is_laid_out_by_cache_specs(name, runs):
    _, _, mine = runs
    for res in mine:
        assert res[name]["laid_out"] and all(res[name]["laid_out"])


def test_shard_map_runs_k1_on_each_ranks_own_tokens(runs):
    """deepseek at B = 8 on 4 batch shards: each MoE layer's K1 call ranks
    one rank's 2 rows' assignments, 24 tokens each in prefill, 1 a step."""
    inp, _, mine = runs
    _, _, B, S, _, _ = CASES["deepseek"]
    cfg = config("deepseek-v2-lite-16b", "shard_map")
    k, L = cfg.moe.num_experts_per_tok, cfg.num_layers
    for res in mine:
        prefill, *steps = res["deepseek"]["k1"]
        assert prefill == [B // 4 * S * k] * L
        assert steps == [[B // 4 * 1 * k] * L] * STEPS


@pytest.mark.parametrize("name", ["gemma3_kv_seq", "deepseek_kv_seq"])
def test_kv_seq_attends_per_shard_and_combines(name, runs):
    """Global batch 1: the batch unsharded, the cache split along its
    sequence over ``data``; each rank keeps its half through every step
    (nothing gathered), and every layer joins the halves by log-sum-exp
    over ``data``."""
    _, _, mine = runs
    arch, _, _, _, max_len, _ = CASES[name]
    L = config(arch, None).num_layers
    for res in mine:
        run = res[name]
        assert run["rules"] == (None, "data")
        assert run["combines"] == [[("data",)] * L] * STEPS
        for shapes in run["local_seq"]:
            assert all(s[2] == max_len // 2 for s in shapes)  # (L, B, S/2, ...) on every rank


def test_serve_engine_over_the_mesh_matches_the_reference_and_unsharded(runs):
    inp, want, mine = runs
    arch, dispatch, n, new, max_len = ENGINE
    cfg = config(arch, dispatch)
    plain = ServeEngine(cfg, params_from_numpy(inp["params"][arch], "cpu"), lm, max_len=max_len,
                        device="cpu").generate(synthetic_requests(n, cfg.vocab_size, new))
    assert sorted(plain) == list(range(n)) and all(len(t) == new for t in plain.values())
    assert {i: list(t) for i, t in want["engine"].items()} == plain
    for res in mine:
        assert res["engine"] == plain


@pytest.mark.parametrize("fn", ["prefill", "decode_step"])
@pytest.mark.parametrize("what", list(ONCE_REFUSED))
def test_once_refused_paths_serve_as_unsharded(what, fn, runs):
    """Attention under a hand-made ``seq="model"`` rule (the encdec, vlm
    and dense families) and the dense MoE oracle, which the port once
    refused over a mesh, give the unsharded call's logits on every rank."""
    _, _, mine = runs
    for res in mine:
        assert res["once_refused"][what, fn] <= TOL, res["once_refused"]
