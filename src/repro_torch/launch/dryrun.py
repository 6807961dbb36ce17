"""Multi-pod dry-run: trace every (arch × shape) on the production mesh as
one device's share, prove the shardings cohere, predict memory and
calibrated roofline terms.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh single|multi|both] [--hw h100|v5e]
                                        [--smoke] [--out DIR]

The port's copy of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell on 512 fake XLA host devices; the port builds the
cell's shapes without a number (``eval_shape``: meta tensors, nothing
drawn) and traces one device's step on fake tensors (``build_traced``,
``roofline.analysis.trace``).  Nothing is computed, nothing launches, and
no process group is made: the run is host-only, like the reference's.

The per-device view (``build_traced``) of a cell:

* parameters, optimizer state, batch and cache at their shard's shape
  under the sanitized specs (the arguments, exact arithmetic);
* the batch over the rules' batch axes, or under SP (``rules.seq`` =
  ``model``) the sequence over ``model``, with K/V gathered to the whole
  sequence before attention (``common.gather_seq``);
* the widths that the sanitized specs shard on ``model`` divided by its
  size (heads, KV heads, ``d_ff``, vocab, expert or shared-expert
  ``d_ff``; experts sharded on ``model`` run as each expert's ``d_ff``
  divided, the same FLOPs and weight bytes); under SP every width whole;
* every parameter shard gathered to that view before the model runs (the
  FSDP all-gather, and the ``model`` gather under SP): a flat repeat whose
  backward sums back into the shard, so FSDP moves memory and
  collectives, not FLOPs.  A shard that no gather makes into its view
  fails the cell: the sharding does not cohere.

Collectives are derived from the same view (``_collectives``), not read
from HLO.  The record keeps the reference's keys, so ``report.py`` reads
a JSON file from either package; ``lower_s`` holds the seconds to build
the shapes and ``compile_s`` the seconds to trace.  The full-config trace
runs every layer (eager torch has no while-loop counted once), so its
``raw_roofline_scanbody_once`` counts every layer; the calibrated terms
keep the reference's L1/L2/A extrapolation exactly as written.  ``--hw``
chooses the record the terms divide by: ``h100`` (the default) or
``v5e``, the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ModelConfig, RunConfig, ShapeConfig
from repro_torch.kernels import launch_counts
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.common import Spec, shapes_only, spec_items, spec_map, tree_leaves, tree_map, tree_unflatten
from repro_torch.roofline.analysis import (
    Collective,
    collective_bytes,
    memory_analysis,
    model_flops_for,
    roofline_from_trace,
    trace,
)
from repro_torch.roofline.hw import H100, HW, RECORDS

# Microbatches per train step, sized so per-device activation memory
# (layers × tokens/dev × d_model × 2B under per-layer remat) stays well
# inside the 16 GB v5e HBM.  Effective value is min(this, B/batch_shards).
GRAD_ACCUM = {
    "whisper-tiny": 1,
    "mixtral-8x22b": 16,
    "deepseek-v2-lite-16b": 4,
    "minitron-4b": 8,
    "qwen1.5-32b": 16,
    "qwen1.5-110b": 16,
    "gemma3-4b": 8,
    "mamba2-370m": 2,
    "qwen2-vl-7b": 8,
    "zamba2-2.7b": 8,
}


# =============================================================== the view
def _layer_period(cfg: ModelConfig) -> int:
    if cfg.is_hybrid:
        return cfg.hybrid_period
    if cfg.window_pattern:
        return len(cfg.window_pattern)
    return 1


def _scaled_cfg(cfg: ModelConfig, n_layers: int, scan: bool) -> ModelConfig:
    kw = {"num_layers": n_layers, "scan_layers": scan}
    if cfg.family == "encdec":
        kw["encoder_layers"] = max(1, cfg.encoder_layers * n_layers // max(cfg.num_layers, 1))
    return cfg.replace(**kw)


def eval_shape(fn, *args):
    """``fn(*args)`` with every init making meta tensors: the shapes and
    dtypes of its result, nothing drawn, nothing allocated."""
    with shapes_only():
        return fn(*args)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _on_model(entry) -> bool:
    return entry == "model" or (isinstance(entry, tuple) and "model" in entry)


def _split(pspecs, suffix: tuple[str, ...], dim: int) -> bool:
    """Does the first spec whose path ends with ``suffix`` shard ``dim`` on
    ``model``?"""
    for path, spec in spec_items(pspecs):
        if path[-len(suffix):] == suffix:
            return _on_model(spec[dim])
    return False


def _view_cfg(cfg: ModelConfig, pspecs, rules, tp: int) -> ModelConfig:
    """One device's model: each width that the sanitized specs shard on
    ``model`` divided by ``tp``; heads only where the rules shard them
    (``rules.heads``: the query and KV heads both divide, so each device
    keeps whole GQA groups); under SP (the ``model`` axis holds the
    sequence) or without a ``model`` axis, ``cfg`` itself."""
    if rules.seq == "model" or tp == 1:
        return cfg
    split = functools.partial(_split, pspecs)
    kw = {"head_dim": cfg.resolved_head_dim}
    if rules.heads is not None:
        if split(("wq",), -2):
            kw["num_heads"] = cfg.num_heads // tp
        if split(("wk",), -2):
            kw["num_kv_heads"] = cfg.num_kv_heads // tp
    if split(("mlp", "wi"), -1):
        kw["d_ff"] = cfg.d_ff // tp
    if split(("embedding", "embed"), 0):
        kw["vocab_size"] = cfg.vocab_size // tp
    if cfg.is_moe:
        m = cfg.moe
        mkw = {}
        # experts on model (expert parallel) run as each expert's d_ff on
        # model: the same FLOPs and weight bytes a device
        if (split(("moe", "wi"), -3) or split(("moe", "wi"), -1)) and m.expert_d_ff % tp == 0:
            mkw["expert_d_ff"] = m.expert_d_ff // tp
        if m.num_shared_experts and split(("moe", "shared_wi"), -1) and m.shared_d_ff % tp == 0:
            mkw["shared_d_ff"] = m.shared_d_ff // tp
        kw["moe"] = dataclasses.replace(m, **mkw)
    return cfg.replace(**kw)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One tensor of the state or cache: its path, shard and view shapes,
    dtype, and the mesh axes the gather to the view runs over."""

    path: str
    shard: tuple[int, ...]
    view: tuple[int, ...]
    dtype: torch.dtype
    gathered: tuple[str, ...]

    @property
    def shard_bytes(self) -> int:
        return _nbytes(self.shard, self.dtype)

    @property
    def view_bytes(self) -> int:
        return _nbytes(self.view, self.dtype)


def _gather_axes(spec: Spec, k: int, sizes: dict, gatherable: tuple[str, ...], path: str) -> tuple[str, ...]:
    """The axes of ``spec`` whose gather multiplies a shard by ``k``: its
    ``gatherable`` axes, or those but ``model`` (the view keeps the model
    split)."""
    axes = [a for e in spec if e for a in ((e,) if isinstance(e, str) else e) if a in gatherable]
    for keep in ((), ("model",)):
        cand = tuple(a for a in axes if a not in keep)
        if math.prod(sizes.get(a, 1) for a in cand) == k:
            return cand
    raise ValueError(f"{path}: shard {k}× short of its view under {spec}: the sharding does not cohere")


def _leaves(specs, full_tree, view_tree, mesh: MeshSpec, prefix: str, gatherable: tuple[str, ...]):
    """A ``_Leaf`` tree over ``specs``: shard shapes from the full shapes,
    views from ``view_tree``, gathers over ``gatherable`` axes only."""
    sizes = SH.mesh_axis_sizes(mesh)
    paths = iter("/".join((prefix,) + p if prefix else p) for p, _ in spec_items(specs))

    def leaf(spec, full, view):
        path = next(paths)
        shard = SH.local_shape(tuple(full.shape), spec, mesh)
        k, rem = divmod(math.prod(view.shape), math.prod(shard))
        if rem or k < 1:
            raise ValueError(f"{path}: shard {shard} does not gather to its view {tuple(view.shape)}")
        gathered = _gather_axes(spec, k, sizes, gatherable, path) if k > 1 else ()
        return _Leaf(path, shard, tuple(view.shape), full.dtype, gathered)

    return spec_map(leaf, specs, full_tree, view_tree)


def _gather(shard: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
    """A shard made into its view.  Gathered, it is a broadcast view of the
    shard's first element: the view's shape with no storage of its own (a
    layer at a time is what a sharded step holds, and the gather's bytes
    are the collectives' to count), whose gradient sums back into the
    shard.  Values are fake, so none is read."""
    if tuple(shard.shape) == leaf.view:
        return shard
    flat = shard.reshape(-1)
    if flat.numel() == math.prod(leaf.view):  # experts on model run as d_ff on model
        return flat.view(leaf.view)
    return flat[:1].view([1] * len(leaf.view)).expand(leaf.view)


def _gathered(shards, leaves):
    return tree_unflatten(shards, [_gather(s, lf) for s, lf in zip(tree_leaves(shards), tree_leaves(leaves))])


class _ShardedAPI:
    """The model API over one device's parameter shards: each shard is
    gathered to the view before the model runs."""

    def __init__(self, api, leaves):
        self.api, self.leaves = api, leaves

    def forward(self, params, batch, cfg, rules):
        return self.api.forward(_gathered(params, self.leaves), batch, cfg, rules)

    def prefill(self, params, batch, cfg, rules, cache):
        return self.api.prefill(_gathered(params, self.leaves), batch, cfg, rules, cache)

    def decode_step(self, params, tokens, cfg, rules, cache, pos):
        return self.api.decode_step(_gathered(params, self.leaves), tokens, cfg, rules, cache, pos)


def _kv_leaf(cache):
    """The cache leaf whose dim 2 is the sequence, if the cache has one."""
    if "shared" in cache:
        return cache["shared"][0]
    if "self" in cache:
        return cache["self"][0]
    layers = cache["layers"]
    if isinstance(layers, dict):
        return layers.get("c")
    return layers[0]


@dataclasses.dataclass
class Traced:
    """One cell's per-device step, ready to trace: ``make_args()`` builds
    the fake arguments inside a ``FakeTensorMode``, ``fn(*args)`` runs the
    step.  ``argument_bytes`` are the arguments' shards, ``collectives``
    the step's (per device), ``gathered_gradient_bytes`` what the trace's
    gradients at the gathered width hold beyond their shards at its peak
    (train only), ``build_s`` the seconds the shapes took."""

    fn: object
    make_args: object
    argument_bytes: int
    collectives: list
    gathered_gradient_bytes: int
    build_s: float

    def memory(self, tr) -> dict:
        return memory_analysis(tr, argument_bytes=self.argument_bytes,
                               gathered_gradient_bytes=self.gathered_gradient_bytes)


def build_traced(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, run: RunConfig, *, cache_len=None):
    """One computation (train/prefill/decode) of ``cfg`` at ``shape`` as one
    device of ``mesh`` runs it.  Returns (Traced, rules)."""
    t0 = time.perf_counter()
    rules = SH.rules_for(cfg, shape, mesh)
    api = registry.get_model_api(cfg)
    sizes = SH.mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    sp = rules.seq == "model"
    gen = torch.Generator()
    in_specs = registry.input_specs(cfg, shape)
    bspecs = SH.sanitize_specs(SH.batch_specs(cfg, shape, rules), in_specs, mesh)
    params_shape = eval_shape(api.init, cfg, gen)
    pspecs = SH.sanitize_specs(api.param_specs(cfg, rules, tp), params_shape, mesh)
    vcfg = _view_cfg(cfg, pspecs, rules, tp)
    # parameters gather over FSDP (and model where the view keeps a width whole)
    p_leaves = _leaves(pspecs, params_shape, eval_shape(api.init, vcfg, gen), mesh, "params", ("data", "model"))
    vrules = dataclasses.replace(rules, seq_shards=tp if sp else 1)

    local = {k: SH.local_shape(tuple(t.shape), bspecs[k], mesh) for k, t in in_specs.items()}
    B_loc, S = local["tokens"]
    S_loc = S // tp if sp else S

    def batch_view():
        out = {}
        for k, t in in_specs.items():
            shp = list(local[k])
            if k in ("tokens", "labels"):
                shp[1] = S_loc
            elif k == "positions_thw":
                shp[2] = S_loc
            elif k == "vision_embeds":  # the vision tokens that fall in this device's slice
                shp[1] = min(shp[1], S_loc)
            out[k] = torch.empty(shp, dtype=t.dtype)
        return out

    def shards(leaves):
        return tree_map(lambda lf: torch.empty(lf.shard, dtype=lf.dtype), leaves)

    batch_bytes = sum(_nbytes(local[k], t.dtype) for k, t in in_specs.items())
    cache_split = False
    if shape.kind == "train":
        from repro_torch.train.train_step import init_train_state, make_train_step

        opt_specs = {"m": pspecs, "v": pspecs, "count": Spec()}
        if run.master_weights:
            opt_specs["master"] = pspecs
        sspecs = {"params": pspecs, "opt": opt_specs, "step": Spec()}
        if run.grad_compression == "int8":
            sspecs["error_fb"] = pspecs
        s_leaves = _leaves(
            sspecs, eval_shape(init_train_state, gen, cfg, run, api), eval_shape(init_train_state, gen, vcfg, run, api),
            mesh, "", ("data", "model"),
        )
        p_leaves = s_leaves["params"]  # the live parameters (bf16 under master_weights)
        # the model runs on gathered parameters, the optimizer on the shards
        fn = make_train_step(vcfg, run, _ShardedAPI(api, p_leaves), vrules)
        make_args = lambda: (shards(s_leaves), batch_view())  # noqa: E731
        arg_bytes = sum(lf.shard_bytes for lf in tree_leaves(s_leaves)) + batch_bytes
    else:
        cache_len = cache_len or shape.seq_len + 16
        cache_shape = eval_shape(lambda: api.init_cache(cfg, shape.global_batch, cache_len, device="meta"))
        cspecs = SH.sanitize_specs(SH.cache_specs(cfg, rules, cache_shape), cache_shape, mesh)
        kv = _kv_leaf(cache_shape)
        len_loc = SH.local_shape(tuple(kv.shape), _kv_leaf(cspecs), mesh)[2] if kv is not None else cache_len
        cache_split = kv is not None and len_loc < kv.shape[2]
        view_cache = eval_shape(lambda: api.init_cache(vcfg, B_loc, len_loc, device="meta"))
        # a cache keeps its batch shards; a ring (its length the window's,
        # not max_len's) is gathered over the cache's sequence axes too
        kv_axes = () if rules.kv_seq is None else (rules.kv_seq,) if isinstance(rules.kv_seq, str) else rules.kv_seq
        c_leaves = _leaves(cspecs, cache_shape, view_cache, mesh, "cache", ("model",) + tuple(kv_axes))
        arg_bytes = sum(lf.shard_bytes for lf in tree_leaves(p_leaves) + tree_leaves(c_leaves))
        sharded = _ShardedAPI(api, p_leaves)
        if shape.kind == "prefill":
            fn = lambda p, b, c: sharded.prefill(p, b, vcfg, vrules, c)  # noqa: E731
            make_args = lambda: (shards(p_leaves), batch_view(), _gathered(shards(c_leaves), c_leaves))  # noqa: E731
            arg_bytes += batch_bytes
        else:
            pos = shape.seq_len
            fn = lambda p, t, c: sharded.decode_step(p, t, vcfg, vrules, c, pos)  # noqa: E731
            make_args = lambda: (  # noqa: E731
                shards(p_leaves), batch_view()["tokens"], _gathered(shards(c_leaves), c_leaves),
            )
            arg_bytes += _nbytes(local["tokens"], in_specs["tokens"].dtype)
    coll = _collectives(cfg, shape, run, sizes, rules, sp, B_loc, S_loc, S, p_leaves, pspecs, cache_split)
    # a traced train step holds each parameter's gradient at the gathered
    # width, and one leaf's twice while its layers' gradients are stacked
    # (``common.unstack``'s backward); a sharded step keeps the shards
    over = [lf.view_bytes - lf.shard_bytes for lf in tree_leaves(p_leaves)] if shape.kind == "train" else [0]
    excess = sum(over) + max(over)
    return Traced(fn, make_args, arg_bytes, coll, excess, time.perf_counter() - t0), rules


def run_traced(traced: Traced, *, keep_ops: bool = False):
    """Trace ``traced`` once on fake tensors.  Returns (Trace, seconds)."""
    t0 = time.perf_counter()
    with FakeTensorMode():
        tr = trace(traced.fn, traced.make_args(), keep_ops=keep_ops)
    return tr, time.perf_counter() - t0


# ============================================================ collectives
def _collectives(cfg, shape, run, sizes, rules, sp, B_loc, S_loc, S, p_leaves, pspecs, cache_split) -> list:
    """The step's collectives, per device, from the sanitized specs and the
    per-device view:

    * each parameter's gather to its view (the FSDP all-gather; ``model``
      too under SP) in the forward, and again in the remat recompute for
      layer weights; in training the reduce-scatter of its gradient into
      the shard and the all-reduce over ``data`` where it is replicated
      there, a microbatch each, and one all-reduce over ``pod`` of the
      (float32-accumulated) shard a step;
    * the tensor-parallel all-reduce of each attention, MLP, MoE and
      shared-block output whose projection is split on ``model``, forward
      (and in training backward and recompute);
    * the MoE all-to-alls (dispatch and combine) of the dispatch buffer
      when experts are split on ``model``;
    * under SP, each attention layer's K/V all-gather (and in training
      the reduce-scatter of their gradients);
    * in decode over a cache split on its sequence, each attention
      layer's all-reduce of the partial outputs and their log-sum-exps.
    """
    out = []
    train = shape.kind == "train"
    A = run.grad_accum if train else 1
    tp = sizes.get("model", 1)
    act = torch.tensor([], dtype=cfg.dtype).element_size()
    B_mb = max(B_loc // A, 1)
    tokens = B_mb * (1 if shape.kind == "decode" else S_loc)
    remat = train and cfg.remat
    passes = A * (2 + remat) if train else 1  # forward, backward, recompute
    for lf in tree_leaves(p_leaves):
        layer_leaf = lf.path.split("/")[1].endswith("blocks")
        if lf.gathered:
            out.append(Collective("all-gather", lf.gathered, lf.view_bytes, A * (1 + (remat and layer_leaf)), lf.path))
        if not train:
            continue
        if lf.gathered:
            out.append(Collective("reduce-scatter", lf.gathered, lf.shard_bytes, A, lf.path))
        if sizes.get("data", 1) > 1 and "data" not in lf.gathered:
            out.append(Collective("all-reduce", ("data",), lf.shard_bytes, A, lf.path))
        if sizes.get("pod", 1) > 1:
            acc = 4 * math.prod(lf.shard) if A > 1 else lf.shard_bytes
            out.append(Collective("all-reduce", ("pod",), acc, 1, lf.path))

    split = functools.partial(_split, pspecs)
    d = cfg.d_model
    L = cfg.num_layers
    if tp > 1 and not sp:
        n_ar = 0
        attn_split = split(("attn", "wo"), -3) or split(("self_attn", "wo"), -3)
        if cfg.family == "encdec":
            enc_tok = B_mb * cfg.encoder_seq_len
            enc = cfg.encoder_layers * (attn_split + split(("mlp", "wo"), -2))
            if shape.kind != "decode" and enc:
                out.append(Collective("all-reduce", ("model",), enc_tok * d * act, enc * passes, "encoder outputs"))
            n_ar = L * (2 * attn_split + split(("mlp", "wo"), -2))
        elif cfg.family != "ssm" and not cfg.is_hybrid:
            ffn = split(("moe", "wo"), -2) or split(("moe", "shared_wo"), -2) if cfg.is_moe else split(("mlp", "wo"), -2)
            n_ar = L * (attn_split + ffn)
        if cfg.is_hybrid:
            periods = L // cfg.hybrid_period
            n = periods * (split(("shared", "attn", "wo"), -3) + split(("shared", "mlp", "wo"), -2))
            if n:
                out.append(Collective("all-reduce", ("model",), tokens * d * act, n * (2 * A if train else 1),
                                      "shared block outputs"))
        if n_ar:
            out.append(Collective("all-reduce", ("model",), tokens * d * act, n_ar * passes, "block outputs"))
    if cfg.is_moe and tp > 1 and split(("moe", "wi"), -3):
        m = cfg.moe
        cap = MOE.capacity(tokens * m.num_experts_per_tok, cfg)
        buf = m.num_experts * cap * d * act
        out.append(Collective("all-to-all", ("model",), buf, 2 * L * passes, "MoE dispatch and combine"))
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        attn_layers = 0
    elif cfg.is_hybrid:
        attn_layers = L // cfg.hybrid_period
    else:
        attn_layers = L
    if cfg.mla.kv_lora_rank:
        a = cfg.mla
        kv_width = cfg.num_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim + a.v_head_dim)
        o_width = cfg.num_heads * a.v_head_dim
    else:
        kv_width = 2 * cfg.num_kv_heads * hd
        o_width = cfg.num_heads * hd
    if sp and attn_layers and shape.kind != "decode":
        full = B_mb * S * kv_width * act
        again = A * (1 + remat) if train else 1
        out.append(Collective("all-gather", ("model",), full, attn_layers * again, "K/V under SP"))
        if train:
            out.append(Collective("reduce-scatter", ("model",), full // tp, attn_layers * A, "dK/dV under SP"))
    if shape.kind == "decode" and attn_layers and cache_split:
        axes = (rules.kv_seq,) if isinstance(rules.kv_seq, str) else tuple(rules.kv_seq)
        partial = B_mb * (o_width + cfg.num_heads) * 4  # float32 outputs and log-sum-exps
        out.append(Collective("all-reduce", axes, partial, attn_layers, "partial attention over the cache's shards"))
    return out


# ============================================================ calibration
def _measure(cfg, shape, mesh, run, *, sink=None):
    """Trace a (small) variant and pull raw per-device cost numbers;
    ``sink`` (a list) gets the variant's (Traced, Trace, seconds)."""
    traced, _ = build_traced(cfg, shape, mesh, run)
    tr, secs = run_traced(traced)
    if sink is not None:
        sink.append((traced, tr, secs))
    coll = collective_bytes(traced.collectives)
    return {
        "flops": tr.flops,
        "bytes": tr.bytes,
        "coll_intra": float(coll["intra_pod"]),
        "coll_inter": float(coll["inter_pod"]),
    }


def _combine(base, per_layer, n_extra, mult=1.0):
    return {k: max(0.0, mult * (base[k] + n_extra * per_layer[k])) for k in base}


def calibrated_costs(arch, cfg, shape, mesh, *, a_eff, run_kw=None, sink=None):
    """Per-step per-device costs from small variants, the reference's
    algebra exactly.

    The reference needs it because XLA's cost_analysis counts a while-loop
    body once; an eager trace counts every layer, so here it extrapolates
    from L1- and L2-layer variants (and an A=2 microbatch variant for
    train) what a full-depth trace would count:

        per_layer = (X(L2) − X(L1)) / (L2 − L1)
        train:  per_step = 2·X(L1,A1) − X(L1,A2);  per_mb = X(L1,A2) − X(L1,A1)
                total = per_step + A·(per_mb + (L−L1)·per_layer)
        serve:  total = X(L1) + (L − L1)·per_layer
    """
    period = _layer_period(cfg)
    L1, L2 = period, 2 * period
    # fractional period units so non-multiple depths (gemma3: 34 = 5×6+4)
    # extrapolate exactly by layer count
    extra_units = (cfg.num_layers - L1) / period
    c1 = _scaled_cfg(cfg, L1, scan=False)
    c2 = _scaled_cfg(cfg, L2, scan=False)
    run_kw = dict(run_kw or {})
    run_kw.pop("_grad_specs", None)  # gradients already reduce-scatter into their shards
    if shape.kind == "train":
        mb = shape.global_batch // a_eff
        sh1 = dataclasses.replace(shape, global_batch=mb)
        sh2 = dataclasses.replace(shape, global_batch=2 * mb)
        run1 = RunConfig(model=c1, shape=sh1, grad_accum=1, **run_kw)
        runA = RunConfig(model=c1, shape=sh2, grad_accum=2, grad_accum_unroll=True, **run_kw)
        x1 = _measure(c1, sh1, mesh, run1, sink=sink)
        x2 = _measure(c2, sh1, mesh, RunConfig(model=c2, shape=sh1, grad_accum=1, **run_kw), sink=sink)
        xa = _measure(c1, sh2, mesh, runA, sink=sink)
        per_layer = {k: (x2[k] - x1[k]) / (L2 - L1) * period for k in x1}
        per_step = {k: max(0.0, 2 * x1[k] - xa[k]) for k in x1}
        per_mb = {k: max(0.0, xa[k] - x1[k]) for k in x1}
        total = {k: per_step[k] + a_eff * (per_mb[k] + extra_units * per_layer[k]) for k in x1}
        return total, {"L1": L1, "L2": L2, "a_eff": a_eff, "x1": x1, "x2": x2, "xa": xa}
    x1 = _measure(c1, shape, mesh, RunConfig(model=c1, shape=shape, **run_kw), sink=sink)
    x2 = _measure(c2, shape, mesh, RunConfig(model=c2, shape=shape, **run_kw), sink=sink)
    per_layer = {k: (x2[k] - x1[k]) / (L2 - L1) * period for k in x1}
    total = _combine(x1, per_layer, extra_units)
    return total, {"L1": L1, "L2": L2, "x1": x1, "x2": x2}


# ================================================================= orchestration
def _lv_moefix(cfg, run_kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_sharded=True)), run_kw


def _lv_moesm(cfg, run_kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="shard_map")), run_kw


LEVERS = {
    # §Perf levers: name → fn(cfg, run_kw) -> (cfg', run_kw')
    "bf16mm": lambda c, r: (c.replace(attn_matmul_bf16=True), r),
    "inscan": lambda c, r: (c.replace(prefill_inscan_cache=True), r),
    "master": lambda c, r: (c, {**r, "master_weights": True}),
    "chunk4k": lambda c, r: (c.replace(attn_chunk=4096), r),
    "moefix": _lv_moefix,
    "moesm": _lv_moesm,
    "wincache": lambda c, r: (c.replace(decode_window_cache=True), r),
    "gradrs": lambda c, r: (c, {**r, "_grad_specs": True}),
    "accum8": lambda c, r: (c, {**r, "_grad_accum": 8}),
    # revert production defaults to the paper-faithful baseline
    "paperbase": lambda c, r: (
        c.replace(
            decode_window_cache=False,
            moe=dataclasses.replace(c.moe, dispatch="sorted", dispatch_sharded=False) if c.moe.num_experts else c.moe,
        ),
        r,
    ),
}


def _extrapolated_memory(mems: list, argument_bytes: int, units: float, a_eff: int) -> dict:
    """The full config's memory from the variants' (x1, x2[, xa]), as the
    costs are: a period of layers adds (x2 − x1) to temp, outputs and
    aliases; more than one microbatch adds (xa − x1) to temp once (the
    accumulation buffers)."""
    def at(key):
        v = mems[0][key] + units * (mems[1][key] - mems[0][key])
        if key == "temp_bytes" and a_eff > 1 and len(mems) > 2:
            v += mems[2][key] - mems[0][key]
        return int(max(0, round(v)))

    out, temp, alias = at("output_bytes"), at("temp_bytes"), at("alias_bytes")
    return {
        "argument_bytes": argument_bytes,
        "output_bytes": out,
        "temp_bytes": temp,
        "alias_bytes": alias,
        "total_bytes": argument_bytes + out + temp - alias,
        "gathered_gradient_bytes": at("gathered_gradient_bytes"),
    }


def predict(arch: str, cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, *, run_kw=None, hw: HW = H100,
            calibrate: bool = True, full_trace: bool = False, grad_accum=None, cache_len=None) -> dict:
    """The dry-run record of ``cfg`` at ``shape`` on ``mesh``: rules,
    per-device memory, a raw roofline and, with ``calibrate``, the
    calibrated one.

    ``full_trace`` (or no calibration) traces the whole config once:
    memory and the raw roofline from that trace.  Otherwise memory is
    extrapolated from the calibration's variants and the raw roofline is
    the first variant's (one period of layers, one microbatch: what the
    reference's compile counts with its scan body once); the record's
    ``calibration.memory`` says which.  ``grad_accum`` caps the
    microbatches (default ``GRAD_ACCUM[arch]``); ``cache_len`` sizes a
    serving cache (default ``seq_len + 16``)."""
    run_kw = dict(run_kw or {})
    sizes = SH.mesh_axis_sizes(mesh)
    ndev = mesh.size
    batch_shards = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    a_eff = 1
    a_cap = run_kw.pop("_grad_accum", GRAD_ACCUM.get(arch, 1) if grad_accum is None else grad_accum)
    if shape.kind == "train":
        a_eff = max(1, min(a_cap, shape.global_batch // batch_shards))
    run = RunConfig(model=cfg, shape=shape, grad_accum=a_eff, **{k: v for k, v in run_kw.items() if k != "_grad_specs"})

    # ---- the full config's shapes: proves sharding coherence, gives the
    # arguments and collectives exactly
    traced, rules = build_traced(cfg, shape, mesh, run, cache_len=cache_len)
    trace_s = 0.0
    raw = mem = None
    if full_trace or not calibrate:
        tr, trace_s = run_traced(traced)
        mem = traced.memory(tr)
        raw = roofline_from_trace(tr, collective_bytes(traced.collectives), mem, num_devices=ndev, hw=hw)

    rec = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "multi" if "pod" in mesh.axis_names else "single",
        "mesh_shape": list(mesh.shape),
        "hw": hw.name,
        "devices": ndev,
        "grad_accum": a_eff,
        "lower_s": round(traced.build_s, 1),
        "compile_s": 0.0,
        "rules": {
            "batch": rules.batch,
            "heads": None if rules.heads is None else "tp",
            "seq": rules.seq,
            "kv_seq": rules.kv_seq,
        },
    }

    # ---- calibrated roofline (true per-step costs)
    if calibrate:
        variants = []
        total, detail = calibrated_costs(arch, cfg, shape, mesh, a_eff=a_eff, run_kw=run_kw, sink=variants)
        trace_s += sum(v[2] for v in variants)
        if mem is None:
            units = (cfg.num_layers - detail["L1"]) / _layer_period(cfg)
            mem = _extrapolated_memory([v[0].memory(v[1]) for v in variants], traced.argument_bytes, units, a_eff)
            t1, tr1 = variants[0][0], variants[0][1]
            raw = roofline_from_trace(tr1, collective_bytes(t1.collectives), t1.memory(tr1), num_devices=ndev, hw=hw)
            detail["memory"] = "extrapolated from the variants"
        else:
            detail["memory"] = "traced at full depth"
        t_compute = total["flops"] / hw.peak_bf16_flops
        t_memory = total["bytes"] / hw.hbm_bw
        t_coll = total["coll_intra"] / hw.ici_bw + total["coll_inter"] / hw.inter_pod_bw
        terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
        mf = model_flops_for(cfg, shape)
        bound = max(terms.values())
        rec["roofline"] = {
            "flops_per_device": total["flops"],
            "bytes_per_device": total["bytes"],
            "coll_intra_bytes": total["coll_intra"],
            "coll_inter_bytes": total["coll_inter"],
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "dominant": max(terms, key=terms.get),
            "bound_time_s": bound,
            "model_flops": mf,
            "useful_flops_ratio": mf / (total["flops"] * ndev) if total["flops"] else 0.0,
            "roofline_fraction": (mf / ndev / hw.peak_bf16_flops) / bound if bound > 0 else 0.0,
            "calibration": detail,
        }
    rec["compile_s"] = round(trace_s, 1)
    rec["memory_analysis"] = mem
    rec["raw_roofline_scanbody_once"] = raw
    return rec


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, calibrate=True, levers: tuple = (),
               mesh: MeshSpec | None = None, hw: HW = H100, smoke: bool = False) -> dict:
    """One registry cell on ``mesh`` (default the production mesh);
    ``smoke`` takes the arch's smoke config."""
    cfg = registry.get_config(arch, smoke=smoke)
    run_kw = {}
    for lv in levers:
        cfg, run_kw = LEVERS[lv](cfg, run_kw)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    return predict(arch, cfg, SHAPES[shape_name], mesh, run_kw=run_kw, hw=hw, calibrate=calibrate)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--levers", default="", help="comma list: " + ",".join(LEVERS))
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--hw", default="h100", choices=sorted(RECORDS), help="the record the roofline divides by")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configs (tests)")
    args = ap.parse_args(argv)
    levers = tuple(x for x in args.levers.split(",") if x)
    hw = RECORDS[args.hw]

    archs = [args.arch] if args.arch else list(registry.ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_ok, failures = 0, []
    t_all = time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            ok, why = registry.cell_supported(arch, shape_name)
            if not ok:
                print(f"SKIP  {arch} × {shape_name}: {why}")
                continue
            for multi in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"CACHED {tag}")
                    n_ok += 1
                    continue
                print(f"RUN   {tag} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape_name, multi_pod=multi, calibrate=not args.no_calibrate,
                                     levers=levers, hw=hw, smoke=args.smoke)
                    if levers:
                        rec["levers"] = list(levers)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    line = (
                        f"  OK trace={rec['compile_s']}s "
                        f"hbm={rec['memory_analysis']['total_bytes']/1e9:.2f}GB/dev"
                    )
                    if "roofline" in rec:
                        r = rec["roofline"]
                        line += (
                            f" dominant={r['dominant']}"
                            f" compute={r['t_compute_s']:.2e}s"
                            f" mem={r['t_memory_s']:.2e}s"
                            f" coll={r['t_collective_s']:.2e}s"
                            f" roofline_frac={r['roofline_fraction']:.3f}"
                        )
                    print(line, flush=True)
                    n_ok += 1
                except Exception as e:  # a failing cell is recorded and the grid goes on
                    failures.append((tag, repr(e)))
                    with open(os.path.join(args.out, tag + ".FAIL"), "w") as f:
                        f.write(traceback.format_exc())
                    print(f"  FAIL {e!r}", flush=True)
    print(f"\n{n_ok} ok, {len(failures)} failed in {time.perf_counter() - t_all:.1f} s")
    print(f"kernel launches: {json.dumps(launch_counts())}")
    for tag, err in failures:
        print("  FAIL", tag, err[:160])
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
