"""Sharding-spec assembly for the dry-run.

The port's copy of ``repro.launch.sharding``.  Everything here operates on
*logical* ``Spec``s (axis names) plus a ``MeshSpec``:

* ``sanitize_specs``: drop mesh axes that don't divide the corresponding
  array dim (e.g. whisper's vocab 51865 on a 16-way tensor axis, or
  qwen1.5-32b's 40 heads).  The dropped axes simply mean that tensor is
  replicated on that axis;
* per-(arch × shape) ``AxisRules``: batch axes, FSDP, TP, and the special
  cases: SP (sequence sharding) for head counts indivisible by TP, and
  ``kv_seq`` sharding for the batch=1 ``long_500k`` decode cache.

The mesh is a ``MeshSpec`` (shapes only, the dry-run) or a
``DeviceMesh`` over ranks (a real run).  ``named`` (the reference's
``NamedSharding``s) gives a spec tree's DTensor placements on a
``DeviceMesh``; ``local_shape`` and ``shard_factor`` give one device's
share of a tensor under a spec, which the dry-run's byte counts use.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models.common import AxisRules, Spec, placements, spec_map


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """Axis name → size of a ``MeshSpec`` or a ``DeviceMesh``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.shape))


def named(spec_tree, mesh):
    """The DTensor placements of every ``Spec`` of a tree on the
    ``DeviceMesh`` ``mesh``: the reference's ``NamedSharding`` tree."""
    return spec_map(lambda s: placements(s, mesh), spec_tree)


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> AxisRules:
    sizes = mesh_axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    tp = sizes.get("model", 1)
    heads = "_default"  # resolves to the tensor axis
    seq = None
    # SP fallback: if H or KV heads don't divide the TP axis, shard the
    # sequence dim of activations instead (context parallelism).
    if cfg.num_heads % tp or (cfg.num_kv_heads and cfg.num_kv_heads % tp):
        heads = None
        if shape.seq_len % tp == 0 and shape.kind != "decode":
            seq = "model"
    kv_seq = None
    if shape.kind in ("decode", "prefill"):
        # KV heads that don't divide TP would replicate the cache across the
        # model axis — shard the cache's seq dim there instead.
        if cfg.num_kv_heads and cfg.num_kv_heads % tp:
            kv_seq = "model"
    if shape.kind == "decode":
        # global batch must cover the batch axes; if not, shard the cache's
        # sequence dim over the leftover axes (long_500k: batch=1).
        bsz = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
        if shape.global_batch % bsz or shape.global_batch < bsz:
            batch_axes = ()
            kv_seq = ("data", "model") if cfg.num_kv_heads % tp else "data"
    return AxisRules(batch=batch_axes or None, fsdp="data", tensor="model", heads=heads, seq=seq, kv_seq=kv_seq)


# ---------------------------------------------------------------- sanitize
def _axis_size(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(sizes.get(e, 1) for e in entry)
    return sizes.get(entry, 1)


def _dims(arr) -> tuple[int, ...]:
    return tuple(arr.shape) if hasattr(arr, "shape") else tuple(arr)


def sanitize_specs(spec_tree, shaped_tree, mesh):
    """Drop spec axes that don't evenly divide the array dims.  The leaves
    of ``shaped_tree`` are tensors or shape tuples."""
    sizes = mesh_axis_sizes(mesh)

    def fix(spec, arr):
        shape = _dims(arr)
        entries = tuple(spec) + (None,) * (len(shape) - len(spec))
        return Spec(*(e if e and d % _axis_size(e, sizes) == 0 else None for d, e in zip(shape, entries)))

    return spec_map(fix, spec_tree, shaped_tree)


def shard_factor(spec: Spec, mesh: MeshSpec) -> int:
    """Into how many pieces ``spec`` cuts a tensor on ``mesh``."""
    sizes = mesh_axis_sizes(mesh)
    return math.prod(_axis_size(e, sizes) for e in spec)


def local_shape(shape, spec: Spec, mesh: MeshSpec) -> tuple[int, ...]:
    """One device's share of a tensor of ``shape`` under a sanitized
    ``spec`` (each dim divided by its entry's axes)."""
    sizes = mesh_axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, entries):
        n = _axis_size(e, sizes)
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {e!r} ({n}): sanitize the spec first")
        out.append(d // n)
    return tuple(out)


# --------------------------------------------------------------- batch spec
def batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: AxisRules) -> dict:
    b = rules.batch
    specs = {"tokens": Spec(b, None)}
    if shape.kind == "train":
        specs["labels"] = Spec(b, None)
    if cfg.family == "encdec":
        specs["enc_frames"] = Spec(b, None, None)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vision_embeds"] = Spec(b, None, None)
        specs["positions_thw"] = Spec(None, b, None)
    return specs


# --------------------------------------------------------------- cache spec
def cache_specs(cfg: ModelConfig, rules: AxisRules, cache_shapes) -> dict:
    """Spec tree matching the model's cache tree.

    GQA KV: (L, B, S, KV, hd) → (None, batch, kv_seq, heads, None)
    MLA latent: c (L,B,S,r), kr (L,B,S,dr) → (None, batch, kv_seq, None)
    SSM: conv (L,B,W,C) → (None, batch, None, tensor);
         ssm (L,B,nh,hd,ds) → (None, batch, tensor, None, None)
    hybrid adds shared (periods, B, S, KV, hd).
    """
    r = rules

    def kv5():
        return r.spec(None, "batch", "kv_seq", "heads", None)

    if cfg.family == "ssm" or cfg.is_hybrid:
        specs = {"layers": {"conv": r.spec(None, "batch", None, "tensor"), "ssm": r.spec(None, "batch", "tensor", None, None)}}
        if cfg.is_hybrid:
            specs["shared"] = (kv5(), kv5())
        return specs
    if cfg.mla.kv_lora_rank:
        return {"layers": {"c": r.spec(None, "batch", "kv_seq", None), "kr": r.spec(None, "batch", "kv_seq", None)}}
    if cfg.family == "encdec":
        return {"self": (kv5(), kv5()), "cross": (kv5(), kv5())}
    if cfg.decode_window_cache:
        # ring cache: (L, B, ring, KV, hd) ×2 + (L, ring) positions
        return {"layers": (kv5(), kv5(), Spec(None, None))}
    return {"layers": (kv5(), kv5())}


# --------------------------------------------------------------- train specs
def train_specs(cfg: ModelConfig, shape: ShapeConfig, run, mesh, params, rules: "AxisRules | None" = None):
    """(rules, state specs, batch specs) of a training run on ``mesh``, as
    the reference's launcher builds them for ``jit_train_step``: the
    sanitized parameter specs, AdamW's moments (and the float32 master)
    like their parameters, the int8 error feedback likewise, the step and
    the count replicated.  The leaves of ``params`` are tensors or shape
    tuples.  ``rules`` defaults to ``rules_for``'s (a caller may give
    another mesh's, e.g. the production mesh's sequence parallelism on a
    smaller one)."""
    from repro_torch.optim.adamw import opt_state_specs

    rules = rules_for(cfg, shape, mesh) if rules is None else rules
    pspecs = param_layout(cfg, rules, mesh, params)
    opt = opt_state_specs(pspecs)
    if run.master_weights:
        opt["master"] = pspecs
    sspecs = {"params": pspecs, "opt": opt, "step": Spec()}
    if run.grad_compression == "int8":
        sspecs["error_fb"] = pspecs
    from repro_torch.configs.registry import input_specs

    return rules, sspecs, sanitize_specs(batch_specs(cfg, shape, rules), input_specs(cfg, shape), mesh)


# --------------------------------------------------------------- serve specs
def serve_layout(cfg: ModelConfig, rules: AxisRules, mesh, params, batch: dict, cache):
    """(parameter specs, batch specs, cache specs) of a prefill or decode
    call on ``mesh`` under ``rules``, each sanitized against its leaves'
    shapes: the reference's ``in_shardings`` for both, and the cache's
    ``out_shardings`` (``dryrun.build_lowered``).  Every leaf of the
    call's ``batch`` gets ``batch_specs``' rows (the tokens, the encoder
    frames, the vision embeddings and their (3, B, S) positions); a
    decode's batch holds the tokens alone, so the vision inputs go into
    prefill only, as the reference's ``kind != "decode"`` rule has it.
    The leaves are tensors (plain, DTensor or meta) or shape tuples."""
    specs = batch_specs(cfg, ShapeConfig("serve", 1, 1, "prefill"), rules)
    bspecs = sanitize_specs({k: specs[k] for k in batch}, batch, mesh)
    return param_layout(cfg, rules, mesh, params), bspecs, sanitize_specs(cache_specs(cfg, rules, cache), cache, mesh)


def param_layout(cfg: ModelConfig, rules: AxisRules, mesh, params):
    """The model's ``param_specs`` under ``rules``, sanitized against
    ``params``' shapes on ``mesh``."""
    from repro_torch.configs.registry import get_model_api

    tp = mesh_axis_sizes(mesh).get("model", 1)
    return sanitize_specs(get_model_api(cfg).param_specs(cfg, rules, tp), params, mesh)
