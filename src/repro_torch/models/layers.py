"""Norms, MLPs, embeddings.

The port's copy of ``repro.models.layers``.  Each ``init_*`` takes a
``torch.Generator`` (the parameters are made on its device) and an
optional ``lead`` of stacked layer axes; each ``*_specs`` gives the
logical ``Spec`` of every leaf, which ``resolve_specs`` maps onto mesh
axes.  Weights are kept in
``cfg.param_dtype`` and cast to ``cfg.dtype`` where they are used, as in
the reference; ``embed_tokens`` gathers the rows first and casts them
after, which gives the same values without casting the whole table.

Under a mesh (``common.set_mesh``) the embedding, the MLP and the unembed
each run as one ``common.region`` on DTensors: the embedding gathers its
table whole (the index is data-dependent) and each rank looks up its own
tokens; the MLP's weights are gathered over FSDP and keep their
tensor-parallel split, so its output is a partial sum over the tensor
axis, reduced by ``shard`` before the output bias (where the tensor axis
splits the sequence instead, SP, they are taken whole); the unembed leaves the
logits split over the vocabulary, or, where the sequence is split over
the tensor axis (SP), over the sequence with the vocabulary whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    AxisRules,
    Spec,
    axes_of,
    const_init,
    is_dtensor,
    dense_init,
    local_rules,
    mesh_for,
    on_tensor_axis,
    region,
    shard,
    spec_map,
    tp_region,
    tp_spec,
)


# ------------------------------------------------------------------- norms
def init_norm(d: int, cfg, device, *, lead: tuple[int, ...] = ()) -> dict:
    p = {"scale": const_init(1.0, (d,), cfg.param_dtype, device, lead=lead)}
    if cfg.norm == "layernorm":
        p["bias"] = const_init(0.0, (d,), cfg.param_dtype, device, lead=lead)
    return p


def norm_specs(cfg) -> dict:
    s = {"scale": Spec(None)}
    if cfg.norm == "layernorm":
        s["bias"] = Spec(None)
    return s


def apply_norm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last dim, in float32.  On a DTensor
    (under a mesh), one region on each rank's rows, the scale and bias
    taken in float32 before it (their gradients are summed over the ranks
    in float32, as the reference's)."""
    if is_dtensor(x):
        keys = list(p)
        spec = axes_of(x, x.device_mesh)
        return region(lambda x, *w: _norm(dict(zip(keys, w)), x, cfg), (x, *(p[k].to(torch.float32) for k in keys)),
                      (spec, *(Spec(),) * len(keys)), (spec,), mesh=x.device_mesh)
    return _norm(p, x, cfg)


def _norm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p["scale"]
    return out.to(x.dtype)


def rms_norm_head(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head QK-norm (gemma3): RMS over head_dim."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


# -------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, d: int, d_ff: int, cfg, *, lead: tuple[int, ...] = ()) -> dict:
    pd = cfg.param_dtype
    if cfg.act == "silu":  # SwiGLU
        return {
            "wi": dense_init(gen, (d, d_ff), 0, pd, lead=lead),
            "wg": dense_init(gen, (d, d_ff), 0, pd, lead=lead),
            "wo": dense_init(gen, (d_ff, d), 0, pd, lead=lead),
        }
    return {
        "wi": dense_init(gen, (d, d_ff), 0, pd, lead=lead),
        "wo": dense_init(gen, (d_ff, d), 0, pd, lead=lead),
        "bi": const_init(0.0, (d_ff,), pd, gen.device, lead=lead),
        "bo": const_init(0.0, (d,), pd, gen.device, lead=lead),
    }


def _mlp_core(p: dict, x: torch.Tensor, cfg, rules: AxisRules) -> torch.Tensor:
    """The MLP up to its output bias."""
    dt = cfg.dtype
    if cfg.act == "silu":
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt))
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
        h = F.silu(g) * h
    else:
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt)) + p["bi"].to(dt)
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    h = shard(h, rules, "batch", "seq", "tensor")
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))


def apply_mlp(p: dict, x: torch.Tensor, cfg, rules: AxisRules) -> torch.Tensor:
    mesh = mesh_for(rules)
    if mesh is None:
        out = _mlp_core(p, x, cfg, rules)
    else:
        keys = [k for k in ("wi", "wg", "wo", "bi") if k in p]
        out = tp_region(lambda x, *w: _mlp_core(dict(zip(keys, w)), x, cfg, local_rules(rules)),
                        x, [p[k].to(cfg.dtype) for k in keys], rules, mesh)
        out = shard(out, rules, "batch", "seq", None)
    if cfg.act != "silu":
        out = out + p["bo"].to(cfg.dtype)
    return out


def mlp_specs(cfg) -> dict:
    if cfg.act == "silu":
        return {"wi": Spec("fsdp", "tensor"), "wg": Spec("fsdp", "tensor"), "wo": Spec("tensor", "fsdp")}
    return {"wi": Spec("fsdp", "tensor"), "wo": Spec("tensor", "fsdp"), "bi": Spec("tensor"), "bo": Spec(None)}


# -------------------------------------------------------------- embeddings
def init_embedding(gen: torch.Generator, cfg) -> dict:
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), 1, cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), 0, cfg.param_dtype)
    return p


def embed_tokens(p: dict, tokens: torch.Tensor, cfg, rules: AxisRules) -> torch.Tensor:
    mesh = mesh_for(rules)
    if mesh is None:
        x = p["embed"][tokens].to(cfg.dtype)
    else:
        # a data-dependent row gather: the table is gathered whole, in the
        # wider of its dtype and the compute dtype (the same rows), so its
        # gradient is summed over the ranks before it is rounded; without
        # autograd, in the compute dtype (the same rows, fewer bytes)
        wide = torch.promote_types(p["embed"].dtype, cfg.dtype) if torch.is_grad_enabled() else cfg.dtype
        table = p["embed"].to(wide)
        x = region(lambda table, tok: table[tok].to(cfg.dtype), (table, tokens),
                   (Spec(), rules.spec("batch", None)), (rules.spec("batch", None, None),), mesh=mesh)
    return shard(x, rules, "batch", "seq", None)


def _unembed_core(w, x, cfg, tied: bool) -> torch.Tensor:
    return torch.einsum("bsd,dv->bsv", x, (w.T if tied else w).to(cfg.dtype))


def unembed(p: dict, x: torch.Tensor, cfg, rules: AxisRules) -> torch.Tensor:
    w = p.get("unembed")
    tied = w is None
    if tied:
        w = p["embed"]
    mesh = mesh_for(rules)
    if mesh is None:
        logits = _unembed_core(w, x, cfg, tied)
    else:
        xs = axes_of(x, mesh)
        # under SP the sequence holds the tensor axis, so the vocab stays
        # whole (the reference's spec keeps an axis's first use only)
        on_seq = xs[1] is not None and xs[1] == rules.tensor
        split = on_tensor_axis(w, rules, mesh) and not on_seq
        logits = region(lambda w, x: _unembed_core(w, x, cfg, tied), (w.to(cfg.dtype), x),
                        (tp_spec(w, rules, mesh) if split else Spec(), xs),
                        (Spec(*xs[:2], rules.tensor if split else None),), mesh=mesh)
    return shard(logits, rules, "batch", "seq", "tensor")


def embedding_specs(cfg) -> dict:
    s = {"embed": Spec("tensor", "fsdp")}
    if not cfg.tie_embeddings:
        s["unembed"] = Spec("fsdp", "tensor")
    return s


def resolve_specs(tree, rules: AxisRules):
    """Map logical-name ``Spec``s → mesh-axis ``Spec``s."""
    return spec_map(lambda s: rules.spec(*s), tree)
