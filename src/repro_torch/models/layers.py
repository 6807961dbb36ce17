"""Norms, MLPs, embeddings.

The port's copy of ``repro.models.layers``.  Each ``init_*`` takes a
``torch.Generator`` (the parameters are made on its device) and an
optional ``lead`` of stacked layer axes; each ``*_specs`` gives the
logical ``Spec`` of every leaf, which ``resolve_specs`` maps onto mesh
axes.  Weights are kept in
``cfg.param_dtype`` and cast to ``cfg.dtype`` where they are used, as in
the reference; ``embed_tokens`` gathers the rows first and casts them
after, which gives the same values without casting the whole table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import AxisRules, Spec, const_init, dense_init, shard, spec_map


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


def apply_mlp(p: dict, x: torch.Tensor, cfg, rules: AxisRules) -> torch.Tensor:
    dt = cfg.dtype
    if cfg.act == "silu":
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt))
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
        h = F.silu(g) * h
    else:
        h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt)) + p["bi"].to(dt)
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    h = shard(h, rules, "batch", "seq", "tensor")
    out = torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))
    if cfg.act != "silu":
        out = out + p["bo"].to(dt)
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
    x = p["embed"][tokens].to(cfg.dtype)
    return shard(x, rules, "batch", "seq", None)


def unembed(p: dict, x: torch.Tensor, cfg, rules: AxisRules) -> torch.Tensor:
    w = p.get("unembed")
    if w is None:
        w = p["embed"].T
    logits = torch.einsum("bsd,dv->bsv", x, w.to(cfg.dtype))
    return shard(logits, rules, "batch", "seq", "tensor")


def embedding_specs(cfg) -> dict:
    s = {"embed": Spec("tensor", "fsdp")}
    if not cfg.tie_embeddings:
        s["unembed"] = Spec("fsdp", "tensor")
    return s


def resolve_specs(tree, rules: AxisRules):
    """Map logical-name ``Spec``s → mesh-axis ``Spec``s."""
    return spec_map(lambda s: rules.spec(*s), tree)
