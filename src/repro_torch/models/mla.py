"""DeepSeek-V2 Multi-head Latent Attention (MLA).

The port's copy of ``repro.models.mla``.  KV state is compressed into a
per-token latent ``c = x·W_dkv`` of rank ``kv_lora_rank`` (512) plus one
shared RoPE key ``k_r`` (64): the decode cache holds only (c, k_r), 576
dims a token.

Two decode paths:
* expanded (the baseline): reconstruct per-head k_nope = c·W_uk and
  v = c·W_uv for every cached position each step;
* absorbed (``cfg.mla.absorb``): fold W_uk into the query and attend over
  the latent directly, then fold W_uv into the output.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import attention, attention_with_lse
from repro_torch.models.common import AxisRules, Spec, dense_init, gather_seq, local_rules, mesh_for, put, shard, tp_region
from repro_torch.models.rope import apply_rope


def init_mla(gen: torch.Generator, cfg, *, lead: tuple[int, ...] = ()) -> dict:
    a = cfg.mla
    d, H, pd = cfg.d_model, cfg.num_heads, cfg.param_dtype
    r, dn, dr, dv = a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim
    return {
        "wq": dense_init(gen, (d, H, dn + dr), 0, pd, lead=lead),
        "wdkv": dense_init(gen, (d, r), 0, pd, lead=lead),
        "wkr": dense_init(gen, (d, dr), 0, pd, lead=lead),
        "wuk": dense_init(gen, (r, H, dn), 0, pd, lead=lead),
        "wuv": dense_init(gen, (r, H, dv), 0, pd, lead=lead),
        "wo": dense_init(gen, (H, dv, d), (0, 1), pd, lead=lead),
    }


def mla_specs(cfg) -> dict:
    return {
        "wq": Spec("fsdp", "tensor", None),
        "wdkv": Spec("fsdp", None),
        "wkr": Spec("fsdp", None),
        "wuk": Spec(None, "tensor", None),
        "wuv": Spec(None, "tensor", None),
        "wo": Spec("tensor", None, "fsdp"),
    }


def _project_q(p, x, cfg, positions):
    dn = cfg.mla.qk_nope_head_dim
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(cfg.dtype))
    qn, qr = q[..., :dn], q[..., dn:]
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _latent(p, x, cfg, positions):
    c = torch.einsum("bsd,dr->bsr", x, p["wdkv"].to(cfg.dtype))
    kr = torch.einsum("bsd,de->bse", x, p["wkr"].to(cfg.dtype))
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, kr


def _expand(p, c, kr, cfg):
    """Per-head keys (nope part from the latent, the shared rope key) and
    values for every position of the latent."""
    kn = torch.einsum("bsr,rhe->bshe", c, p["wuk"].to(cfg.dtype))
    v = torch.einsum("bsr,rhe->bshe", c, p["wuv"].to(cfg.dtype))
    k = torch.cat([kn, kr[:, :, None].expand(*kn.shape[:3], kr.shape[-1])], -1)
    return k, v


def _scale(cfg) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_attention(p, x, cfg, rules: AxisRules, *, positions, chunk=1024):
    """Training/prefill forward.  Returns (out, (c, kr)): the latent for caching.

    Under a mesh (training only), one ``tp_region``: each rank builds the
    latent for its batch rows (``wdkv``/``wkr`` are not split over the
    tensor axis) and attends over its heads; the output projection's
    partial sums are reduced by ``shard``."""
    mesh = mesh_for(rules)
    if mesh is not None:
        keys = list(p)
        body = lambda x, *w: _mla_core(dict(zip(keys, w)), x, cfg, local_rules(rules), positions, chunk)[0]  # noqa: E731
        out = tp_region(body, x, [p[k].to(cfg.dtype) for k in keys], rules, mesh)
        return shard(out, rules, "batch", "seq", None), None
    out, latent = _mla_core(p, x, cfg, rules, positions, chunk)
    return shard(out, rules, "batch", "seq", None), latent


def _mla_core(p, x, cfg, rules, positions, chunk):
    qn, qr = _project_q(p, x, cfg, positions)
    c, kr = _latent(p, x, cfg, positions)
    k, v = _expand(p, c, kr, cfg)
    q = torch.cat([qn, qr], -1)
    k, v = gather_seq(k, rules), gather_seq(v, rules)
    out = attention(q, k, v, causal=True, chunk=chunk, scale=_scale(cfg), matmul_bf16=cfg.attn_matmul_bf16)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(cfg.dtype)), (c, kr)


def mla_decode(p, x, cfg, rules: AxisRules, *, cache, pos: int):
    """One decode step against the latent cache.

    cache = {'c': (B, Smax, r), 'kr': (B, Smax, dr)}.  The step's latent is
    written into the cache tensors in place, at ``pos`` clamped into the
    cache as the reference's ``dynamic_update_slice`` clamps it, and the
    cache is returned.
    """
    positions = torch.tensor([pos], device=x.device)
    qn, qr = _project_q(p, x, cfg, positions)  # (B,1,H,·)
    c_t, kr_t = _latent(p, x, cfg, positions)
    c, kr = cache["c"], cache["kr"]
    put(c, c_t.to(c.dtype), pos)
    put(kr, kr_t.to(kr.dtype), pos)
    kv_len = pos + 1
    if cfg.mla.absorb:
        # q̃ = qn·W_ukᵀ → attend in latent space; values are the latent too
        q_lat = torch.einsum("bshe,rhe->bshr", qn, p["wuk"].to(cfg.dtype))
        q_cat = torch.cat([q_lat, qr], -1)  # (B,1,H, r+dr)
        k_cat = torch.cat([c, kr], -1)[:, :, None, :]  # (B,S,1, r+dr)
        o_lat, _ = attention_with_lse(q_cat, k_cat, c[:, :, None, :], kv_len=kv_len, scale=_scale(cfg))
        # back to the compute dtype (a no-op in float32): torch's einsum
        # takes one dtype, where the reference's promotes to float32
        o = torch.einsum("bshr,rhe->bshe", o_lat.to(x.dtype), p["wuv"].to(cfg.dtype))
    else:
        k, v = _expand(p, c, kr, cfg)
        q = torch.cat([qn, qr], -1)
        o = attention(q, k, v, causal=False, kv_len=kv_len, scale=_scale(cfg), matmul_bf16=cfg.attn_matmul_bf16)
    out = torch.einsum("bshe,hed->bsd", o, p["wo"].to(cfg.dtype))
    return shard(out, rules, "batch", "seq", None), {"c": c, "kr": kr}


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device, *, lead: tuple[int, ...] = ()) -> dict:
    a = cfg.mla
    return {
        "c": torch.zeros((*lead, batch, max_len, a.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((*lead, batch, max_len, a.qk_rope_head_dim), dtype=dtype, device=device),
    }
