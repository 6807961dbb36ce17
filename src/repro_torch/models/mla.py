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
from repro_torch.models.common import (
    AxisRules,
    Spec,
    axes_of,
    dense_init,
    gather_dim,
    gather_seq,
    heads_whole,
    local_rules,
    lse_combine,
    mesh_for,
    put_owned,
    region,
    seq_shard,
    seq_split,
    shard,
    tp_region,
    tp_spec,
)
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

    Under a mesh, one region: each rank builds the latent for its batch
    rows (``wdkv``/``wkr`` are not split over the tensor axis, so every
    rank of a tensor group builds the same) and attends over its heads;
    the output projection's partial sums are reduced by ``shard``.  Under
    ``heads=None`` the weights are taken whole.  Where the sequence is
    split (SP), each rank builds the latent of its chunk (RoPE at the
    chunk's global positions), all-gathers ``c`` and ``kr`` along the
    sequence, expands them to every position's keys and values, and
    attends its queries from the chunk's start.  Without autograd
    recording (prefill) the region also returns the chunk's latent, laid
    out as the output's rows and chunks and replicated over the tensor
    axis; while it records (training), the output alone."""
    mesh = mesh_for(rules)
    if mesh is not None:
        keys = list(p)
        ws = [p[k].to(cfg.dtype) for k in keys]
        with_kv = not torch.is_grad_enabled()
        _, index, group = seq_split(x, mesh)

        def body(x, *w):
            lo = index * x.shape[1]
            out, latent = _mla_core(dict(zip(keys, w)), x, cfg, local_rules(rules), positions[lo : lo + x.shape[1]],
                                    chunk, q_offset=lo, seq_group=group)
            return (out, *latent) if with_kv else out

        whole = heads_whole(rules)
        if not with_kv:
            return shard(tp_region(body, x, ws, rules, mesh, whole=whole), rules, "batch", "seq", None), None
        xs = axes_of(x, mesh)
        rows = Spec(xs[0], xs[1], None)
        out, c, kr = tp_region(body, x, ws, rules, mesh, extra=(rows, rows), whole=whole)
        return shard(out, rules, "batch", "seq", None), (c, kr)
    out, latent = _mla_core(p, x, cfg, rules, positions, chunk)
    return shard(out, rules, "batch", "seq", None), latent


def _mla_core(p, x, cfg, rules, positions, chunk, q_offset=0, seq_group=None):
    """``mla_attention`` on plain tensors; with ``seq_group`` (SP) ``x`` is
    the chunk from ``q_offset`` on and the latent is gathered along the
    sequence over the group before it is expanded."""
    qn, qr = _project_q(p, x, cfg, positions)
    c, kr = _latent(p, x, cfg, positions)
    if seq_group is None:
        k, v = _expand(p, c, kr, cfg)
        k, v = gather_seq(k, rules), gather_seq(v, rules)
    else:
        k, v = _expand(p, gather_dim(c, 1, seq_group), gather_dim(kr, 1, seq_group), cfg)
    q = torch.cat([qn, qr], -1)
    out = attention(q, k, v, causal=True, q_offset=q_offset, chunk=chunk, scale=_scale(cfg),
                    matmul_bf16=cfg.attn_matmul_bf16)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(cfg.dtype)), (c, kr)


def mla_decode(p, x, cfg, rules: AxisRules, *, cache, pos: int):
    """One decode step against the latent cache.

    cache = {'c': (B, Smax, r), 'kr': (B, Smax, dr)}.  The step's latent is
    written into the cache tensors in place, at ``pos`` clamped into the
    cache as the reference's ``dynamic_update_slice`` clamps it, and the
    cache is returned.
    """
    mesh = mesh_for(rules)
    if mesh is not None:
        return shard(_mla_decode_on_mesh(p, x, cfg, rules, mesh, cache, pos), rules, "batch", "seq", None), cache
    out = _mla_decode_core(p, x, cfg, cache["c"], cache["kr"], pos)
    return shard(out, rules, "batch", "seq", None), {"c": cache["c"], "kr": cache["kr"]}


def _mla_decode_core(p, x, cfg, c, kr, pos: int, kv_seq=None):
    """``mla_decode`` on plain tensors: the step's latent written at
    ``pos``, attention over the cache, the output projection.  ``kv_seq``
    = (mesh, axes, lo, total): ``c``/``kr`` are one shard of a cache split
    along its sequence; only the shard holding ``pos`` writes it, each
    attends over its own positions and ``lse_combine`` joins them."""
    positions = torch.tensor([pos], device=x.device)
    qn, qr = _project_q(p, x, cfg, positions)  # (B,1,H,·)
    c_t, kr_t = _latent(p, x, cfg, positions)
    mesh, axes, lo, total = kv_seq or (None, (), 0, c.shape[1])
    put_owned(c, c_t, pos, lo, total)
    put_owned(kr, kr_t, pos, lo, total)
    kv_len = pos + 1
    k_pos = torch.arange(lo, lo + c.shape[1], device=x.device) if axes else None
    if cfg.mla.absorb:
        # q̃ = qn·W_ukᵀ → attend in latent space; values are the latent too
        q_lat = torch.einsum("bshe,rhe->bshr", qn, p["wuk"].to(cfg.dtype))
        q_cat = torch.cat([q_lat, qr], -1)  # (B,1,H, r+dr)
        k_cat = torch.cat([c, kr], -1)[:, :, None, :]  # (B,S,1, r+dr)
        o_lat, lse = attention_with_lse(q_cat, k_cat, c[:, :, None, :], kv_len=kv_len, scale=_scale(cfg),
                                        k_positions=k_pos)
        if axes:
            o_lat = lse_combine(o_lat, lse, mesh, axes)
        # back to the compute dtype (a no-op in float32): torch's einsum
        # takes one dtype, where the reference's promotes to float32
        o = torch.einsum("bshr,rhe->bshe", o_lat.to(x.dtype), p["wuv"].to(cfg.dtype))
    else:
        k, v = _expand(p, c, kr, cfg)
        q = torch.cat([qn, qr], -1)
        if axes:
            o, lse = attention_with_lse(q, k, v, kv_len=kv_len, scale=_scale(cfg), k_positions=k_pos)
            o = lse_combine(o, lse, mesh, axes).to(q.dtype)
        else:
            o = attention(q, k, v, causal=False, kv_len=kv_len, scale=_scale(cfg),
                          matmul_bf16=cfg.attn_matmul_bf16)
    return torch.einsum("bshe,hed->bsd", o, p["wo"].to(cfg.dtype))


def _mla_decode_on_mesh(p, x, cfg, rules, mesh, cache, pos: int):
    """One decode step on the mesh: one region over each rank's rows,
    heads and latent shard.  The latent cache is replicated over the
    tensor axis and every rank of a tensor group writes it alike; split
    over ``kv_seq``, only the owner of ``pos`` writes, and the heads are
    taken whole where ``kv_seq`` holds the tensor axis."""
    axes, lo, total = seq_shard(cache["c"])
    keys = list(p)
    ws = [p[k].to(cfg.dtype) for k in keys]
    specs = [tp_spec(w, rules, mesh) if rules.tensor not in axes else Spec() for w in ws]
    partial = (rules.tensor,) if any(any(e is not None for e in s) for s in specs) else ()
    kv_seq = (mesh, axes, lo, total) if axes else None

    def body(x, c, kr, *w):
        return _mla_decode_core(dict(zip(keys, w)), x, cfg, c, kr, pos, kv_seq)

    xs = axes_of(x, mesh)
    c, kr = cache["c"], cache["kr"]
    return region(body, (x, c, kr, *ws), (xs, axes_of(c, mesh), axes_of(kr, mesh), *specs), (xs,), partial=partial,
                  mesh=mesh)


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device, *, lead: tuple[int, ...] = ()) -> dict:
    a = cfg.mla
    return {
        "c": torch.zeros((*lead, batch, max_len, a.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((*lead, batch, max_len, a.qk_rope_head_dim), dtype=dtype, device=device),
    }
