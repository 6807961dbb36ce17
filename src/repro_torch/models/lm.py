"""Decoder-only LMs: the dense, MoE, SSM, hybrid and VLM families.

The port's copy of ``repro.models.lm``: GQA or MLA attention with a
SwiGLU/GELU MLP or an MoE layer (``dense``, ``moe``, and ``vlm`` with
M-RoPE and vision embeddings written over the first positions), Mamba2
blocks (``ssm``), and Mamba2 blocks with one shared attention + MLP block
after every ``hybrid_period`` of them (``hybrid``, zamba2).  The
``encdec`` family is ``repro_torch.models.encdec``.  Layers keep the
reference's stacked leading-L parameter layout and run in a Python loop
over that axis (the reference's ``lax.scan``); each layer's window and
rope theta ride along as Python values.  ``forward``, the training path,
recomputes each layer's activations in the backward under ``cfg.remat``
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

API (plain functions on tensors; the device is that of the parameters):
  init(cfg, generator)                           → params
  forward(params, batch, cfg, rules)             → (logits (B,S,V), aux_loss)
  init_cache(cfg, batch, max_len, *, device)     → cache
  prefill(params, batch, cfg, rules, cache)      → (last_logits (B,V), cache)
  decode_step(params, tokens, cfg, rules, cache, pos) → (logits (B,V), cache)
  param_specs(cfg, rules, tp_size)               → Spec tree (mesh axes)

``prefill`` and ``decode_step`` leave the cache they are given as it was
and return a new one, as the reference's functional updates do: each
copies the cache once and writes every layer's keys into the copy.
Writes are clamped into the cache as ``dynamic_update_slice`` clamps them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import check_family
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.attention import RING_INVALID, attention, attention_with_lse
from repro_torch.models.common import (
    NO_SHARD,
    AxisRules,
    Spec,
    axes_of,
    clone,
    const_init,
    dense_init,
    gather_dim,
    gather_seq,
    heads_whole,
    last_position,
    lay_out,
    layer,
    local,
    local_rules,
    lse_combine,
    mesh_for,
    mesh_zeros,
    on_tensor_axis,
    placements,
    prepend_none_spec,
    put,
    put_owned,
    region,
    relaid,
    seq_shard,
    seq_split,
    shard,
    spec_axes,
    tp_region,
    tp_spec,
    tree_map,
    unstack,
    whole,
)
from repro_torch.models.rope import apply_mrope, apply_rope


# ============================================================== attention blk
def init_attn(gen: torch.Generator, cfg: ModelConfig, *, lead: tuple[int, ...] = ()) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pd, dev = cfg.param_dtype, gen.device
    p = {
        "wq": dense_init(gen, (d, H, hd), 0, pd, lead=lead),
        "wk": dense_init(gen, (d, KV, hd), 0, pd, lead=lead),
        "wv": dense_init(gen, (d, KV, hd), 0, pd, lead=lead),
        "wo": dense_init(gen, (H, hd, d), (0, 1), pd, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = const_init(0.0, (H, hd), pd, dev, lead=lead)
        p["bk"] = const_init(0.0, (KV, hd), pd, dev, lead=lead)
        p["bv"] = const_init(0.0, (KV, hd), pd, dev, lead=lead)
    if cfg.qk_norm:
        p["q_norm"] = const_init(1.0, (hd,), pd, dev, lead=lead)
        p["k_norm"] = const_init(1.0, (hd,), pd, dev, lead=lead)
    return p


def attn_specs(cfg) -> dict:
    s = {
        "wq": Spec("fsdp", "tensor", None),
        "wk": Spec("fsdp", "tensor", None),
        "wv": Spec("fsdp", "tensor", None),
        "wo": Spec("tensor", None, "fsdp"),
    }
    if cfg.qkv_bias:
        s |= {"bq": Spec("tensor", None), "bk": Spec("tensor", None), "bv": Spec("tensor", None)}
    if cfg.qk_norm:
        s |= {"q_norm": Spec(None), "k_norm": Spec(None)}
    return s


def _qkv(p, x, cfg, *, positions, theta, positions_thw=None):
    dt = cfg.dtype
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = L.rms_norm_head(q, p["q_norm"].to(torch.float32))
        k = L.rms_norm_head(k, p["k_norm"].to(torch.float32))
    if cfg.mrope_sections and positions_thw is not None:
        q = apply_mrope(q, positions_thw, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions_thw, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def apply_attn_block(
    p, x, cfg, rules, *, positions, window, theta, positions_thw=None, cache_kv=None, pos=None, causal=True,
):
    """Attention sublayer.  Train/prefill when ``cache_kv`` is None (returns
    the full-sequence (k, v) for cache building); else one decode step that
    writes this step's keys into the cache tensors in place and returns them.
    ``causal=False`` is the encoder's self-attention (whisper).

    Under a mesh, one region: each rank attends over its batch rows and
    its heads, and the output projection's partial sums over the tensor
    axis are reduced by ``shard``.  Under ``heads=None`` every weight is
    taken whole and each rank computes every head of its rows.  Where the
    sequence of ``x`` is split (``rules.seq``, SP), each rank makes Q, K
    and V from its own chunk of positions (RoPE at the chunk's global
    positions), all-gathers K and V along the sequence over the chunks'
    group (``gather_dim``: a reduce-scatter in the backward) and attends
    its queries from the chunk's start, so causal and window masks see
    global positions on both sides.  M-RoPE's ``positions_thw`` (3, B, S)
    enters the region laid out by the rows and the chunks of ``x``, so
    each rank rotates its rows by their own (t, h, w) ids.  Without
    autograd recording (prefill) the region also returns this layer's K
    and V, laid out as the output's rows and chunks and the ``wk`` heads;
    while it records (training), the output alone.  A decode step takes
    the cache entry (DTensors laid out by ``cache_specs``) into the region
    and writes its local shards in place (``_attn_decode_on_mesh``)."""
    mesh = mesh_for(rules)
    if mesh is not None:
        keys = list(p)
        # the norms' scales are used in float32, every other weight in cfg.dtype
        ws = [p[k].to(torch.float32 if k in ("q_norm", "k_norm") else cfg.dtype) for k in keys]
        if cache_kv is not None:
            out = _attn_decode_on_mesh(keys, ws, x, cfg, rules, mesh, window=window, theta=theta,
                                       cache_kv=cache_kv, pos=pos)
            return shard(out, rules, "batch", "seq", None), cache_kv
        with_kv = not torch.is_grad_enabled()
        xs = axes_of(x, mesh)
        _, chunk, group = seq_split(x, mesh)
        thw = () if positions_thw is None else ((positions_thw, Spec(None, xs[0], xs[1])),)

        def body(x, *rest):
            w, thw_local = dict(zip(keys, rest[: len(keys)])), rest[len(keys) :]
            lo = chunk * x.shape[1]
            out, kv = _attn_core(w, x, cfg, local_rules(rules),
                                 positions=None if positions is None else positions[lo : lo + x.shape[1]],
                                 window=window, theta=theta, positions_thw=thw_local[0] if thw_local else None,
                                 causal=causal, q_offset=lo, seq_group=group)
            return (out, *kv) if with_kv else out

        whole = heads_whole(rules)
        if not with_kv:
            return shard(tp_region(body, x, ws, rules, mesh, inputs=thw, whole=whole), rules, "batch", "seq",
                         None), None
        split = not (whole or rules.tensor in spec_axes(xs)) and on_tensor_axis(p["wk"], rules, mesh)
        kv = Spec(xs[0], xs[1], rules.tensor if split else None, None)
        out, k, v = tp_region(body, x, ws, rules, mesh, extra=(kv, kv), inputs=thw, whole=whole)
        return shard(out, rules, "batch", "seq", None), (k, v)
    out, new_kv = _attn_core(p, x, cfg, rules, positions=positions, window=window, theta=theta,
                             positions_thw=positions_thw, cache_kv=cache_kv, pos=pos, causal=causal)
    return shard(out, rules, "batch", "seq", None), new_kv


def _attn_decode_on_mesh(keys, ws, x, cfg, rules, mesh, *, window, theta, cache_kv, pos):
    """One decode step of attention on the mesh: one region over each
    rank's rows, heads and cache shard.  With the cache's sequence dim
    unsplit, each rank runs ``_attn_core`` on its local shards.  Split
    over ``kv_seq``, only the rank that holds position ``pos`` (its ring
    slot for a ring cache) writes this step's keys, each rank attends
    over its own slice (``attention_with_lse``, its positions explicit)
    and ``lse_combine`` joins the slices; the cache is never gathered.
    M-RoPE's positions (``pos`` on all three axes) are made for the rank's
    own rows inside the region.  The weights keep their tensor-axis split
    where the cache keeps the heads split over that axis; else they are
    taken whole, and every rank of a tensor group computes every head."""
    ck = cache_kv[0]
    axes, lo, total = seq_shard(ck)
    split = axes_of(ck, mesh)[2] == rules.tensor
    specs = [tp_spec(w, rules, mesh) if split else Spec() for w in ws]
    partial = (rules.tensor,) if any(any(e is not None for e in s) for s in specs) else ()
    positions = torch.tensor([pos], device=ck.device)

    def body(x, *rest):
        w, cache = dict(zip(keys, rest[: len(keys)])), rest[len(keys) :]
        thw = _decode_positions_thw(cfg, x.shape[0], pos, x.device)
        if not axes:
            return _attn_core(w, x, cfg, local_rules(rules), positions=positions, window=window, theta=theta,
                              positions_thw=thw, cache_kv=cache, pos=pos)[0]
        q, k, v = _qkv(w, x, cfg, positions=positions, theta=theta, positions_thw=thw)
        ck, cv = cache[:2]
        if len(cache) == 3:  # a ring: this step's slot, the keys' positions in kpos (replicated)
            kpos = cache[2]
            slot = pos % total
            kpos[slot] = pos
            k_pos, kv_len = kpos[lo : lo + ck.shape[1]], None
        else:
            slot, kv_len = pos, pos + 1
            k_pos = torch.arange(lo, lo + ck.shape[1], device=ck.device)
        put_owned(ck, k, slot, lo, total)
        put_owned(cv, v, slot, lo, total)
        o, lse = attention_with_lse(q, ck, cv, kv_len=kv_len, q_offset=pos, window=window, k_positions=k_pos)
        out = lse_combine(o, lse, mesh, axes).to(q.dtype)
        return torch.einsum("bshe,hed->bsd", out, w["wo"].to(cfg.dtype))

    xs = axes_of(x, mesh)
    cspecs = [axes_of(c, mesh) for c in cache_kv]
    return region(body, (x, *ws, *cache_kv), (xs, *specs, *cspecs), (xs,), partial=partial, mesh=mesh)


def _decode_positions_thw(cfg, rows: int, pos: int, device) -> "torch.Tensor | None":
    """A decode step's M-RoPE positions for ``rows`` sequences: ``pos`` on
    all three axes (3, rows, 1), as the reference broadcasts it; ``None``
    without M-RoPE."""
    if not cfg.mrope_sections:
        return None
    return torch.full((3, rows, 1), pos, dtype=torch.int32, device=device)


def _attn_core(p, x, cfg, rules, *, positions, window, theta, positions_thw=None, cache_kv=None, pos=None,
               causal=True, q_offset=0, seq_group=None):
    """``apply_attn_block`` up to its output's sharding constraint.  With
    ``seq_group`` (a region's body under SP), ``x`` is the chunk of the
    sequence from ``q_offset`` on: K and V are all-gathered along the
    sequence over the group and the queries attend from ``q_offset``; the
    chunk's own K and V are returned."""
    q, k, v = _qkv(p, x, cfg, positions=positions, theta=theta, positions_thw=positions_thw)
    if cache_kv is None:
        if seq_group is None:
            k_all, v_all = gather_seq(k, rules), gather_seq(v, rules)
        else:
            k_all, v_all = gather_dim(k, 1, seq_group), gather_dim(v, 1, seq_group)
        out = attention(
            q, k_all, v_all, causal=causal, window=window, q_offset=q_offset, chunk=cfg.attn_chunk,
            matmul_bf16=cfg.attn_matmul_bf16,
        )
        new_kv = (k, v)
    elif len(cache_kv) == 3:
        # ring-buffer window cache: O(window) instead of O(seq)
        ck, cv, kpos = cache_kv
        slot = pos % ck.shape[1]
        put(ck, k.to(ck.dtype), slot)
        put(cv, v.to(cv.dtype), slot)
        kpos[slot] = pos
        out = attention(
            q, ck, cv, causal=False, window=window, q_offset=pos, chunk=cfg.attn_chunk,
            matmul_bf16=cfg.attn_matmul_bf16, k_positions=kpos,
        )
        new_kv = (ck, cv, kpos)
    else:
        ck, cv = cache_kv
        put(ck, k.to(ck.dtype), pos)
        put(cv, v.to(cv.dtype), pos)
        out = attention(
            q, ck, cv, causal=False, window=window, q_offset=pos, kv_len=pos + 1,
            chunk=cfg.attn_chunk, matmul_bf16=cfg.attn_matmul_bf16,
        )
        new_kv = (ck, cv)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(cfg.dtype)), new_kv


# ================================================================ blocks
def _is_mamba(cfg) -> bool:
    return cfg.family == "ssm" or cfg.is_hybrid


def init_blocks(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Every layer's parameters, stacked on a leading L axis."""
    lead, d = (cfg.num_layers,), cfg.d_model
    if _is_mamba(cfg):
        return {"ln": L.init_norm(d, cfg, gen.device, lead=lead), "mamba": SSM.init_mamba(gen, cfg, lead=lead)}
    blk = {"ln1": L.init_norm(d, cfg, gen.device, lead=lead), "ln2": L.init_norm(d, cfg, gen.device, lead=lead)}
    blk["attn"] = MLA.init_mla(gen, cfg, lead=lead) if cfg.mla.kv_lora_rank else init_attn(gen, cfg, lead=lead)
    if cfg.is_moe:
        blk["moe"] = MOE.init_moe(gen, cfg, lead=lead)
    else:
        blk["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg, lead=lead)
    return blk


def block_specs(cfg, tp_size: int) -> dict:
    """One layer's specs (``init_blocks`` without the leading L axis)."""
    if _is_mamba(cfg):
        return {"ln": L.norm_specs(cfg), "mamba": SSM.mamba_specs(cfg)}
    s = {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg)}
    s["attn"] = MLA.mla_specs(cfg) if cfg.mla.kv_lora_rank else attn_specs(cfg)
    s["moe" if cfg.is_moe else "mlp"] = MOE.moe_specs(cfg, tp_size) if cfg.is_moe else L.mlp_specs(cfg)
    return s


def apply_block(blk, x, cfg, rules, *, positions, window, theta, aux, positions_thw=None, cache=None, pos=None):
    """One decoder layer.  Returns (x, aux, new_cache)."""
    if _is_mamba(cfg):
        h = L.apply_norm(blk["ln"], x, cfg)
        y, new_cache = SSM.apply_mamba(blk["mamba"], h, cfg, rules, cache=cache, pos=pos)
        return x + y, aux, new_cache
    h = L.apply_norm(blk["ln1"], x, cfg)
    if cfg.mla.kv_lora_rank:
        if cache is None:
            a, new_cache = MLA.mla_attention(blk["attn"], h, cfg, rules, positions=positions, chunk=cfg.attn_chunk)
        else:
            a, new_cache = MLA.mla_decode(blk["attn"], h, cfg, rules, cache=cache, pos=pos)
    else:
        a, new_cache = apply_attn_block(
            blk["attn"], h, cfg, rules, positions=positions, window=window, theta=theta,
            positions_thw=positions_thw, cache_kv=cache, pos=pos,
        )
    x = x + a
    h2 = L.apply_norm(blk["ln2"], x, cfg)
    if cfg.is_moe:
        y, aux_l = MOE.apply_moe(blk["moe"], h2, cfg, rules)
        aux = aux + aux_l
    else:
        y = L.apply_mlp(blk["mlp"], h2, cfg, rules)
    return x + y, aux, new_cache


# ============================================================ shared (zamba2)
def init_shared_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "in_proj": dense_init(gen, (2 * d, d), 0, cfg.param_dtype),
        "ln1": L.init_norm(d, cfg, gen.device),
        "attn": init_attn(gen, cfg),
        "ln2": L.init_norm(d, cfg, gen.device),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg),
    }


def shared_block_specs(cfg) -> dict:
    return {
        "in_proj": Spec("fsdp", "tensor"),
        "ln1": L.norm_specs(cfg),
        "attn": attn_specs(cfg),
        "ln2": L.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg),
    }


def apply_shared_block(p, x, x0, cfg, rules, *, positions, cache=None, pos=None):
    """Zamba2's shared attention block: concat(x, embeddings) → 2d × d
    projection → attention (global, ``cfg.rope_theta``) and MLP; returns
    (x + t, new_kv) with ``new_kv`` as ``apply_attn_block`` gives it.
    Under a mesh the projection is one region whose output columns follow
    ``in_proj``'s tensor-axis split, gathered whole for ``ln1``."""
    t = _shared_in(p["in_proj"].to(cfg.dtype), x, x0, rules)
    h = L.apply_norm(p["ln1"], t, cfg)
    a, new_cache = apply_attn_block(
        p["attn"], h, cfg, rules, positions=positions, window=0, theta=cfg.rope_theta, cache_kv=cache, pos=pos,
    )
    t = t + a
    h2 = L.apply_norm(p["ln2"], t, cfg)
    t = t + L.apply_mlp(p["mlp"], h2, cfg, rules)
    return x + t, new_cache


def _shared_in(w, x, x0, rules):
    def proj(x, x0, w):
        return torch.einsum("bse,ed->bsd", torch.cat([x, x0], dim=-1), w)

    mesh = mesh_for(rules)
    if mesh is None:
        return proj(x, x0, w)
    xs = axes_of(x, mesh)
    # under SP the tensor axis splits the rows, so the projection is taken whole
    ws = Spec() if rules.tensor in spec_axes(xs) else tp_spec(w, rules, mesh)
    t = region(proj, (x, x0, w), (xs, xs, ws), (Spec(*xs[:2], ws[1] if ws else None),), mesh=mesh)
    return shard(t, rules, "batch", "seq", None)


def _shared_after(cfg, i: int) -> "int | None":
    """The period whose shared block runs after layer ``i``, if one does."""
    if cfg.is_hybrid and (i + 1) % cfg.hybrid_period == 0:
        return i // cfg.hybrid_period
    return None


# ==================================================================== init
def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters on ``generator``'s device, drawn from it."""
    check_family(cfg)
    params = {
        "embedding": L.init_embedding(generator, cfg),
        "final_norm": L.init_norm(cfg.d_model, cfg, generator.device),
        "blocks": init_blocks(generator, cfg),
    }
    if cfg.is_hybrid:
        params["shared"] = init_shared_block(generator, cfg)
    return params


def param_specs(cfg: ModelConfig, rules: AxisRules, tp_size: int = 1):
    """The mesh-axis ``Spec`` of every leaf of ``init``'s tree."""
    specs = {
        "embedding": L.embedding_specs(cfg),
        "final_norm": L.norm_specs(cfg),
        "blocks": prepend_none_spec(block_specs(cfg, tp_size)),
    }
    if cfg.is_hybrid:
        specs["shared"] = shared_block_specs(cfg)
    return L.resolve_specs(specs, rules)


# leaves that ``ModelConfig.param_count`` leaves out: norms, biases and
# the Mamba2 blocks' per-channel and per-head vectors
_UNCOUNTED = {
    "scale", "bias", "q_norm", "k_norm", "bq", "bk", "bv", "bi", "bo",
    "conv_b", "A_log", "D", "dt_bias", "norm_scale",
}


def counted_params(params) -> int:
    """The parameters ``ModelConfig.param_count()`` counts: every weight
    matrix, without norm scales, biases and the SSM vectors.  For the
    hybrid family this is ``param_count()`` plus the shared block's ``wq``
    (d · H · hd), which the reference's count leaves out."""
    if isinstance(params, dict):
        return sum(0 if k in _UNCOUNTED else counted_params(v) for k, v in params.items())
    return params.numel()


def _layers(params, cfg):
    """(layer params, window, rope theta) of every layer, in order; the
    layers are views into the stack, from one ``unstack``."""
    tg = cfg.rope_theta_global or cfg.rope_theta
    for i, blk in enumerate(unstack(params["blocks"], cfg.num_layers)):
        w = cfg.layer_window(i)
        yield blk, w, (tg if w == 0 else cfg.rope_theta)


def _embed_in(params, batch, cfg, rules):
    """The token embeddings, the vision embeddings (vlm) written over the
    first positions of each row.  Under a mesh the splice is one region on
    each rank's rows, the vision embeddings laid out by those rows; under
    SP a rank writes only the vision positions its chunk holds."""
    x = L.embed_tokens(params["embedding"], batch["tokens"], cfg, rules)
    if cfg.embed_scale:
        # the reference's scale rounded to the compute dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype).item()
    ve = batch.get("vision_embeds")
    if ve is not None and cfg.vision_tokens:
        mesh = mesh_for(rules)
        if mesh is None:
            return _splice(x, ve)
        xs = axes_of(x, mesh)
        axes, chunk, _ = seq_split(x, mesh)
        if not axes:
            return region(_splice, (x, ve), (xs, Spec(xs[0], None, None)), (xs,), mesh=mesh)
        lo = chunk * local(x).shape[1]
        return region(_splice, (x, ve, lo), (xs, Spec(xs[0], None, None), None), (xs,), mesh=mesh)
    return x


def _splice(x, ve, lo: int = 0):
    """``ve`` written over the first positions of ``x``: the reference's
    ``dynamic_update_slice`` at position 0.  ``x`` may be the chunk of the
    sequence from position ``lo`` on (SP): only the vision positions it
    holds are written."""
    end = min(ve.shape[1], lo + x.shape[1])
    if end <= lo:
        return x
    return torch.cat([ve[:, lo:end].to(x.dtype), x[:, end - lo :]], dim=1)


def _logits(params, x, cfg, rules):
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embedding"], x, cfg, rules)


def _store(dst: dict, src: dict) -> None:
    """Write a Mamba2 block's new cache into its entry of the stacked cache."""
    for k in dst:
        dst[k].copy_(src[k])


# ==================================================================== forward
def remat(fn, cfg, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    ``cfg.remat`` and autograd is recording: the reference's
    ``jax.checkpoint`` around a layer's body."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params, batch, cfg: ModelConfig, rules: AxisRules = NO_SHARD):
    """Training forward: returns (logits (B,S,V), aux_loss).

    Each layer's body runs under ``remat``; the hybrid family's shared
    block stays outside it, as in the reference.  Under a mesh every
    family runs on DTensors (``common.set_mesh``)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = x0 = _embed_in(params, batch, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    positions_thw = batch.get("positions_thw")
    mesh = mesh_for(rules)
    if mesh is None:
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    else:
        aux = mesh_zeros(mesh)
    for i, (blk, w, th) in enumerate(_layers(params, cfg)):

        def body(x, aux, blk=blk, w=w, th=th):
            x, aux, _ = apply_block(
                blk, x, cfg, rules, positions=positions, window=w, theta=th, aux=aux, positions_thw=positions_thw,
            )
            return x, aux

        x, aux = remat(body, cfg, x, aux)
        if _shared_after(cfg, i) is not None:
            x, _ = apply_shared_block(params["shared"], x, x0, cfg, rules, positions=positions)
    return _logits(params, x, cfg, rules), aux


# ================================================================ serve paths
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device) -> dict:
    """Per-layer cache stacked on a leading L axis; the hybrid family adds
    one KV cache a period for its shared block, stacked on the period."""
    check_family(cfg)
    dtype = dtype or cfg.dtype
    Lc = cfg.num_layers
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if _is_mamba(cfg):
        cache = {"layers": SSM.init_mamba_cache(cfg, batch, dtype, device, lead=(Lc,))}
        if cfg.is_hybrid:
            n_periods = Lc // cfg.hybrid_period
            cache["shared"] = (
                torch.zeros((n_periods, batch, max_len, KV, hd), dtype=dtype, device=device),
                torch.zeros((n_periods, batch, max_len, KV, hd), dtype=dtype, device=device),
            )
        return cache
    if cfg.mla.kv_lora_rank:
        return {"layers": MLA.init_mla_cache(cfg, batch, max_len, dtype, device, lead=(Lc,))}
    if cfg.decode_window_cache:
        ws = [cfg.layer_window(i) for i in range(Lc)]
        if not all(w > 0 for w in ws):
            raise ValueError("decode_window_cache needs every layer windowed")
        ring = max(ws)
        ring += (-ring) % 16  # the reference's mesh-divisible size
        return {
            "layers": (
                torch.zeros((Lc, batch, ring, KV, hd), dtype=dtype, device=device),
                torch.zeros((Lc, batch, ring, KV, hd), dtype=dtype, device=device),
                torch.full((Lc, ring), RING_INVALID, dtype=torch.int32, device=device),
            )
        }
    return {
        "layers": (
            torch.zeros((Lc, batch, max_len, KV, hd), dtype=dtype, device=device),
            torch.zeros((Lc, batch, max_len, KV, hd), dtype=dtype, device=device),
        )
    }


def _fill_ring(ck, cv, kpos, k_full, v_full) -> None:
    """Keep the last ``ring`` prompt positions of one layer in its ring."""
    ring, S = ck.shape[1], k_full.shape[1]
    if S >= ring:
        keep_pos = torch.arange(S - ring, S, device=ck.device)
        slots = keep_pos % ring
        ck[:, slots] = k_full[:, -ring:].to(ck.dtype)
        cv[:, slots] = v_full[:, -ring:].to(cv.dtype)
        kpos[slots] = keep_pos.to(kpos.dtype)
    else:
        put(ck, k_full.to(ck.dtype), 0)
        put(cv, v_full.to(cv.dtype), 0)
        kpos[:S] = torch.arange(S, dtype=kpos.dtype, device=kpos.device)


def prefill(params, batch, cfg: ModelConfig, rules: AxisRules, cache: dict):
    """Run the prompt through the model, filling the cache.

    Returns (last-position logits (B,V), cache).  Each layer's keys (or MLA
    latent, or Mamba2 conv and SSM states) go into the new cache as that
    layer finishes, which gives the reference's cache with and without
    ``prefill_inscan_cache``.
    """
    check_family(cfg)
    mesh = mesh_for(rules)
    if mesh is not None:
        with torch.no_grad():
            params, batch, cache = _serve_inputs(params, batch, cache, cfg, rules, mesh)
            return _prefill(params, batch, cfg, rules, cache, mesh)
    return _prefill(params, batch, cfg, rules, cache, None)


def _prefill(params, batch, cfg, rules, cache, mesh):
    tokens = batch["tokens"]
    x = x0 = _embed_in(params, batch, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    positions_thw = batch.get("positions_thw")
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device) if mesh is None else mesh_zeros(mesh)
    cache = tree_map(clone, cache)
    for i, (blk, w, th) in enumerate(_layers(params, cfg)):
        entry = layer(cache["layers"], i)
        if _is_mamba(cfg):
            x, aux, new = apply_block(blk, x, cfg, rules, positions=positions, window=w, theta=th, aux=aux, cache=entry)
            if mesh is None:  # on the mesh the block wrote its entry's local shards
                _store(entry, new)
            p = _shared_after(cfg, i)
            if p is not None:
                x, kv = apply_shared_block(params["shared"], x, x0, cfg, rules, positions=positions)
                shared = layer(cache["shared"], p)
                if mesh is not None:
                    _write_prompt_on_mesh(shared, kv, cfg, mesh)
                else:
                    put(shared[0], kv[0].to(shared[0].dtype), 0)
                    put(shared[1], kv[1].to(shared[1].dtype), 0)
            continue
        x, aux, kv = apply_block(
            blk, x, cfg, rules, positions=positions, window=w, theta=th, aux=aux, positions_thw=positions_thw,
        )
        if mesh is not None:
            _write_prompt_on_mesh(entry, kv, cfg, mesh)
        elif cfg.mla.kv_lora_rank:
            put(entry["c"], kv[0].to(entry["c"].dtype), 0)
            put(entry["kr"], kv[1].to(entry["kr"].dtype), 0)
        elif cfg.decode_window_cache:
            _fill_ring(*entry, *kv)
        else:
            put(entry[0], kv[0].to(entry[0].dtype), 0)
            put(entry[1], kv[1].to(entry[1].dtype), 0)
    logits = _logits(params, last_position(x), cfg, rules)
    return whole(logits)[:, 0], cache


def _serve_inputs(params, batch, cache, cfg, rules, mesh):
    """The parameters, every leaf of the batch and the cache laid out on
    ``mesh`` as the reference's jitted prefill and decode take them
    (``launch.sharding.serve_layout``: ``param_specs``, ``batch_specs``'
    rows, ``cache_specs``); what already lies so is not moved."""
    from repro_torch.launch.sharding import serve_layout

    pspecs, bspecs, cspecs = serve_layout(cfg, rules, mesh, params, batch, cache)
    return lay_out(params, pspecs, mesh), lay_out(batch, bspecs, mesh), lay_out(cache, cspecs, mesh)


def _write_prompt_on_mesh(entry, kv, cfg, mesh) -> None:
    """Write a layer's prompt K and V (or latent) into its cache entry on
    the mesh: each laid out as its entry, the sequence whole, then every
    rank writes the positions of its own shard (all of them where the
    sequence is not split over ``kv_seq``); a ring keeps the last ``ring``
    positions in their slots, ``kpos`` (replicated) on every rank."""
    dsts = (entry["c"], entry["kr"]) if cfg.mla.kv_lora_rank else entry[:2]
    for dst, src in zip(dsts, kv):
        spec = axes_of(dst, mesh)
        src = local(relaid(src, placements(Spec(spec[0], None, *spec[2:]), mesh), mesh))
        axes, lo, total = seq_shard(dst)
        if len(entry) == 3:  # a ring
            S = src.shape[1]
            keep = torch.arange(max(S - total, 0), S, device=src.device)
            slots = keep % total
            own = (slots >= lo) & (slots < lo + local(dst).shape[1])
            local(dst)[:, slots[own] - lo] = src[:, keep[own]].to(dst.dtype)
        else:
            put_owned(local(dst), src, 0, lo, total)
    if len(entry) == 3:
        S, ring = kv[0].shape[1], entry[0].shape[1]
        keep = torch.arange(max(S - ring, 0), S, device=local(entry[2]).device)
        local(entry[2])[keep % ring] = keep.to(entry[2].dtype)


def decode_step(params, tokens, cfg: ModelConfig, rules: AxisRules, cache: dict, pos: int):
    """One token for every sequence.  tokens: (B, 1); pos: the position."""
    check_family(cfg)
    mesh = mesh_for(rules)
    if mesh is not None:
        with torch.no_grad():
            params, batch, cache = _serve_inputs(params, {"tokens": tokens}, cache, cfg, rules, mesh)
            return _decode_step(params, batch["tokens"], cfg, rules, cache, pos, mesh)
    return _decode_step(params, tokens, cfg, rules, cache, pos, None)


def _decode_step(params, tokens, cfg, rules, cache, pos, mesh):
    x = x0 = _embed_in(params, {"tokens": tokens}, cfg, rules)
    positions = torch.tensor([pos], device=tokens.device)
    # on the mesh each rank makes its own rows' positions inside the attention region
    positions_thw = None if mesh is not None else _decode_positions_thw(cfg, tokens.shape[0], pos, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device) if mesh is None else mesh_zeros(mesh)
    cache = tree_map(clone, cache)
    for i, (blk, w, th) in enumerate(_layers(params, cfg)):
        entry = layer(cache["layers"], i)
        x, _, new = apply_block(
            blk, x, cfg, rules, positions=positions, window=w, theta=th, aux=aux, positions_thw=positions_thw,
            cache=entry, pos=pos,
        )
        if _is_mamba(cfg) and mesh is None:  # on the mesh the block wrote its entry's local shards
            _store(entry, new)
        p = _shared_after(cfg, i)
        if p is not None:
            x, _ = apply_shared_block(
                params["shared"], x, x0, cfg, rules, positions=positions, cache=layer(cache["shared"], p), pos=pos,
            )
    logits = _logits(params, x, cfg, rules)
    return whole(logits)[:, 0], cache
