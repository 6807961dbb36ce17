"""Whisper-style encoder-decoder backbone (the conv frontend is a stub).

The port's copy of ``repro.models.encdec``.  Encoder: precomputed frame
embeddings (B, F, d) plus sinusoidal positions → a non-causal
self-attention stack (LayerNorm + GELU, the whisper flavour).  Decoder:
token embeddings plus sinusoidal positions → causal self-attention,
cross-attention to the encoder output, MLP.  The embeddings are tied.

Training: ``forward`` recomputes each encoder and decoder layer's
activations in the backward under ``cfg.remat``, as the reference's
``jax.checkpoint`` does.

Serving: ``prefill`` runs the encoder once and caches every decoder
layer's cross-attention K/V; self-attention uses a padded KV cache.

Over a mesh (``common.set_mesh`` with enabled rules) every entry point
runs on DTensors: the encoder's self-attention is ``lm.apply_attn_block``
without its causal mask (one region split by heads over the tensor axis),
and each cross-attention is one region whose rank computes its query
heads from the decoder stream and, in training and prefill, the same
heads' K/V from the encoder output (``wk`` / ``wv`` split alike); prefill
writes them into the cross cache laid out as ``cache_specs``' ``cross``
entry.  A decode step reads the cached K/V's local shards; where the
cache is split along the frames (``kv_seq``) each rank attends over its
own frames and ``lse_combine`` joins the slices, so the cache is never
gathered.

API as ``repro_torch.models.lm``:
  init(cfg, generator)                           → params
  forward(params, batch, cfg, rules)             → (logits (B,S,V), 0)
  init_cache(cfg, batch, max_len, *, device)     → cache
  prefill(params, batch, cfg, rules, cache)      → (last_logits (B,V), cache)
  decode_step(params, tokens, cfg, rules, cache, pos) → (logits (B,V), cache)
  param_specs(cfg, rules, tp_size)               → Spec tree (mesh axes)
with ``batch = {"enc_frames": (B, F, d), "tokens": (B, S)}``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import attention, attention_with_lse
from repro_torch.models.common import (
    NO_SHARD,
    AxisRules,
    Spec,
    axes_of,
    clone,
    heads_whole,
    last_position,
    layer,
    lse_combine,
    mesh_for,
    mesh_zeros,
    on_tensor_axis,
    prepend_none_spec,
    put,
    region,
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
from repro_torch.models.lm import (
    _serve_inputs,
    _write_prompt_on_mesh,
    apply_attn_block,
    attn_specs,
    init_attn,
    remat,
)
from repro_torch.models.rope import sinusoidal_positions


def _init_enc_blocks(gen: torch.Generator, cfg) -> dict:
    lead, d, dev = (cfg.encoder_layers,), cfg.d_model, gen.device
    return {
        "ln1": L.init_norm(d, cfg, dev, lead=lead),
        "attn": init_attn(gen, cfg, lead=lead),
        "ln2": L.init_norm(d, cfg, dev, lead=lead),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg, lead=lead),
    }


def _init_dec_blocks(gen: torch.Generator, cfg) -> dict:
    lead, d, dev = (cfg.num_layers,), cfg.d_model, gen.device
    return {
        "ln1": L.init_norm(d, cfg, dev, lead=lead),
        "self_attn": init_attn(gen, cfg, lead=lead),
        "ln_x": L.init_norm(d, cfg, dev, lead=lead),
        "cross_attn": init_attn(gen, cfg, lead=lead),
        "ln2": L.init_norm(d, cfg, dev, lead=lead),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg, lead=lead),
    }


def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters on ``generator``'s device, drawn from it; every
    stack keeps the reference's leading layer axis."""
    return {
        "embedding": L.init_embedding(generator, cfg),
        "enc_blocks": _init_enc_blocks(generator, cfg),
        "enc_norm": L.init_norm(cfg.d_model, cfg, generator.device),
        "dec_blocks": _init_dec_blocks(generator, cfg),
        "final_norm": L.init_norm(cfg.d_model, cfg, generator.device),
    }


def param_specs(cfg: ModelConfig, rules: AxisRules, tp_size: int = 1):
    """The mesh-axis ``Spec`` of every leaf of ``init``'s tree."""
    enc = {"ln1": L.norm_specs(cfg), "attn": attn_specs(cfg), "ln2": L.norm_specs(cfg), "mlp": L.mlp_specs(cfg)}
    dec = {
        "ln1": L.norm_specs(cfg),
        "self_attn": attn_specs(cfg),
        "ln_x": L.norm_specs(cfg),
        "cross_attn": attn_specs(cfg),
        "ln2": L.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg),
    }
    specs = {
        "embedding": L.embedding_specs(cfg),
        "enc_blocks": prepend_none_spec(enc),
        "enc_norm": L.norm_specs(cfg),
        "dec_blocks": prepend_none_spec(dec),
        "final_norm": L.norm_specs(cfg),
    }
    return L.resolve_specs(specs, rules)


def _positions(S: int, cfg, device, start: int = 0) -> torch.Tensor:
    return sinusoidal_positions(S, cfg.d_model, device, start=start).to(cfg.dtype)


def _plus_positions(x, pe, rules):
    """``x`` in ``pe``'s dtype plus the sinusoid rows ``pe`` (S, d), which
    every rank holds alike; on a DTensor, in a region on each rank's rows,
    a rank whose chunk of the sequence starts at ``lo`` (SP) adding the
    rows from ``lo`` on."""
    mesh = mesh_for(rules)
    if mesh is None:
        return x.to(pe.dtype) + pe
    xs = axes_of(x, mesh)
    _, index, _ = seq_split(x, mesh)

    def body(x):
        return x.to(pe.dtype) + pe.narrow(0, index * x.shape[1], x.shape[1])

    return region(body, (x,), (xs,), (xs,), mesh=mesh)


def encode(params, frames, cfg, rules: AxisRules):
    """frames: (B, F, d) stub embeddings → the encoder output (B, F, d);
    each layer under ``remat``, its self-attention ``apply_attn_block``
    without the causal mask."""
    x = _plus_positions(frames, _positions(frames.shape[1], cfg, frames.device), rules)
    x = shard(x, rules, "batch", "seq", None)

    def body(x, blk):
        h = L.apply_norm(blk["ln1"], x, cfg)
        a, _ = apply_attn_block(blk["attn"], h, cfg, rules, positions=None, window=0, theta=cfg.rope_theta,
                                causal=False)
        x = x + a
        h2 = L.apply_norm(blk["ln2"], x, cfg)
        return x + L.apply_mlp(blk["mlp"], h2, cfg, rules)

    for blk in unstack(params["enc_blocks"], cfg.encoder_layers):
        x = remat(body, cfg, x, blk)
    return L.apply_norm(params["enc_norm"], x, cfg)


def _enc_kv(p, enc_out, cfg):
    ek = torch.einsum("bsd,dhe->bshe", enc_out, p["wk"].to(cfg.dtype))
    ev = torch.einsum("bsd,dhe->bshe", enc_out, p["wv"].to(cfg.dtype))
    return ek, ev


def _cross_core(p, h, ek, ev, cfg):
    """Cross-attention of the normed decoder stream ``h`` to (ek, ev), up to
    the output projection's sum."""
    q = torch.einsum("bsd,dhe->bshe", h, p["wq"].to(cfg.dtype))
    o = attention(q, ek, ev, causal=False, chunk=cfg.attn_chunk, matmul_bf16=cfg.attn_matmul_bf16)
    return torch.einsum("bshe,hed->bsd", o, p["wo"].to(cfg.dtype))


def _cross_attend(blk, x, enc_out, cfg, rules, cross_kv=None):
    """x + cross-attention to the encoder: K/V from the encoder output
    (training, prefill) or the cache entry ``cross_kv`` (decode).  Returns
    (x, the K/V attended)."""
    h = L.apply_norm(blk["ln_x"], x, cfg)
    p = blk["cross_attn"]
    mesh = mesh_for(rules)
    if mesh is None:
        # the encoder output through a view: a layer's K and V gradients are summed before they join the
        # other layers', as the mesh path's region sums them (so a mesh of one gives the same bits)
        kv = _enc_kv(p, enc_out.view_as(enc_out), cfg) if cross_kv is None else cross_kv
        return x + _cross_core(p, h, *kv, cfg), kv
    if cross_kv is None:
        out, kv = _cross_on_mesh(p, h, enc_out, cfg, rules, mesh)
    else:
        out, kv = _cross_decode_on_mesh(p, h, cross_kv, cfg, rules, mesh), cross_kv
    return x + shard(out, rules, "batch", "seq", None), kv


def _cross_on_mesh(p, h, enc_out, cfg, rules, mesh):
    """Training's and prefill's cross-attention: one region in which each
    rank computes its query heads from its rows of ``h`` and the same
    heads' K/V from its rows of the encoder output, gathered whole along
    the frames, attends and projects; the output is a partial sum over
    the tensor axis.  Under ``heads=None`` or SP (``h`` split along its
    sequence) the weights are taken whole: each rank computes every head,
    its queries from its own chunk of positions, and K/V from the whole
    encoder output (no mask, no offset).  Without autograd recording
    (prefill) the region also returns the K/V, laid out as the rows and
    the ``wk`` heads; while it records, (output, None)."""
    keys = ("wq", "wk", "wv", "wo")
    with_kv = not torch.is_grad_enabled()

    def body(h, *rest):
        w, enc = dict(zip(keys, rest[:4])), rest[4]
        ek, ev = _enc_kv(w, enc, cfg)
        out = _cross_core(w, h, ek, ev, cfg)
        return (out, ek, ev) if with_kv else out

    ws = [p[k].to(cfg.dtype) for k in keys]
    es = axes_of(enc_out, mesh)
    frames = Spec(es[0], None, None)
    whole = heads_whole(rules) or rules.tensor in spec_axes(axes_of(h, mesh))
    if not with_kv:
        return tp_region(body, h, ws, rules, mesh, inputs=((enc_out, frames),), whole=whole), None
    split = not whole and on_tensor_axis(p["wk"], rules, mesh)
    kv = Spec(es[0], None, rules.tensor if split else None, None)
    out, ek, ev = tp_region(body, h, ws, rules, mesh, extra=(kv, kv), inputs=((enc_out, frames),), whole=whole)
    return out, (ek, ev)


def _cross_decode_on_mesh(p, h, cross_kv, cfg, rules, mesh):
    """A decode step's cross-attention over the cached K/V: one region on
    each rank's rows, heads and cache shard; nothing is written.  With the
    frames split over ``kv_seq``, each rank attends over its own frames
    (``attention_with_lse``, their positions explicit, no mask) and
    ``lse_combine`` joins the slices.  ``wq`` and ``wo`` keep their
    tensor-axis split where the cache keeps the heads split over it; else
    they are taken whole."""
    ek = cross_kv[0]
    axes, lo, _ = seq_shard(ek)
    split = axes_of(ek, mesh)[2] == rules.tensor
    ws = [p[k].to(cfg.dtype) for k in ("wq", "wo")]
    specs = [tp_spec(w, rules, mesh) if split else Spec() for w in ws]
    partial = (rules.tensor,) if any(any(e is not None for e in s) for s in specs) else ()

    def body(h, wq, wo, ek, ev):
        if not axes:
            return _cross_core({"wq": wq, "wo": wo}, h, ek, ev, cfg)
        q = torch.einsum("bsd,dhe->bshe", h, wq)
        o, lse = attention_with_lse(q, ek, ev, k_positions=torch.arange(lo, lo + ek.shape[1], device=ek.device))
        o = lse_combine(o, lse, mesh, axes).to(q.dtype)
        return torch.einsum("bshe,hed->bsd", o, wo)

    hs = axes_of(h, mesh)
    return region(body, (h, *ws, *cross_kv), (hs, *specs, *(axes_of(c, mesh) for c in cross_kv)), (hs,),
                  partial=partial, mesh=mesh)


def _decoder_layer(blk, x, enc_out, cfg, rules, *, positions, cache_kv=None, pos=None, cross_kv=None):
    """One decoder layer: self-attention, cross-attention, MLP.  Returns
    (x, the self-attention keys as ``apply_attn_block`` gives them, the
    cross-attention K/V)."""
    h = L.apply_norm(blk["ln1"], x, cfg)
    a, kv = apply_attn_block(
        blk["self_attn"], h, cfg, rules, positions=positions, window=0, theta=cfg.rope_theta,
        cache_kv=cache_kv, pos=pos,
    )
    x, ekv = _cross_attend(blk, x + a, enc_out, cfg, rules, cross_kv)
    h2 = L.apply_norm(blk["ln2"], x, cfg)
    return x + L.apply_mlp(blk["mlp"], h2, cfg, rules), kv, ekv


def _decoder_in(params, tokens, cfg, rules, start: int = 0):
    """The token embeddings plus the sinusoid rows from ``start``."""
    x = L.embed_tokens(params["embedding"], tokens, cfg, rules)
    return _plus_positions(x, _positions(tokens.shape[1], cfg, tokens.device, start), rules)


def _logits(params, x, cfg, rules):
    return L.unembed(params["embedding"], L.apply_norm(params["final_norm"], x, cfg), cfg, rules)


def forward(params, batch, cfg: ModelConfig, rules: AxisRules = NO_SHARD):
    """Training forward: batch = {'enc_frames': (B,F,d), 'tokens': (B,S)}.
    Every encoder and decoder layer runs under ``remat``."""
    enc_out = encode(params, batch["enc_frames"], cfg, rules)
    tokens = batch["tokens"]
    x = _decoder_in(params, tokens, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def body(x, blk):
        return _decoder_layer(blk, x, enc_out, cfg, rules, positions=positions)[0]

    for blk in unstack(params["dec_blocks"], cfg.num_layers):
        x = remat(body, cfg, x, blk)
    mesh = mesh_for(rules)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device) if mesh is None else mesh_zeros(mesh)
    return _logits(params, x, cfg, rules), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device) -> dict:
    dtype = dtype or cfg.dtype
    KV, hd, F, Lc = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.encoder_seq_len, cfg.num_layers

    def zeros(n):
        return torch.zeros((Lc, batch, n, KV, hd), dtype=dtype, device=device)

    return {"self": (zeros(max_len), zeros(max_len)), "cross": (zeros(F), zeros(F))}


def prefill(params, batch, cfg: ModelConfig, rules: AxisRules, cache: dict):
    """Encode, then run the decoder prompt.  Returns (last logits, cache):
    the self-attention keys written into a copy of ``cache["self"]``, the
    cross-attention K/V of every layer as the new ``cache["cross"]``.
    Over a mesh, under ``no_grad`` on inputs laid out as the reference's
    jitted prefill takes them; each layer's K/V are written into copies
    of both cache entries, laid out by ``cache_specs``."""
    mesh = mesh_for(rules)
    if mesh is not None:
        with torch.no_grad():
            params, batch, cache = _serve_inputs(params, batch, cache, cfg, rules, mesh)
            return _prefill(params, batch, cfg, rules, cache, mesh)
    return _prefill(params, batch, cfg, rules, cache, None)


def _prefill(params, batch, cfg, rules, cache, mesh):
    enc_out = encode(params, batch["enc_frames"], cfg, rules)
    tokens = batch["tokens"]
    x = _decoder_in(params, tokens, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    own = tree_map(clone, cache["self"])
    cross = tree_map(clone, cache["cross"]) if mesh is not None else None
    eks, evs = [], []
    for i, blk in enumerate(unstack(params["dec_blocks"], cfg.num_layers)):
        x, kv, ekv = _decoder_layer(blk, x, enc_out, cfg, rules, positions=positions)
        if mesh is not None:
            _write_prompt_on_mesh(layer(own, i), kv, cfg, mesh)
            _write_prompt_on_mesh(layer(cross, i), ekv, cfg, mesh)
            continue
        for dst, src in zip(layer(own, i), kv):
            put(dst, src.to(dst.dtype), 0)
        eks.append(ekv[0])
        evs.append(ekv[1])
    if mesh is None:
        cross = (torch.stack(eks), torch.stack(evs))
    logits = _logits(params, last_position(x), cfg, rules)
    return whole(logits)[:, 0], {"self": own, "cross": cross}


def decode_step(params, tokens, cfg: ModelConfig, rules: AxisRules, cache: dict, pos: int):
    """One token for every sequence against the cached encoder K/V.  The
    sinusoid row is the table's row at ``pos`` clamped into the table, as
    the reference's ``dynamic_slice_in_dim`` clamps it.  Over a mesh each
    layer's self-attention writes its cache shards in place (in a copy)
    and its cross-attention reads its shards of the cross cache."""
    mesh = mesh_for(rules)
    if mesh is not None:
        with torch.no_grad():
            params, batch, cache = _serve_inputs(params, {"tokens": tokens}, cache, cfg, rules, mesh)
            return _decode_step(params, batch["tokens"], cfg, rules, cache, pos)
    return _decode_step(params, tokens, cfg, rules, cache, pos)


def _decode_step(params, tokens, cfg, rules, cache, pos):
    x = _decoder_in(params, tokens, cfg, rules, min(max(pos, 0), cfg.max_seq_len - 1))
    own = tree_map(clone, cache["self"])
    for i, blk in enumerate(unstack(params["dec_blocks"], cfg.num_layers)):
        x, _, _ = _decoder_layer(blk, x, None, cfg, rules, positions=None, cache_kv=layer(own, i), pos=pos,
                                 cross_kv=layer(cache["cross"], i))
    return whole(_logits(params, x, cfg, rules))[:, 0], {"self": own, "cross": cache["cross"]}
