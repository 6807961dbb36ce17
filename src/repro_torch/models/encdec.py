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
from repro_torch.models.attention import attention
from repro_torch.models.common import (
    NO_SHARD,
    AxisRules,
    layer,
    prepend_none_spec,
    put,
    shard,
    tree_map,
    unported_on_mesh,
    unstack,
)
from repro_torch.models.lm import apply_attn_block, attn_specs, init_attn, remat
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


def encode(params, frames, cfg, rules: AxisRules):
    """frames: (B, F, d) stub embeddings → the encoder output (B, F, d);
    each layer under ``remat``."""
    unported_on_mesh("the encdec family", rules, "1c")
    x = frames.to(cfg.dtype) + _positions(frames.shape[1], cfg, frames.device)
    x = shard(x, rules, "batch", "seq", None)
    dt = cfg.dtype

    def body(x, blk):
        h = L.apply_norm(blk["ln1"], x, cfg)
        q, k, v = (torch.einsum("bsd,dhe->bshe", h, blk["attn"][w].to(dt)) for w in ("wq", "wk", "wv"))
        o = attention(q, k, v, causal=False, chunk=cfg.attn_chunk, matmul_bf16=cfg.attn_matmul_bf16)
        x = x + torch.einsum("bshe,hed->bsd", o, blk["attn"]["wo"].to(dt))
        h2 = L.apply_norm(blk["ln2"], x, cfg)
        return x + L.apply_mlp(blk["mlp"], h2, cfg, rules)

    for blk in unstack(params["enc_blocks"], cfg.encoder_layers):
        x = remat(body, cfg, x, blk)
    return L.apply_norm(params["enc_norm"], x, cfg)


def _cross_attend(blk, x, enc_kv, cfg, rules):
    h = L.apply_norm(blk["ln_x"], x, cfg)
    q = torch.einsum("bsd,dhe->bshe", h, blk["cross_attn"]["wq"].to(cfg.dtype))
    ek, ev = enc_kv
    o = attention(q, ek, ev, causal=False, chunk=cfg.attn_chunk, matmul_bf16=cfg.attn_matmul_bf16)
    return x + torch.einsum("bshe,hed->bsd", o, blk["cross_attn"]["wo"].to(cfg.dtype))


def _enc_kv(blk, enc_out, cfg):
    ek = torch.einsum("bsd,dhe->bshe", enc_out, blk["cross_attn"]["wk"].to(cfg.dtype))
    ev = torch.einsum("bsd,dhe->bshe", enc_out, blk["cross_attn"]["wv"].to(cfg.dtype))
    return ek, ev


def _decoder_layer(blk, x, enc_kv, cfg, rules, *, positions, cache_kv=None, pos=None):
    """One decoder layer: self-attention, cross-attention, MLP.  Returns
    (x, the self-attention keys as ``apply_attn_block`` gives them)."""
    h = L.apply_norm(blk["ln1"], x, cfg)
    a, kv = apply_attn_block(
        blk["self_attn"], h, cfg, rules, positions=positions, window=0, theta=cfg.rope_theta,
        cache_kv=cache_kv, pos=pos,
    )
    x = _cross_attend(blk, x + a, enc_kv, cfg, rules)
    h2 = L.apply_norm(blk["ln2"], x, cfg)
    return x + L.apply_mlp(blk["mlp"], h2, cfg, rules), kv


def forward(params, batch, cfg: ModelConfig, rules: AxisRules = NO_SHARD):
    """Training forward: batch = {'enc_frames': (B,F,d), 'tokens': (B,S)}.
    Every encoder and decoder layer runs under ``remat``."""
    unported_on_mesh("the encdec family", rules, "1c")
    enc_out = encode(params, batch["enc_frames"], cfg, rules)
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embedding"], tokens, cfg, rules) + _positions(tokens.shape[1], cfg, tokens.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def body(x, blk):
        return _decoder_layer(blk, x, _enc_kv(blk, enc_out, cfg), cfg, rules, positions=positions)[0]

    for blk in unstack(params["dec_blocks"], cfg.num_layers):
        x = remat(body, cfg, x, blk)
    logits = L.unembed(params["embedding"], L.apply_norm(params["final_norm"], x, cfg), cfg, rules)
    return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device) -> dict:
    dtype = dtype or cfg.dtype
    KV, hd, F, Lc = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.encoder_seq_len, cfg.num_layers

    def zeros(n):
        return torch.zeros((Lc, batch, n, KV, hd), dtype=dtype, device=device)

    return {"self": (zeros(max_len), zeros(max_len)), "cross": (zeros(F), zeros(F))}


def prefill(params, batch, cfg: ModelConfig, rules: AxisRules, cache: dict):
    """Encode, then run the decoder prompt.  Returns (last logits, cache):
    the self-attention keys written into a copy of ``cache["self"]``, the
    cross-attention K/V of every layer as the new ``cache["cross"]``."""
    unported_on_mesh("the encdec family", rules, "1c")
    enc_out = encode(params, batch["enc_frames"], cfg, rules)
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embedding"], tokens, cfg, rules) + _positions(tokens.shape[1], cfg, tokens.device)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    ck, cv = tree_map(torch.clone, cache["self"])
    eks, evs = [], []
    for i in range(cfg.num_layers):
        blk = layer(params["dec_blocks"], i)
        ekv = _enc_kv(blk, enc_out, cfg)
        x, (k, v) = _decoder_layer(blk, x, ekv, cfg, rules, positions=positions)
        put(ck[i], k.to(ck.dtype), 0)
        put(cv[i], v.to(cv.dtype), 0)
        eks.append(ekv[0])
        evs.append(ekv[1])
    x = L.apply_norm(params["final_norm"], x[:, -1:], cfg)
    logits = L.unembed(params["embedding"], x, cfg, rules)
    return logits[:, 0], {"self": (ck, cv), "cross": (torch.stack(eks), torch.stack(evs))}


def decode_step(params, tokens, cfg: ModelConfig, rules: AxisRules, cache: dict, pos: int):
    """One token for every sequence against the cached encoder K/V.  The
    sinusoid row is the table's row at ``pos`` clamped into the table, as
    the reference's ``dynamic_slice_in_dim`` clamps it."""
    unported_on_mesh("the encdec family", rules, "1c")
    row = min(max(pos, 0), cfg.max_seq_len - 1)
    x = L.embed_tokens(params["embedding"], tokens, cfg, rules) + _positions(1, cfg, tokens.device, row)
    sk, sv = tree_map(torch.clone, cache["self"])
    ek, ev = cache["cross"]
    for i in range(cfg.num_layers):
        x, _ = _decoder_layer(
            layer(params["dec_blocks"], i), x, (ek[i], ev[i]), cfg, rules, positions=None,
            cache_kv=(sk[i], sv[i]), pos=pos,
        )
    logits = L.unembed(params["embedding"], L.apply_norm(params["final_norm"], x, cfg), cfg, rules)
    return logits[:, 0], {"self": (sk, sv), "cross": cache["cross"]}
