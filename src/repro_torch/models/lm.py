"""Decoder-only LMs of the ``dense`` and ``moe`` families: GQA or MLA
attention, a SwiGLU/GELU MLP or an MoE layer.

The port's copy of ``repro.models.lm`` for the families ported so far;
the ``ssm``, ``hybrid``, ``encdec`` and ``vlm`` families raise
``NotImplementedError`` (``configs.registry.check_family``).  Layers keep
the reference's stacked leading-L parameter layout and run in a Python
loop over that axis (the reference's ``lax.scan``); each layer's window
and rope theta ride along as Python values.

API (plain functions on tensors; the device is that of the parameters):
  init(cfg, generator)                           → params
  forward(params, batch, cfg, rules)             → (logits (B,S,V), aux_loss)
  init_cache(cfg, batch, max_len, *, device)     → cache
  prefill(params, batch, cfg, rules, cache)      → (last_logits (B,V), cache)
  decode_step(params, tokens, cfg, rules, cache, pos) → (logits (B,V), cache)

``prefill`` and ``decode_step`` leave the cache they are given as it was
and return a new one, as the reference's functional updates do: each
copies the cache once and writes every layer's keys into the copy.
Writes are clamped into the cache as ``dynamic_update_slice`` clamps them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import check_family
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.attention import RING_INVALID, attention
from repro_torch.models.common import NO_SHARD, AxisRules, const_init, dense_init, layer, put, shard, tree_map
from repro_torch.models.rope import apply_rope


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


def _qkv(p, x, cfg, *, positions, theta):
    dt = cfg.dtype
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = L.rms_norm_head(q, p["q_norm"].to(torch.float32))
        k = L.rms_norm_head(k, p["k_norm"].to(torch.float32))
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def apply_attn_block(p, x, cfg, rules, *, positions, window, theta, cache_kv=None, pos=None):
    """Attention sublayer.  Train/prefill when ``cache_kv`` is None (returns
    the full-sequence (k, v) for cache building); else one decode step that
    writes this step's keys into the cache tensors in place and returns them."""
    q, k, v = _qkv(p, x, cfg, positions=positions, theta=theta)
    if cache_kv is None:
        out = attention(q, k, v, causal=True, window=window, chunk=cfg.attn_chunk, matmul_bf16=cfg.attn_matmul_bf16)
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
    out = torch.einsum("bshe,hed->bsd", out, p["wo"].to(cfg.dtype))
    return shard(out, rules, "batch", "seq", None), new_kv


# ================================================================ blocks
def init_blocks(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Every layer's parameters, stacked on a leading L axis."""
    lead, d = (cfg.num_layers,), cfg.d_model
    blk = {"ln1": L.init_norm(d, cfg, gen.device, lead=lead), "ln2": L.init_norm(d, cfg, gen.device, lead=lead)}
    blk["attn"] = MLA.init_mla(gen, cfg, lead=lead) if cfg.mla.kv_lora_rank else init_attn(gen, cfg, lead=lead)
    if cfg.is_moe:
        blk["moe"] = MOE.init_moe(gen, cfg, lead=lead)
    else:
        blk["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg, lead=lead)
    return blk


def apply_block(blk, x, cfg, rules, *, positions, window, theta, aux, cache=None, pos=None):
    """One decoder layer.  Returns (x, aux, new_cache)."""
    h = L.apply_norm(blk["ln1"], x, cfg)
    if cfg.mla.kv_lora_rank:
        if cache is None:
            a, new_cache = MLA.mla_attention(blk["attn"], h, cfg, rules, positions=positions, chunk=cfg.attn_chunk)
        else:
            a, new_cache = MLA.mla_decode(blk["attn"], h, cfg, rules, cache=cache, pos=pos)
    else:
        a, new_cache = apply_attn_block(
            blk["attn"], h, cfg, rules, positions=positions, window=window, theta=theta, cache_kv=cache, pos=pos,
        )
    x = x + a
    h2 = L.apply_norm(blk["ln2"], x, cfg)
    if cfg.is_moe:
        y, aux_l = MOE.apply_moe(blk["moe"], h2, cfg, rules)
        aux = aux + aux_l
    else:
        y = L.apply_mlp(blk["mlp"], h2, cfg, rules)
    return x + y, aux, new_cache


# ==================================================================== init
def init(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters on ``generator``'s device, drawn from it."""
    check_family(cfg)
    return {
        "embedding": L.init_embedding(generator, cfg),
        "final_norm": L.init_norm(cfg.d_model, cfg, generator.device),
        "blocks": init_blocks(generator, cfg),
    }


# leaves that ``ModelConfig.param_count`` leaves out: norms and biases
_UNCOUNTED = {"scale", "bias", "q_norm", "k_norm", "bq", "bk", "bv", "bi", "bo"}


def counted_params(params) -> int:
    """The parameters ``ModelConfig.param_count()`` counts: every weight
    matrix, without norm scales and biases."""
    if isinstance(params, dict):
        return sum(0 if k in _UNCOUNTED else counted_params(v) for k, v in params.items())
    return params.numel()


def _layers(params, cfg):
    """(layer params, window, rope theta) of every layer, in order."""
    tg = cfg.rope_theta_global or cfg.rope_theta
    for i in range(cfg.num_layers):
        w = cfg.layer_window(i)
        yield layer(params["blocks"], i), w, (tg if w == 0 else cfg.rope_theta)


def _embed_in(params, tokens, cfg, rules):
    x = L.embed_tokens(params["embedding"], tokens, cfg, rules)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype, device=x.device)
    return x


def _logits(params, x, cfg, rules):
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embedding"], x, cfg, rules)


# ==================================================================== forward
def forward(params, batch, cfg: ModelConfig, rules: AxisRules = NO_SHARD):
    """Training forward: returns (logits (B,S,V), aux_loss)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = _embed_in(params, tokens, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk, w, th in _layers(params, cfg):
        x, aux, _ = apply_block(blk, x, cfg, rules, positions=positions, window=w, theta=th, aux=aux)
    return _logits(params, x, cfg, rules), aux


# ================================================================ serve paths
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device) -> dict:
    """Per-layer cache stacked on a leading L axis."""
    check_family(cfg)
    dtype = dtype or cfg.dtype
    Lc = cfg.num_layers
    if cfg.mla.kv_lora_rank:
        return {"layers": MLA.init_mla_cache(cfg, batch, max_len, dtype, device, lead=(Lc,))}
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
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
    latent) go into the new cache as that layer finishes, which gives the
    reference's cache with and without ``prefill_inscan_cache``.
    """
    check_family(cfg)
    tokens = batch["tokens"]
    x = _embed_in(params, tokens, cfg, rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    cache = tree_map(torch.clone, cache)
    for i, (blk, w, th) in enumerate(_layers(params, cfg)):
        x, aux, kv = apply_block(blk, x, cfg, rules, positions=positions, window=w, theta=th, aux=aux)
        entry = layer(cache["layers"], i)
        if cfg.mla.kv_lora_rank:
            put(entry["c"], kv[0].to(entry["c"].dtype), 0)
            put(entry["kr"], kv[1].to(entry["kr"].dtype), 0)
        elif cfg.decode_window_cache:
            _fill_ring(*entry, *kv)
        else:
            put(entry[0], kv[0].to(entry[0].dtype), 0)
            put(entry[1], kv[1].to(entry[1].dtype), 0)
    logits = _logits(params, x[:, -1:], cfg, rules)
    return logits[:, 0], cache


def decode_step(params, tokens, cfg: ModelConfig, rules: AxisRules, cache: dict, pos: int):
    """One token for every sequence.  tokens: (B, 1); pos: the position."""
    check_family(cfg)
    x = _embed_in(params, tokens, cfg, rules)
    positions = torch.tensor([pos], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    cache = tree_map(torch.clone, cache)
    for i, (blk, w, th) in enumerate(_layers(params, cfg)):
        x, _, _ = apply_block(
            blk, x, cfg, rules, positions=positions, window=w, theta=th, aux=aux,
            cache=layer(cache["layers"], i), pos=pos,
        )
    logits = _logits(params, x, cfg, rules)
    return logits[:, 0], cache
