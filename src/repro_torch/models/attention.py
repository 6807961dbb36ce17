"""Attention: GQA, per-layer windows, KV-chunked online softmax.

The port's copy of ``repro.models.attention``.  One implementation serves
every attention flavour of the ported archs: full causal, a sliding window
(``window`` > 0; 0 means global), decode against a padded KV cache with a
valid length, and a ring cache whose keys carry explicit positions.

Scores are materialised one KV chunk at a time with a running (max, sum,
acc) online softmax, the flash-attention recurrence in plain torch ops,
as the reference computes it in XLA outside any kernel.  The reference's
``matmul_bf16`` lever (QKᵀ and P·V on bf16 operands, float32 results)
runs here as float32 products of bf16-rounded operands, which is the same
arithmetic: a product of two bf16 values is exact in float32.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

RING_INVALID = -(1 << 30)  # kpos sentinel for never-written ring slots


def _chunk_mask(q_pos, k_pos, *, causal: bool, window, kv_len=None) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:  # None or 0 → global; else keys within the last ``window`` positions
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if kv_len is not None:
        m &= k_pos[None, :] < kv_len
    return m


def _operand(x: torch.Tensor, matmul_bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if matmul_bf16 else x.to(torch.float32)


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the reference's ``q * scale`` rounds the Python scale to q's dtype first
    return (q * torch.tensor(scale, dtype=q.dtype, device=q.device)).to(torch.float32)


def attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KVH, hd)
    v: torch.Tensor,  # (B, Sk, KVH, hd_v)
    *,
    causal: bool = True,
    window: "int | None" = None,
    q_offset: int = 0,  # start position of q within the sequence
    kv_len: "int | None" = None,
    chunk: int = 1024,
    scale: float | None = None,
    matmul_bf16: bool = False,
    k_positions: torch.Tensor | None = None,  # explicit key positions (ring cache)
) -> torch.Tensor:
    """Online-softmax attention, GQA via head grouping.  Returns (B,Sq,H,hd_v)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    hd_v = v.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    q_mm = _operand(_scaled(q, scale).reshape(B, Sq, KVH, G, hd), matmul_bf16)
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    chunk = min(chunk, Sk)
    m_run = torch.full((B, Sq, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, Sq, KVH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KVH, G, hd_v), dtype=torch.float32, device=q.device)
    # whole chunks, then the remainder, as the reference's scan and tail
    for start in range(0, Sk, chunk):
        stop = min(start + chunk, Sk)
        if k_positions is not None:
            k_pos = k_positions[start:stop]
        else:
            k_pos = torch.arange(start, stop, device=q.device)
        s = torch.einsum("bqkgh,bckh->bqkgc", q_mm, _operand(k[:, start:stop], matmul_bf16))
        mask = _chunk_mask(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgc,bckh->bqkgh", _operand(p, matmul_bf16), _operand(v[:, start:stop], matmul_bf16))
        acc = acc * corr[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)


def attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_len: "int | None" = None,
    scale: float | None = None,
    q_offset: int = 0,
    window: "int | None" = None,
    k_positions: torch.Tensor | None = None,
):
    """Decode attention returning (out, lse) for cross-shard combination:
    out = Σ exp(lse_i − lse*)·out_i / Σ exp(lse_i − lse*).

    The port's keys may carry explicit positions (``k_positions``: one
    shard's slice of a cache split along its sequence, or of a ring), and
    a query at ``q_offset`` then sees only keys less than ``window``
    positions behind it (0 or ``None``: all), as ``attention``'s mask
    without ``causal``."""
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else hd ** -0.5
    qf = _scaled(q, scale).reshape(B, Sq, KVH, G, hd)
    k_pos = torch.arange(k.shape[1], device=q.device) if k_positions is None else k_positions
    s = torch.einsum("bqkgh,bckh->bqkgc", qf, k.to(torch.float32))
    if kv_len is not None or window:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        mask = _chunk_mask(q_pos, k_pos, causal=False, window=window, kv_len=kv_len)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bqkgc,bckh->bqkgh", p, v.to(torch.float32))
    out = out / torch.clamp(l[..., None], min=1e-30)
    lse = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
    return out.reshape(B, Sq, H, v.shape[-1]), lse.reshape(B, Sq, H)
