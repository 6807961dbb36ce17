"""The operations and bytes a call needs, from its shapes alone.

A roofline share divides the least time these take at the published
peaks (``hw.py``) by the device time a call took; an ``mfu`` divides the
model's operations by the step's time at the bf16 peak.  What a kernel's
algorithm does on top (a bitonic network's compare-exchanges, a
remat's recompute, the dispatch buffer's empty slots) is not work the
call needs, and is not counted.
"""

from __future__ import annotations

import numpy as np


def sort_bytes(n: int, dtype: str) -> int:
    """A device sort of ``n`` keys: each key read once and written once."""
    return 2 * n * np.dtype(dtype).itemsize


def count_rank_bytes(n_ids: int, n_buckets: int) -> int:
    """The count/rank kernel K1 on ``n_ids`` int32 ids: the ids read, one
    int32 rank an id and one int32 count a bucket written."""
    return 4 * (2 * n_ids + n_buckets)


def moe_assignments(config: dict, traffic: dict) -> int:
    """(token, expert choice) pairs of one MoE layer's forward."""
    return traffic["batch"] * traffic["seq_len"] * config["num_experts_per_tok"]


def train_step_flops(config: dict, traffic: dict) -> float:
    """Model operations of one training step of an MLA + MoE decoder
    (DeepSeek-V2): every matmul of the forward, with the active experts
    only (``num_experts_per_tok`` routed and ``n_shared_experts`` shared),
    the router and the output head; attention's scores and values over
    the causal half of each sequence (``S(S+1)/2`` query-key pairs); the
    whole times 3 for the backward.  Remat's recompute is not counted.
    Layers before ``first_k_dense_replace`` are dense MLPs of
    ``intermediate_size``.  Where the chip holds a share of the experts
    (``shares.n_routed_experts``: ``held`` of ``published``), the router
    keeps its ``published`` outputs and a token's routed experts computed
    here are ``num_experts_per_tok * held / published``, the expected
    share, fixed by the shapes; heads and rows of the vocabulary count as
    the file holds them."""
    c = config
    d, H, L, V = c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"], c["vocab_size"]
    r, dn, dr, dv = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    B, S = traffic["batch"], traffic["seq_len"]
    q_in = c["q_lora_rank"] or 0
    if q_in:  # a low-rank query: d -> q_lora_rank -> heads
        attn = 2 * (d * q_in + q_in * H * (dn + dr))
    else:
        attn = 2 * d * H * (dn + dr)
    attn += 2 * (d * (r + dr) + r * H * (dn + dv) + H * dv * d)
    experts = c["num_experts_per_tok"] + c["n_shared_experts"]
    router = c["n_routed_experts"]
    share = c.get("shares", {}).get("n_routed_experts")
    if share is not None:
        router = share["published"]
        experts = c["num_experts_per_tok"] * share["held"] / share["published"] + c["n_shared_experts"]
    moe = 2 * d * router + experts * 3 * 2 * d * c["moe_intermediate_size"]
    dense = 3 * 2 * d * c["intermediate_size"]
    k_dense = min(c["first_k_dense_replace"], L)
    per_token = k_dense * (attn + dense) + (L - k_dense) * (attn + moe) + 2 * d * V
    pairs = B * S * (S + 1) // 2
    scores = L * pairs * 2 * H * (dn + dr + dv)
    return 3.0 * (B * S * per_token + scores)
