"""mixtral-8x22b [moe; arXiv:2401.04088]: 56L, d=6144, 48H (GQA kv=8),
d_ff=16384, vocab=32768, 8 experts top-2, sliding-window attention.

The MoE layer uses the framework's **sort-based dispatch** — the paper's
Array Division Procedure applied to expert ids (DESIGN.md §3)."""

from repro_torch.configs.base import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        rope_theta=1e6,
        window_pattern=(4096,),  # SWA on every layer
        moe=MoEConfig(
            num_experts=8,
            num_experts_per_tok=2,
            expert_d_ff=16384,
            # production default: shard_map dispatch (tokens stay local,
            # one intra-pod psum) — §Perf Cell 3.  Revert: --levers paperbase
            dispatch="shard_map",
        ),
        # SWA everywhere → ring-buffer decode cache (§Perf Cell 1)
        decode_window_cache=True,
        max_seq_len=524288 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, window_pattern=(32,), max_seq_len=128, attn_chunk=32,
        moe=MoEConfig(
            num_experts=4, num_experts_per_tok=2, expert_d_ff=64,
            dispatch="sorted", capacity_factor=4.0,
        ),
    )
