"""gemma3-4b [dense; hf:google/gemma-3-4b-pt]: 34L, d=2560, 8H (GQA kv=4),
head_dim=256, d_ff=10240, vocab=262144.  5 local (window 1024) : 1 global
layer pattern; local layers rope theta 10k, global 1M; QK-norm; embeddings
scaled by sqrt(d).  long_500k note: only the ~6 global layers hold a full
500k KV (seq-sharded); local layers cache one window — see DESIGN.md §5."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        qk_norm=True,
        embed_scale=True,
        window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
        rope_theta=10000.0,
        rope_theta_global=1e6,
        tie_embeddings=True,
        max_seq_len=524288 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, window_pattern=(32, 32, 32, 0),
        max_seq_len=128, attn_chunk=32,
    )
