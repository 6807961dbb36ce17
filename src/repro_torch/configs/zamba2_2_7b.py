"""zamba2-2.7b [hybrid; arXiv:2411.15242]: 54 Mamba2 blocks, d=2560,
ssm_state=64, plus ONE shared attention+MLP block (32H, d_ff=10240)
applied every 6 SSM blocks with the concat-embedding input (2d → d proj).
vocab=32000.  long_500k: SSM state is O(1); the shared attention block's
KV cache (9 applications × 500k) is seq-sharded — DESIGN.md §5."""

from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        hybrid_period=6,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
        max_seq_len=524288 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=4, hybrid_period=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        max_seq_len=128, attn_chunk=32,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk_size=32),
    )
