"""minitron-4b [dense; arXiv:2407.14679]: pruned nemotron — 32L, d=3072,
24H (GQA kv=8), d_ff=9216, vocab=256000.  Nemotron uses a 2-matrix
(squared-ReLU) MLP; we use the gelu 2-matrix MLP (same shape/FLOPs)."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        act="gelu",
        rope_theta=10000.0,
        max_seq_len=32768 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128, attn_chunk=32,
    )
