"""qwen1.5-110b [dense; hf:Qwen/Qwen1.5-110B]: 80L, d=8192, 64H (GQA kv=8),
d_ff=49152, vocab=152064, QKV bias.  The heaviest assigned config —
the FSDP×TP memory stress test of the dry-run."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        max_seq_len=32768 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, max_seq_len=128, attn_chunk=32,
    )
