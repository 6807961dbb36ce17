"""qwen2-vl-7b [vlm; arXiv:2409.12191]: 28L, d=3584, 28H (GQA kv=4),
d_ff=18944, vocab=152064, M-RoPE (sections 16/24/24 over head_dim 128),
dynamic resolution.  The vision tower is a STUB per the assignment:
``input_specs`` supplies precomputed patch embeddings (B, 1024, d) and the
(3, B, S) temporal/height/width position ids that M-RoPE consumes."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        vision_tokens=1024,
        max_seq_len=32768 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, mrope_sections=(4, 2, 2), vision_tokens=8,
        max_seq_len=128, attn_chunk=32,
    )
