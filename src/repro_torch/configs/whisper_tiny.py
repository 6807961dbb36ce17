"""whisper-tiny [audio; arXiv:2212.04356]: 4L enc + 4L dec, d=384, 6H,
d_ff=1536, vocab=51865.  Conv frontend is a STUB — ``input_specs`` provides
precomputed (B, 1500, 384) frame embeddings per the assignment."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        num_layers=4,
        encoder_layers=4,
        encoder_seq_len=1500,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        norm="layernorm",
        act="gelu",
        use_rope=False,
        tie_embeddings=True,
        max_seq_len=32768 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, encoder_layers=2, encoder_seq_len=16, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512, max_seq_len=128,
        attn_chunk=32,
    )
