"""mamba2-370m [ssm; arXiv:2405.21060]: 48L, d=1024, attention-free,
ssm_state=128, vocab=50280.  SSD (state-space duality) blocks; decode is a
constant-memory state update — long_500k is the showcase shape."""

from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=1,  # unused (attention-free)
        num_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
        max_seq_len=524288 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, vocab_size=512, max_seq_len=128,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk_size=32),
    )
