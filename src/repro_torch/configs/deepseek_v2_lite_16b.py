"""deepseek-v2-lite-16b [moe; arXiv:2405.04434]: 27L, d=2048, 16H,
MLA kv_lora=512 (rope 64 / nope 128 / v 128), 64 routed experts top-6 +
2 shared, expert d_ff=1408, vocab=102400.

NOTE: the assignment line reads "2 shared+160 routed top-6" while also
stating "MoE 64e top-6"; DeepSeek-V2-Lite has 64 routed experts — we follow
the 64e reading (and the paper).  MLA's latent KV cache (576 dims/token)
is exercised by the decode shapes; ``mla.absorb`` is the beyond-paper
decode optimisation toggle."""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        rope_theta=10000.0,
        mla=MLAConfig(
            kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=64,
            num_experts_per_tok=6,
            num_shared_experts=2,
            expert_d_ff=1408,
            shared_d_ff=1408,
            dispatch="shard_map",  # production default — §Perf bonus cell
            expert_parallel=True,  # 64 experts divide the 16-way TP axis
        ),
        max_seq_len=32768 + 8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=512, max_seq_len=128, attn_chunk=32,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2,
                      num_shared_experts=2, expert_d_ff=32, shared_d_ff=32,
                      dispatch="sorted", capacity_factor=4.0),
    )
