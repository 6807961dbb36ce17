"""The benchmark's operation and byte counts against values worked by hand."""

from __future__ import annotations

import json
from pathlib import Path

from cardbench import work

ROOT = Path(__file__).resolve().parents[2]

SMOKE = {
    "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4, "vocab_size": 512,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "q_lora_rank": None,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 2, "moe_intermediate_size": 32,
    "intermediate_size": 96, "first_k_dense_replace": 0,
}


def test_train_step_flops_by_hand():
    # a token a layer: wq 2*64*4*24 + wdkv, wkr 2*64*40 + wuk, wuv 2*32*4*32 + wo 2*4*16*64 = 33,792;
    # router 2*64*8 + 4 experts * 3 * 2*64*32 = 50,176; head 2*64*512 = 65,536
    per_token = 2 * (33_792 + 50_176) + 65_536
    # 2 rows of 32: 528 causal pairs a row, 2*4*(16+8+16) operations a pair a layer
    scores = 2 * (2 * 528) * 320
    assert work.train_step_flops(SMOKE, {"batch": 2, "seq_len": 32}) == 3 * (64 * per_token + scores)


def test_train_step_flops_dense_leading_layer():
    dense = dict(SMOKE, first_k_dense_replace=1)
    extra = 64 * (3 * 2 * 64 * 96 - 50_176)  # layer 0 runs the dense MLP instead of the MoE layer
    assert work.train_step_flops(dense, {"batch": 2, "seq_len": 32}) == work.train_step_flops(
        SMOKE, {"batch": 2, "seq_len": 32}) + 3 * extra


def test_train_step_flops_at_the_cell():
    """DeepSeek-V2-Lite, 4 layers, 2 x 4,096: 28.708 T operations a step."""
    c = json.loads((ROOT / "cardbench/configs/deepseek-v2-lite-16b-4l.json").read_text())
    flops = work.train_step_flops(c, {"batch": 2, "seq_len": 4096})
    assert abs(flops - 28.708e12) < 0.001e12


def test_bytes_by_hand():
    assert work.sort_bytes(15_728_640, "int32") == 125_829_120
    assert work.sort_bytes(1000, "int64") == 16_000
    assert work.count_rank_bytes(49_152, 64) == 4 * (2 * 49_152 + 64)
    assert work.moe_assignments({"num_experts_per_tok": 6}, {"batch": 2, "seq_len": 4096}) == 49_152
