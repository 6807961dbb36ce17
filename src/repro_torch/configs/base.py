"""Config system: one dataclass family covers all 10 assigned architectures.

The port's copy of ``repro.configs.base``: ``ModelConfig`` is one wide
dataclass (MaxText-style) rather than per-family classes, every field has
a safe default and each arch file sets only what it needs.  ``dtype`` and
``param_dtype`` are torch dtypes (bf16 compute, f32 weights);
``param_count()`` is the reference's, line for line.  ``RunConfig``
holds the reference's execution knobs field for field; its mesh axes stay
the plain names they are until the dist path uses them.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0  # 0 → dense MLP
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    expert_d_ff: int = 0  # per-expert hidden (deepseek ≠ dense d_ff)
    shared_d_ff: int = 0
    router_aux_loss: float = 0.01
    # 'sorted' (paper technique) | 'argsort' (same ranks via one stable
    # argsort — bit-identical, DESIGN.md §12) | 'dense'
    dispatch: str = "sorted"
    capacity_factor: float = 1.25
    expert_parallel: bool = False  # experts divide the TP axis (deepseek 64e)
    # §Perf lever: shard the (E, C, d) dispatch buffer's token dim over the
    # batch axes (and E over TP when expert_parallel) — without it the
    # grouped expert matmul loses the data-parallel sharding entirely.
    dispatch_sharded: bool = False


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 0  # 0 → standard GQA attention
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    absorb: bool = False  # decode-time W_uk absorption (beyond-paper opt)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0  # 0 → no SSM layers
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int = 4
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0  # 0 → d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    max_seq_len: int = 131072

    # attention flavour
    qkv_bias: bool = False  # qwen1.5
    qk_norm: bool = False  # gemma3
    embed_scale: bool = False  # gemma3: embeddings × sqrt(d_model)
    use_rope: bool = True  # whisper: absolute sinusoidal instead
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0  # gemma3: different theta for global layers
    window_pattern: tuple[int, ...] = ()  # per-layer window; 0 = global; cycled
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (t,h,w) head_dim split
    attn_logit_softcap: float = 0.0

    # norm / activation
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (SwiGLU) | gelu
    tie_embeddings: bool = False

    moe: MoEConfig = MoEConfig()
    mla: MLAConfig = MLAConfig()
    ssm: SSMConfig = SSMConfig()

    # hybrid (zamba2): shared transformer block every k SSM blocks
    hybrid_period: int = 0  # 0 → not hybrid

    # enc-dec (whisper): encoder stack + cross attention
    encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper audio frames (stub frontend)

    # vlm (qwen2-vl): stub patch embeddings prepended
    vision_tokens: int = 0

    # numerics / execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024  # KV-chunked (online-softmax) attention block
    # ---- perf levers (§Perf hillclimbs; False = paper-faithful baseline)
    attn_matmul_bf16: bool = False  # QKᵀ and P·V on the MXU in bf16, f32 accum
    prefill_inscan_cache: bool = False  # write KV cache inside the layer scan
    # ring-buffer KV cache sized to the attention window (valid only when
    # EVERY layer is windowed, e.g. mixtral SWA): long_500k decode cache
    # shrinks from O(seq) to O(window)
    decode_window_cache: bool = False

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm.d_state > 0 and self.hybrid_period == 0

    @property
    def is_hybrid(self) -> bool:
        return self.hybrid_period > 0

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    def layer_window(self, layer: int) -> int:
        """Per-layer attention window (0 = global) from the cycled pattern."""
        if not self.window_pattern:
            return 0
        return self.window_pattern[layer % len(self.window_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline bookkeeping)."""
        d, L, hd = self.d_model, self.num_layers, self.resolved_head_dim
        nH, nKV = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            if self.mla.kv_lora_rank:
                r, dr = self.mla.kv_lora_rank, self.mla.qk_rope_head_dim
                dn, dv = self.mla.qk_nope_head_dim, self.mla.v_head_dim
                per_layer += d * nH * (dn + dr)  # W_q
                per_layer += d * (r + dr)  # W_dkv + W_kr
                per_layer += r * nH * (dn + dv)  # W_uk + W_uv
                per_layer += nH * dv * d  # W_o
            else:
                per_layer += d * nH * hd + 2 * d * nKV * hd + nH * hd * d
            if self.is_moe:
                e = self.moe
                per_layer += d * e.num_experts  # router
                per_layer += 3 * d * e.expert_d_ff * e.num_experts
                per_layer += 3 * d * e.shared_d_ff * e.num_shared_experts
            else:
                mult = 3 if self.act == "silu" else 2
                per_layer += mult * d * self.d_ff
        if self.family == "ssm" or self.is_hybrid:
            s = self.ssm
            din = self.d_inner
            nh = self.ssm_heads
            per_layer_ssm = d * (2 * din + 2 * s.n_groups * s.d_state + nh)
            per_layer_ssm += din * d  # out_proj
            per_layer_ssm += s.d_conv * (din + 2 * s.n_groups * s.d_state)
            if self.family == "ssm":
                per_layer = per_layer_ssm
            else:
                # hybrid: L ssm blocks + ONE shared attention+mlp block
                shared = (
                    2 * d * nH * hd + 2 * d * nKV * hd + nH * hd * d + 3 * d * self.d_ff
                )
                return emb + L * per_layer_ssm + shared
        total = emb + L * per_layer
        if self.family == "encdec":
            enc_layer = d * nH * hd * 2 + 2 * d * nKV * hd + 2 * d * self.d_ff
            cross = d * nH * hd + 2 * d * nKV * hd + nH * hd * d
            total += self.encoder_layers * enc_layer + L * cross
        return total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution-level knobs shared by train/serve/dryrun."""

    model: ModelConfig = ModelConfig()
    shape: ShapeConfig = SHAPES["train_4k"]
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    grad_accum: int = 1  # microbatches per step (activation-memory control)
    grad_accum_unroll: bool = False  # the reference's cost-calibration loop; the port always loops
    master_weights: bool = False  # bf16 params + f32 master in opt state
    seed: int = 0
    # distribution
    fsdp_axis: str = "data"
    tensor_axis: str = "model"
    batch_axes: tuple[str, ...] = ("pod", "data")
    # fault tolerance
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    # optimizer comms
    grad_compression: str = "none"  # none | int8
