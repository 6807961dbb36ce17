"""Architecture registry: ``--arch <id>`` → config, model API, input specs.

The port's copy of ``repro.configs.registry``.  ``get_model_api`` returns
the port's encoder-decoder (``repro_torch.models.encdec``) for the
``encdec`` family and its decoder LM (``repro_torch.models.lm``) for the
other five, as the reference does.

``input_specs(cfg, shape)`` returns meta tensors (shape and dtype, no
storage) for every model input of that (arch × shape) cell, which the
dry-run (``repro_torch.launch.dryrun``) traces: the reference's
``jax.ShapeDtypeStruct`` stand-ins, with token ids and labels int64 where
the reference's are int32 (the port's models index with int64), M-RoPE
positions int32 and the stub frontends' frames and embeddings bf16.

``cell_supported(arch, shape)`` encodes the assignment's skip rules:
``long_500k`` only for sub-quadratic attention (mamba2, zamba2, mixtral
SWA, gemma3 local:global); pure full-attention archs skip it.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCHS: dict[str, str] = {
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

# archs with sub-quadratic (or windowed/local) attention → run long_500k
LONG_CONTEXT_OK = {"mamba2-370m", "zamba2-2.7b", "mixtral-8x22b", "gemma3-4b"}

# The model families the port runs: every family of ``ModelConfig``.
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family no model code runs."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"unknown family {cfg.family!r}")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(ARCHS[arch])
    return mod.smoke_config() if smoke else mod.config()


def get_model_api(cfg: ModelConfig):
    """→ module with init/forward/init_cache/prefill/decode_step."""
    check_family(cfg)
    if cfg.family == "encdec":
        from repro_torch.models import encdec

        return encdec
    from repro_torch.models import lm

    return lm


def cell_supported(arch: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: long_500k skipped per assignment"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]


def supported_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if cell_supported(a, s)[0]]


# --------------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for the *batch* argument of train/prefill/decode."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int64
    if shape.kind == "train":
        specs = {"tokens": _meta((B, S), tok), "labels": _meta((B, S), tok)}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((B, S), tok)}
    else:  # decode: one new token against a seq_len-deep cache
        specs = {"tokens": _meta((B, 1), tok)}
    if cfg.family == "encdec":
        specs["enc_frames"] = _meta((B, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16)
        specs.pop("labels", None)
        if shape.kind == "train":
            specs["labels"] = _meta((B, S), tok)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["vision_embeds"] = _meta((B, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        specs["positions_thw"] = _meta((3, B, S), torch.int32)
    return specs


def shape_for(name: str) -> ShapeConfig:
    return SHAPES[name]
