"""Architecture registry: ``--arch <id>`` → config and model API.

The port's copy of ``repro.configs.registry``.  ``get_model_api`` returns
the port's encoder-decoder (``repro_torch.models.encdec``) for the
``encdec`` family and its decoder LM (``repro_torch.models.lm``) for the
other five, as the reference does.  The dry-run's part of the registry
(``input_specs``, ``cell_supported`` and the cell lists) waits for the
dry-run.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

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

