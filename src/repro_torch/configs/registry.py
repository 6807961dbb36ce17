"""Architecture registry: ``--arch <id>`` → config and model API.

The port's copy of ``repro.configs.registry``.  ``get_model_api`` returns
the port's decoder LM (``repro_torch.models.lm``) for the ``dense`` and
``moe`` families, the ones ported so far; the other four families raise
``NotImplementedError`` naming their ROADMAP item.  The dry-run's part of
the registry (``input_specs``, ``cell_supported`` and the cell lists)
waits for the dry-run.
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

# Families whose model code is ported, and where the others wait.
PORTED_FAMILIES = ("dense", "moe")
FAMILY_TODO = {
    "ssm": "the ssm family (mamba2) is not ported yet (ROADMAP.md, Queue 1, 'Model layer')",
    "hybrid": "the hybrid family (zamba2) is not ported yet (ROADMAP.md, Queue 1, 'Model layer')",
    "encdec": "the encdec family (whisper) is not ported yet (ROADMAP.md, Queue 1, 'Model layer')",
    "vlm": "the vlm family (qwen2-vl) is not ported yet (ROADMAP.md, Queue 1, 'Model layer')",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(FAMILY_TODO.get(cfg.family, f"unknown family {cfg.family!r}"))


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(ARCHS[arch])
    return mod.smoke_config() if smoke else mod.config()


def get_model_api(cfg: ModelConfig):
    """→ module with init/forward/init_cache/prefill/decode_step."""
    check_family(cfg)
    from repro_torch.models import lm

    return lm

