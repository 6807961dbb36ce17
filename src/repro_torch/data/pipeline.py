"""Deterministic synthetic LM data pipeline.

The port's copy of ``repro.data.pipeline``.  Checkpointable by
construction: batch ``i`` is a pure function of (seed, i), made with the
reference's numpy calls, so restoring a run at step N reproduces the exact
token stream — the pipeline state in a checkpoint is just the step counter.

Batches are tensors on ``device``: tokens and labels as int64 (the index
type torch wants), the encdec family's ``enc_frames`` and the vlm
family's ``vision_embeds`` in ``cfg.dtype`` and its ``positions_thw`` as
int32.  The float64 normals reach ``cfg.dtype`` through float32 on the
host, the route ``jnp.asarray(..., dtype=bfloat16)`` takes, so bf16
frames equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0  # checkpointable pipeline state
    device: "torch.device | str" = "cpu"

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        # zipf-flavoured marginals ≈ natural-language token frequencies
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1)).astype(np.int64)
        return (z % self.cfg.vocab_size).astype(np.int32)

    def _normal(self, tag: int, width: int) -> torch.Tensor:
        rng = np.random.default_rng((self.seed, self.step, tag))
        x = rng.normal(0, 1, (self.batch, width, self.cfg.d_model))
        return torch.from_numpy(x.astype(np.float32)).to(self.cfg.dtype).to(self.device)

    def next_batch(self) -> dict:
        t = torch.from_numpy(self._tokens(self.step)).long()
        self.step += 1
        batch = {"tokens": t[:, :-1].to(self.device), "labels": t[:, 1:].to(self.device)}
        cfg = self.cfg
        if cfg.family == "encdec":
            batch["enc_frames"] = self._normal(7, cfg.encoder_seq_len)
        if cfg.family == "vlm":
            batch["vision_embeds"] = self._normal(11, cfg.vision_tokens)
            pos = torch.arange(self.seq_len, dtype=torch.int32).repeat(3, self.batch, 1)
            batch["positions_thw"] = pos.to(self.device)
        return batch

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict):
        self.seed, self.step = int(state["seed"]), int(state["step"])
