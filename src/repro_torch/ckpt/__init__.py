"""Checkpoints of the port: a copy of ``repro.ckpt``."""

from repro_torch.ckpt.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
