"""Next-token cross-entropy with z-loss: the port's copy of ``repro.train.loss``."""

from __future__ import annotations

import torch


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 1e-4):
    """logits (B,S,V) vs labels (B,S).  Returns (loss, metrics), in float32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    z = z_loss * torch.square(lse)
    loss = torch.mean(nll + z)
    return loss, {
        "ce": torch.mean(nll),
        "z_loss": torch.mean(z),
        "accuracy": torch.mean((torch.argmax(lf, -1) == labels).to(torch.float32)),
    }
