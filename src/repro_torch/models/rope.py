"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

The port's copy of ``repro.models.rope``; angles are float32, as there.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    hd = x.shape[-1]
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    return _rotate(x, angles)


def apply_mrope(
    x: torch.Tensor,
    positions_thw: torch.Tensor,
    sections: tuple[int, ...],
    theta: float = 1000000.0,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    ``positions_thw``: (3, B, S) temporal/height/width position ids (text
    tokens have t == h == w).  ``sections`` splits the hd/2 frequency bands
    among the three axes (e.g. (16, 24, 24) for hd=128).
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} do not split head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    # per-frequency-band axis selector: band i uses positions_thw[sel[i]]
    sel = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device) for i, s in enumerate(sections)])
    pos = positions_thw.to(torch.float32)[sel]  # (hd/2, B, S)
    angles = torch.movedim(pos, 0, -1) * freqs  # (B, S, hd/2)
    return _rotate(x, angles)


def sinusoidal_positions(seq_len: int, d_model: int, device=None, *, start: int = 0) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (B-broadcastable): rows
    ``start .. start + seq_len - 1`` of the table, each equal to the full
    table's row bit for bit."""
    pos = torch.arange(start, start + seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
