"""Rotary position embeddings (RoPE), port of ``repro/nn/rope.py``:
split-halves rotation (not interleaved), angles in f32."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, f32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotate x: (..., S, H, head_dim) at integer positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)   # (half,)
    angles = positions[..., None].float() * freqs                  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
