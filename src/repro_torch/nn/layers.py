"""Basic layers: init helpers, RMS norm, embeddings.

Port of ``repro/nn/layers.py``.  The init helpers draw from a
``torch.Generator`` with the reference's distributions (not its numbers:
``jax.random`` and torch give different draws from one seed), on the
generator's device.
"""
from __future__ import annotations

import math

import torch


def dense_init(
    gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype, scale: float | None = None
) -> torch.Tensor:
    """N(0, 1) * scale, by default 1/sqrt(fan_in) with fan_in = shape[-2]
    (leading dimensions stack independent layers), drawn in f32 and cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * s).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) * 0.02, drawn in f32 and cast."""
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's cast order: normalise in f32, cast back to x's
    dtype, then scale by gamma in that dtype."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma


def embed_lookup(embedding: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``embedding`` (V, d) at integer ``ids`` (...) -> (..., d)."""
    return torch.nn.functional.embedding(ids, embedding)


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple
