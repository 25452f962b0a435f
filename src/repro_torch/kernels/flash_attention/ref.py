"""Plain PyTorch version of flash_attention: the CPU path and the oracle
the CUDA kernel is held against.  Dense masked softmax, as
``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import torch

NEG_INF = -1e30
# Scores materialised at once: (B*H slices) x S x S f32 values, so that a
# full-width call (32 heads at S = 8192) runs in 1 GiB pieces.
_MAX_SCORES = 2**28


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int | None = None
) -> torch.Tensor:
    """q, k, v (B, H, S, hd) -> (B, H, S, hd) in q's dtype.  Key kp counts
    for query qp when kp <= qp and, with a window, qp - kp < window; the
    sums are f32.  The B*H slices are independent and go in groups, which
    bounds the memory and leaves the result unchanged."""
    b, h, s, hd = q.shape
    scale = 1.0 / hd**0.5
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    qf, kf, vf = (t.reshape(b * h, s, hd) for t in (q, k, v))
    out = torch.empty((b * h, s, hd), dtype=q.dtype, device=q.device)
    step = max(1, _MAX_SCORES // (s * s))
    for i in range(0, b * h, step):
        logits = (qf[i:i + step].float() * scale) @ kf[i:i + step].float().mT
        p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out[i:i + step] = (p @ vf[i:i + step].float()).to(q.dtype)
    return out.reshape(b, h, s, hd)
