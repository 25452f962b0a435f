"""Plain PyTorch version of flash_attention: the CPU path and the oracle
the CUDA kernel is held against.  Dense masked softmax, as
``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import check_gqa_shapes

NEG_INF = -1e30
# Scores materialised at once: (B*H slices) x S x S f32 values, so that a
# full-width call (32 heads at S = 8192) runs in 1 GiB pieces.
_MAX_SCORES = 2**28


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int | None = None
) -> torch.Tensor:
    """q (B, H, S, hd), k and v (B, H_kv, S, hd) with H % H_kv == 0 ->
    (B, H, S, hd) in q's dtype.  Query head h reads KV head h // (H / H_kv)
    (GQA; H_kv = H is plain multi-head).  Key kp counts for query qp when
    kp <= qp and, with a window, qp - kp < window; the sums are f32.  The
    B*H slices are independent and go in groups, which bounds the memory
    and leaves the result unchanged."""
    check_gqa_shapes(q, k, v)
    b, h, s, hd = q.shape
    group = h // k.shape[1]
    scale = 1.0 / hd**0.5
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    qf = q.reshape(b * h, s, hd)
    kf, vf = (t.reshape(-1, s, hd) for t in (k, v))
    out = torch.empty((b * h, s, hd), dtype=q.dtype, device=q.device)
    step = max(1, _MAX_SCORES // (s * s))
    for i in range(0, b * h, step):
        kv = torch.arange(i, min(i + step, b * h), device=q.device) // group
        logits = (qf[i:i + step].float() * scale) @ kf[kv].float().mT
        p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out[i:i + step] = (p @ vf[kv].float()).to(q.dtype)
    return out.reshape(b, h, s, hd)
