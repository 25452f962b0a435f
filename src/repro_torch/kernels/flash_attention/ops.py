"""Public op for causal (sliding-window) attention: the tensors' device
decides."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int | None = None
) -> torch.Tensor:
    """Causal attention of q (B, H, S, hd) over k, v (B, H_kv, S, hd),
    H % H_kv == 0 (GQA reads each KV head in place), in q's dtype.  CPU
    tensors take the plain version; every other tensor goes to the CUDA
    kernel, at any S, which launches or raises (see ``flash_attention_cuda``
    for the head_dims it takes)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, window=window)
    return flash_attention_cuda(q, k, v, window=window)
