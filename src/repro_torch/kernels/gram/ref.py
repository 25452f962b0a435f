"""Plain PyTorch version of gram: the CPU path and the oracle the CUDA
kernel is held against."""
from __future__ import annotations

import torch


def gram_ref(y: torch.Tensor, *, mu: float) -> torch.Tensor:
    """G_m = Y_m Y_m^T + I/mu for y (M, n, J), with f32 sums; (M, n, n) f32."""
    yf = y.float()
    eye = torch.eye(y.shape[-2], dtype=torch.float32, device=y.device)
    return torch.matmul(yf, yf.mT) + (1.0 / mu) * eye
