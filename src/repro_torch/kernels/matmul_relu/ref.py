"""Plain PyTorch version of matmul_relu: the CPU path and the oracle the
CUDA kernel is held against."""
from __future__ import annotations

import torch


def matmul_relu_ref(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """relu(W @ X) with f32 sums, in W's dtype."""
    y = torch.matmul(w.float(), x.float())
    return torch.relu(y).to(w.dtype)
