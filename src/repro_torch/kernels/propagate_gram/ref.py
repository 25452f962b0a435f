"""Plain PyTorch version of propagate_gram: the CPU path and the oracle
the CUDA kernel is held against."""
from __future__ import annotations

import torch


def propagate_gram_ref(
    w: torch.Tensor, y: torch.Tensor, *, mu: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(relu(W @ Y_m), relu(W @ Y_m) relu(W @ Y_m)^T + I/mu) for w
    (n, n_prev) and y (M, n_prev, J), with f32 sums.  Y' comes back in
    W's dtype; G is f32 and, as in the Pallas kernel, built from the f32
    Y' before it is rounded to W's dtype."""
    y32 = torch.relu(torch.matmul(w.float(), y.float()))
    eye = torch.eye(w.shape[0], dtype=torch.float32, device=w.device)
    return y32.to(w.dtype), torch.matmul(y32, y32.mT) + (1.0 / mu) * eye
