"""Public op for the fused layer step: the tensors' device decides."""
from __future__ import annotations

import torch

from repro_torch.kernels.propagate_gram.kernel import propagate_gram_cuda
from repro_torch.kernels.propagate_gram.ref import propagate_gram_ref


def propagate_gram(
    w: torch.Tensor, y: torch.Tensor, *, mu: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Y', G) = (relu(W @ Y_m), Y'_m Y'_m^T + I/mu) for w (n, n_prev) and
    y (M, n_prev, J).  CPU tensors take the plain version; every other
    tensor goes to the CUDA kernels, at any shape, which launch or raise."""
    if w.device.type == "cpu" and y.device.type == "cpu":
        return propagate_gram_ref(w, y, mu=mu)
    return propagate_gram_cuda(w, y, mu=mu)
