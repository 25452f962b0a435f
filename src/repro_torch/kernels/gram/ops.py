"""Public op for the regularized Gram product: the tensor's device decides."""
from __future__ import annotations

import torch

from repro_torch.kernels.gram.kernel import gram_cuda
from repro_torch.kernels.gram.ref import gram_ref


def gram(y: torch.Tensor, *, mu: float) -> torch.Tensor:
    """G_m = Y_m Y_m^T + I/mu in f32 for y (M, n, J).  A CPU tensor takes
    the plain version; every other tensor goes to the CUDA kernel, at any
    shape, which launches or raises."""
    if y.device.type == "cpu":
        return gram_ref(y, mu=mu)
    return gram_cuda(y, mu=mu)
