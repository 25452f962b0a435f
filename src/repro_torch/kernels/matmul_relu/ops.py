"""Public op for the fused LT+NLT step: the tensors' device decides."""
from __future__ import annotations

import torch

from repro_torch.kernels._autograd import refuse_grad
from repro_torch.kernels.matmul_relu.kernel import matmul_relu_cuda
from repro_torch.kernels.matmul_relu.ref import matmul_relu_ref


def matmul_relu(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """relu(W @ X) in W's dtype.  CPU tensors take the plain version;
    every other tensor goes to the CUDA kernel, at any shape, which
    launches or raises."""
    refuse_grad("matmul_relu", w, x)
    if w.device.type == "cpu" and x.device.type == "cpu":
        return matmul_relu_ref(w, x)
    return matmul_relu_cuda(w, x)
