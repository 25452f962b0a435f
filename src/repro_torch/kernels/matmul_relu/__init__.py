from repro_torch.kernels.matmul_relu.kernel import (
    launch_count,
    matmul_relu_cuda,
    reset_launch_count,
)
from repro_torch.kernels.matmul_relu.ops import matmul_relu
from repro_torch.kernels.matmul_relu.ref import matmul_relu_ref

__all__ = [
    "launch_count",
    "matmul_relu",
    "matmul_relu_cuda",
    "matmul_relu_ref",
    "reset_launch_count",
]
