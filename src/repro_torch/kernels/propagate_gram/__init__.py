from repro_torch.kernels.propagate_gram.kernel import (
    launch_count,
    propagate_gram_cuda,
    reset_launch_count,
)
from repro_torch.kernels.propagate_gram.ops import propagate_gram
from repro_torch.kernels.propagate_gram.ref import propagate_gram_ref

__all__ = [
    "launch_count",
    "propagate_gram",
    "propagate_gram_cuda",
    "propagate_gram_ref",
    "reset_launch_count",
]
