from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_cuda,
    launch_count,
    reset_launch_count,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = [
    "flash_attention",
    "flash_attention_cuda",
    "flash_attention_ref",
    "launch_count",
    "reset_launch_count",
]
