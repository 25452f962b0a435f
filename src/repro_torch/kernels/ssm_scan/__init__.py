from repro_torch.kernels.ssm_scan.kernel import (
    launch_count,
    reset_launch_count,
    ssm_scan_cuda,
)
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = [
    "launch_count",
    "reset_launch_count",
    "ssm_scan",
    "ssm_scan_cuda",
    "ssm_scan_ref",
]
