from repro_torch.kernels.mlstm_scan.kernel import (
    launch_count,
    mlstm_scan_cuda,
    reset_launch_count,
)
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

__all__ = [
    "launch_count",
    "mlstm_scan",
    "mlstm_scan_cuda",
    "mlstm_scan_ref",
    "reset_launch_count",
]
