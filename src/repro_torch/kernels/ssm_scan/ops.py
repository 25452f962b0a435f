"""Public op for the chunked SSM scan: the tensors' device decides."""
from __future__ import annotations

import torch

from repro_torch.kernels._autograd import refuse_grad
from repro_torch.kernels.ssm_scan.kernel import ssm_scan_cuda
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref


def ssm_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 chunked scan from a zero state: (y in x's dtype, h_final
    f32).  CPU tensors take the plain version; every other tensor goes to
    the CUDA kernel, which launches or raises (see ``ssm_scan_cuda`` for
    what it takes; S must be a multiple of ``chunk``, the caller pads)."""
    refuse_grad("ssm_scan", x, dt, a, b_mat, c_mat)
    if all(t.device.type == "cpu" for t in (x, dt, a, b_mat, c_mat)):
        return ssm_scan_ref(x, dt, a, b_mat, c_mat, chunk=chunk)
    return ssm_scan_cuda(x, dt, a, b_mat, c_mat, chunk=chunk)
