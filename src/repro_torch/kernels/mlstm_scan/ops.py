"""Public op for the chunked mLSTM: the tensors' device decides."""
from __future__ import annotations

import torch

from repro_torch.kernels._autograd import refuse_grad
from repro_torch.kernels.mlstm_scan.kernel import mlstm_scan_cuda
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref


def mlstm_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,
    f_pre: torch.Tensor,
    *,
    chunk: int = 256,
):
    """The chunked stabilized mLSTM from the zero state: (y in q's dtype,
    (C, n, m) f32).  CPU tensors take the plain version; every other
    tensor goes to the CUDA kernel, which launches or raises (see
    ``mlstm_scan_cuda`` for what it takes; S must be a multiple of
    ``chunk``: the caller pads, where ``repro``'s op falls back to one
    chunk of S)."""
    refuse_grad("mlstm_scan", q, k, v, i_pre, f_pre)
    if all(t.device.type == "cpu" for t in (q, k, v, i_pre, f_pre)):
        return mlstm_scan_ref(q, k, v, i_pre, f_pre, chunk=chunk)
    return mlstm_scan_cuda(q, k, v, i_pre, f_pre, chunk=chunk)
