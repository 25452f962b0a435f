"""Plain PyTorch version of ssm_scan: the CPU path and the oracle the CUDA
kernel is held against.  The chunked scan of ``repro_torch.nn.ssm`` from a
zero state, as ``repro/kernels/ssm_scan/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.nn.ssm import chunked_ssm_scan


def ssm_scan_ref(x, dt, a, b_mat, c_mat, *, chunk: int = 256):
    """x (B, S, H, dh), dt (B, S, H), a (H,), b_mat and c_mat (B, S, ds) ->
    (y (B, S, H, dh) in x's dtype, h_final (B, H, dh, ds) f32)."""
    b, _, h, dh = x.shape
    h0 = torch.zeros((b, h, dh, b_mat.shape[-1]), dtype=torch.float32, device=x.device)
    return chunked_ssm_scan(x, dt, a, b_mat, c_mat, h0, chunk=chunk)
