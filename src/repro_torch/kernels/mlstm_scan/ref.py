"""Plain PyTorch version of mlstm_scan: the CPU path and the oracle the
CUDA kernel is held against.  The chunked mLSTM of ``repro_torch.nn.xlstm``
from the zero state, as ``repro/kernels/mlstm_scan/ref.py``."""
from __future__ import annotations

from repro_torch.nn.xlstm import chunked_mlstm, init_mlstm_state


def mlstm_scan_ref(q, k, v, i_pre, f_pre, *, chunk: int = 256):
    """q, k (B, S, H, dk), v (B, S, H, dv), i_pre and f_pre (B, S, H) ->
    (y (B, S, H, dv) in q's dtype, (C (B, H, dk, dv), n (B, H, dk),
    m (B, H)) f32)."""
    b, _, h, dk = q.shape
    st = init_mlstm_state(b, h, dk, v.shape[-1], device=q.device)
    y, state = chunked_mlstm(q, k, v, i_pre, f_pre, st, chunk=chunk)
    return y, (state.c, state.n, state.m)
