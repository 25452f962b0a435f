"""Mamba2-style selective SSM with the chunked (block-parallel) scan.

Port of ``repro/nn/ssm.py``.  State-space recurrence per head:
h_t = a_t h_{t-1} + dt_t * (x_t (x) B_t), y_t = C_t . h_t, with
a_t = exp(A * dt_t) (A < 0 per head).

The full-sequence pass uses the Mamba2 chunked dual form: within a chunk
the output is a masked quadratic ("attention-like") product; across
chunks a Python loop (the reference's ``lax.scan``) carries the
(H, dh, ds) state.  That is also the blocking of the ``ssm_scan``
kernel.  Decode is the O(1) recurrence.  Every decay is
exp(clip(., -60, 0)) and every sum is taken in f32, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SSMState(NamedTuple):
    h: torch.Tensor       # (B, H, dh, ds) f32
    conv: torch.Tensor    # (B, kernel-1, conv_dim) rolling conv inputs


def _decay(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(t, -60.0, 0.0))


def chunked_ssm_scan(
    x: torch.Tensor,       # (B, S, H, dh)
    dt: torch.Tensor,      # (B, S, H)  positive (softplus'd)
    a: torch.Tensor,       # (H,)       negative decay rates
    b_mat: torch.Tensor,   # (B, S, ds)
    c_mat: torch.Tensor,   # (B, S, ds)
    h0: torch.Tensor,      # (B, H, dh, ds)
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, H, dh) in x's dtype, h_final: (B, H, dh, ds) f32)."""
    bsz, s, h, dh = x.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(bsz, nc, chunk, h, dh)
    dtc = dt.to(f32).reshape(bsz, nc, chunk, h)
    lac = (a.to(f32)[None, None, :] * dt.to(f32)).reshape(bsz, nc, chunk, h)
    bc = b_mat.to(f32).reshape(bsz, nc, chunk, -1)
    cc = c_mat.to(f32).reshape(bsz, nc, chunk, -1)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]

    h_prev = h0.to(f32)
    ys = []
    for k in range(nc):
        xk, dtk, bk, ck = xc[:, k], dtc[:, k], bc[:, k], cc[:, k]
        la_cum = torch.cumsum(lac[:, k], dim=1)                       # (B, c, H)
        cb = torch.einsum("btd,bsd->bts", ck, bk)
        decay = _decay(la_cum[:, :, None, :] - la_cum[:, None, :, :])  # (B, t, s, H)
        scores = cb[..., None] * decay * dtk[:, None, :, :]
        scores = torch.where(causal, scores, 0.0)
        y_intra = torch.einsum("btsh,bshd->bthd", scores, xk)
        c_scaled = ck[:, :, None, :] * _decay(la_cum)[..., None]
        y_inter = torch.einsum("bthp,bhdp->bthd", c_scaled, h_prev)
        la_last = la_cum[:, -1:, :]
        w = _decay(la_last - la_cum) * dtk
        h_prev = (_decay(la_last[:, 0, :])[:, :, None, None] * h_prev
                  + torch.einsum("bsh,bshd,bsp->bhdp", w, xk, bk))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, dh)
    return y.to(x.dtype), h_prev


def ssm_decode_step(
    x: torch.Tensor,       # (B, H, dh)
    dt: torch.Tensor,      # (B, H)
    a: torch.Tensor,       # (H,)
    b_mat: torch.Tensor,   # (B, ds)
    c_mat: torch.Tensor,   # (B, ds)
    h: torch.Tensor,       # (B, H, dh, ds)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step; returns (y: (B, H, dh) in x's dtype, h_new f32)."""
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    a_t = _decay(a[None] * dtf)                                          # (B, H)
    contrib = torch.einsum("bh,bhd,bp->bhdp", dtf, xf, b_mat.to(f32))
    h_new = a_t[..., None, None] * h + contrib
    y = torch.einsum("bp,bhdp->bhd", c_mat.to(f32), h_new)
    return y.to(x.dtype), h_new


def causal_conv1d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prev: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv + SiLU.  x: (B, S, C); w: (ker, C); b: (C,).

    prev: (B, ker-1, C) history for decode/chunked use; returns
    (y: (B, S, C), new_prev), new_prev being the last ker-1 inputs.
    """
    ker = w.shape[0]
    s = x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], ker - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)                      # (B, S+ker-1, C)
    # Sliding window sum: y_t = sum_k w_k * xp[t+k], in the reference's order.
    y = xp[:, 0:s, :] * w[0][None, None, :]
    for k in range(1, ker):
        y = y + xp[:, k:k + s, :] * w[k][None, None, :]
    y = torch.nn.functional.silu(y + b[None, None, :])
    new_prev = xp[:, s:, :] if ker > 1 else prev
    return y.to(x.dtype), new_prev
