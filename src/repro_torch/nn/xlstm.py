"""xLSTM primitives: mLSTM (matrix memory, chunked-parallel) and sLSTM
(scalar memory, sequential) — arXiv:2405.04517.

Port of ``repro/nn/xlstm.py``.  mLSTM recurrence per head (stabilized,
states scaled by exp(-m)):
    C_t = f_t C_{t-1} + i_t k_t v_t^T          (dk x dv matrix memory)
    n_t = f_t n_{t-1} + i_t k_t
    y_t = (C_t^T q_t) / max(|n_t^T q_t|, exp(-m_t))
with log-space gates lf = logsigmoid(f_pre), li = i_pre and running
stabilizer m.  The full-sequence pass uses the chunkwise dual form
(quadratic within chunks; a Python loop, the reference's ``lax.scan``,
carries the state across chunks); that is also what the ``mlstm_scan``
kernel computes.  Decode is the O(1) recurrence.

sLSTM: per-unit scalar memory with block-diagonal recurrent weights,
necessarily sequential: a Python loop over time.  Each step runs on the
gates laid out (heads, batch, 4, dh), so the recurrent product of all
four gates is one ``baddbmm`` over the heads and the rest is a short run
of elementwise ops.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_BIG = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor    # (B, H, dk, dv) f32, scaled by exp(-m)
    n: torch.Tensor    # (B, H, dk) f32
    m: torch.Tensor    # (B, H) f32 log-space stabilizer


def init_mlstm_state(batch: int, heads: int, dk: int, dv: int, device=None) -> MLSTMState:
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, heads, dk, dv), dtype=f32, device=device),
        n=torch.zeros((batch, heads, dk), dtype=f32, device=device),
        m=torch.full((batch, heads), NEG_BIG, dtype=f32, device=device),
    )


def mlstm_scale(dk: int) -> float:
    """The query scale 1 / sqrt(dk), formed in f32 as the reference forms it."""
    return (1.0 / torch.sqrt(torch.tensor(dk, dtype=torch.float32))).item()


def mlstm_terms(
    q: torch.Tensor,       # (B, S, H, dk)
    k: torch.Tensor,       # (B, S, H, dk)
    v: torch.Tensor,       # (B, S, H, dv)
    i_pre: torch.Tensor,   # (B, S, H) input-gate preactivations
    f_pre: torch.Tensor,   # (B, S, H) forget-gate preactivations
    state: MLSTMState,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, MLSTMState]:
    """The chunked mLSTM's parts, all f32: (num (B, S, H, dv), den
    (B, S, H) before its floor, the floor exp(-m_t) (B, S, H), the final
    state).  ``chunked_mlstm``'s y is num / max(|den|, floor); the kernel
    tests run this on |q|, |k|, |v| to size each element's rounding."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    qc = (q.to(f32) * mlstm_scale(dk)).reshape(b, nc, chunk, h, dk)
    kc = k.to(f32).reshape(b, nc, chunk, h, dk)
    vc = v.to(f32).reshape(b, nc, chunk, h, dv)
    ic = i_pre.to(f32).reshape(b, nc, chunk, h)
    lf = F.logsigmoid(f_pre.to(f32)).reshape(b, nc, chunk, h)
    idx = torch.arange(chunk, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]

    c_prev, n_prev, m_prev = state.c.to(f32), state.n.to(f32), state.m.to(f32)
    nums, dens, floors = [], [], []
    for j in range(nc):
        qk_, kk_, vk_, ik_ = qc[:, j], kc[:, j], vc[:, j], ic[:, j]
        fcum = torch.cumsum(lf[:, j], dim=1)                    # (B, c, H) inclusive
        # log weights: D[t, s] = F_t - F_s + i_s   (s <= t)
        d_log = fcum[:, :, None, :] - fcum[:, None, :, :] + ik_[:, None, :, :]
        d_log = torch.where(causal, d_log, -torch.inf)
        inter_log = fcum + m_prev[:, None, :]                   # (B, c, H)
        m_t = torch.maximum(torch.amax(d_log, dim=2), inter_log)
        m_t = torch.clamp_min(m_t, NEG_BIG)
        w_intra = torch.exp(d_log - m_t[:, :, None, :])         # (B, t, s, H)
        w_inter = torch.exp(inter_log - m_t)                    # (B, c, H)
        scores = torch.einsum("bthd,bshd->btsh", qk_, kk_) * w_intra
        num = torch.einsum("btsh,bshv->bthv", scores, vk_)
        num = num + w_inter[..., None] * torch.einsum("bthd,bhdv->bthv", qk_, c_prev)
        den = scores.sum(dim=2) + w_inter * torch.einsum("bthd,bhd->bth", qk_, n_prev)
        nums.append(num)
        dens.append(den)
        floors.append(torch.exp(-m_t))
        # State update to the end of the chunk.
        f_total = fcum[:, -1, :]                                # (B, H)
        s_log = f_total[:, None, :] - fcum + ik_                # (B, c, H)
        m_new = torch.maximum(m_prev + f_total, torch.amax(s_log, dim=1))
        w_state = torch.exp(s_log - m_new[:, None, :])
        carry = torch.exp(m_prev + f_total - m_new)
        c_prev = carry[:, :, None, None] * c_prev + torch.einsum(
            "bsh,bshd,bshv->bhdv", w_state, kk_, vk_)
        n_prev = carry[:, :, None] * n_prev + torch.einsum("bsh,bshd->bhd", w_state, kk_)
        m_prev = m_new

    num = torch.stack(nums, dim=1).reshape(b, s, h, dv)
    den = torch.stack(dens, dim=1).reshape(b, s, h)
    floor = torch.stack(floors, dim=1).reshape(b, s, h)
    return num, den, floor, MLSTMState(c=c_prev, n=n_prev, m=m_prev)


def chunked_mlstm(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,
    f_pre: torch.Tensor,
    state: MLSTMState,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, MLSTMState]:
    """Returns (y: (B, S, H, dv) in q's dtype, the final state, f32)."""
    num, den, floor, state = mlstm_terms(q, k, v, i_pre, f_pre, state, chunk=chunk)
    y = num / torch.maximum(den.abs(), floor)[..., None]
    return y.to(q.dtype), state


def mlstm_decode_step(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_pre: torch.Tensor,
    f_pre: torch.Tensor, state: MLSTMState,
) -> tuple[torch.Tensor, MLSTMState]:
    """One token: q, k: (B, H, dk), v: (B, H, dv), gates: (B, H)."""
    f32 = torch.float32
    dk = q.shape[-1]
    qf = q.to(f32) * mlstm_scale(dk)
    kf, vf = k.to(f32), v.to(f32)
    lf = F.logsigmoid(f_pre.to(f32))
    li = i_pre.to(f32)
    m_new = torch.maximum(lf + state.m, li)
    a = torch.exp(lf + state.m - m_new)
    bq = torch.exp(li - m_new)
    c = a[..., None, None] * state.c + bq[..., None, None] * torch.einsum("bhd,bhv->bhdv", kf, vf)
    n = a[..., None] * state.n + bq[..., None] * kf
    num = torch.einsum("bhd,bhdv->bhv", qf, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(), torch.exp(-m_new))
    y = (num / den[..., None]).to(q.dtype)
    return y, MLSTMState(c=c, n=n, m=m_new)


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d) f32
    n: torch.Tensor   # (B, d) f32
    h: torch.Tensor   # (B, d) f32
    m: torch.Tensor   # (B, d) f32


def init_slstm_state(batch: int, d: int, device=None) -> SLSTMState:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z.clone(), h=z.clone(),
                      m=torch.full((batch, d), NEG_BIG, dtype=torch.float32, device=device))


def _heads_first(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, d) -> (H, B, dh), contiguous."""
    b, d = t.shape
    return t.reshape(b, num_heads, d // num_heads).transpose(0, 1).contiguous()


def _heads_last(t: torch.Tensor) -> torch.Tensor:
    """(H, B, dh) -> (B, d)."""
    h, b, dh = t.shape
    return t.transpose(0, 1).reshape(b, h * dh)


def _recurrent_weights(r_w: torch.Tensor) -> torch.Tensor:
    """(4, H, dh, dh) -> (H, dh, 4 dh): the four gates' blocks of one head
    side by side, so that h (H, B, dh) @ it gives every gate's recurrence."""
    g, h, dh, _ = r_w.shape
    return r_w.to(torch.float32).permute(1, 2, 0, 3).reshape(h, dh, g * dh)


def _slstm_step(gates, r_cat, c, n, h, m):
    """One sLSTM step on the (H, B, ...) layout.  ``gates`` (H, B, 4 dh)
    f32 holds the input contributions [z, i, f, o]; the recurrence
    h @ r_cat is added to it here.  Returns (c, n, h, m)."""
    hh, b, _ = gates.shape
    g = torch.baddbmm(gates, h, r_cat).view(hh, b, 4, -1)
    zx, li, fx, ox = g.unbind(2)
    z = torch.tanh(zx)
    lf = F.logsigmoid(fx)                   # sigmoid forget gate, log space
    o = torch.sigmoid(ox)
    lfm = lf + m
    m_new = torch.maximum(lfm, li)          # li: exp input gate, log space
    a = torch.exp(lfm - m_new)
    bq = torch.exp(li - m_new)
    c = a * c + bq * z
    n = a * n + bq
    h = (o * c) / torch.clamp_min(n, 1e-6)
    return c, n, h, m_new


def _slstm_cell(x_gates: torch.Tensor, r_w: torch.Tensor, state: SLSTMState, num_heads: int):
    """x_gates: (B, 4d) precomputed input contributions [z, i, f, o];
    r_w: (4, H, dh, dh) block-diagonal recurrent weights."""
    b, d4 = x_gates.shape
    dh = d4 // 4 // num_heads
    gates = x_gates.to(torch.float32).reshape(b, 4, num_heads, dh).permute(2, 0, 1, 3)
    st = [_heads_first(t, num_heads) for t in state]
    c, n, h, m = _slstm_step(gates.reshape(num_heads, b, 4 * dh), _recurrent_weights(r_w),
                             st[0], st[1], st[2], st[3])
    return SLSTMState(c=_heads_last(c), n=_heads_last(n), h=_heads_last(h), m=_heads_last(m))


def slstm_scan(
    x_gates: torch.Tensor, r_w: torch.Tensor, state: SLSTMState, num_heads: int
) -> tuple[torch.Tensor, SLSTMState]:
    """Sequential sLSTM over time.  x_gates: (B, S, 4d) -> (h: (B, S, d) in
    x_gates' dtype, the final state)."""
    b, s, d4 = x_gates.shape
    d = d4 // 4
    dh = d // num_heads
    gates = (x_gates.to(torch.float32).reshape(b, s, 4, num_heads, dh)
             .permute(1, 3, 0, 2, 4).reshape(s, num_heads, b, 4 * dh).contiguous())
    r_cat = _recurrent_weights(r_w)
    c, n, h, m = (_heads_first(t, num_heads) for t in state)
    steps = []
    for t in range(s):
        c, n, h, m = _slstm_step(gates[t], r_cat, c, n, h, m)
        steps.append(h)
    hs = torch.stack(steps)
    out = hs.permute(2, 0, 1, 3).reshape(b, s, d).to(x_gates.dtype)
    return out, SLSTMState(c=_heads_last(c), n=_heads_last(n), h=_heads_last(h),
                           m=_heads_last(m))
