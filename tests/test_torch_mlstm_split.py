"""The bf16 ``mlstm_scan`` kernel's arithmetic, emulated on the CPU.

``mlstm_scan``'s bf16 instance (``csrc/mlstm_scan.cu``) runs on the
tensor cores: q . k and the products with v are exact bf16 products, the
scale 1/sqrt(dk) multiplies the f32 sums, and each f32 factor enters as
bf16 pieces (kStatePieces for the state sum's w_s k_s, kOutPieces for
y's weighted scores and the carried state C).  An mma accumulator sums
one run from zero, the pieces smallest first, and the runs are added in
f32: kRun keys in the state sum, kDkRun of dk in q . k and q C_prev,
kKeyRun keys in the scores' product with v.  The constants are read from
the source, so the emulation follows the code.

An mma's sum of exact products is emulated as an f64 sum rounded to f32
(the tensor cores truncate instead, a difference of an f32 ulp of a
run's sum), the weights as exp where the kernel's y takes the 2^x of the
special-function unit (2^-22 relative), and the f32 sums of q . n_prev
and of a key tile's weighted scores in another fixed order; the card
tests in ``tests/test_torch_cuda.py`` hold the kernel itself to the same
bar.

Bar: ``chip_smoke.py``'s ``mlstm_excess`` (``_close_mlstm`` in the card
tests), per element |kernel - exact| <= 2**-7 |exact| (bf16 y) + eps
(num_abs + |exact| (den_abs + D)) / D for y, eps times the state of |k|,
|v| for C and n and eps (max|F| + |m|) for m, with eps = 2**-20 max|F| +
(2 chunk + dk) 2**-24, against a float64 scan of the same bf16 inputs.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build

MLSTM_REL_BF16 = 2.0**-7
NEG_BIG = -1e30


def _constant(name):
    text = (_build.CSRC / "mlstm_scan.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


STATE_PIECES, OUT_PIECES = _constant("kStatePieces"), _constant("kOutPieces")
RUN, DK_RUN, KEY_RUN = _constant("kRun"), _constant("kDkRun"), _constant("kKeyRun")


def pieces(v, n):
    """f32 v as n bf16 pieces (as f32 tensors): p_i = bf16(v - p_0 - ... - p_(i-1))."""
    out, rest = [], v.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def mma_runs(a, b, run, n_pieces):
    """a @ b (batched, f32 a in n_pieces bf16 pieces, b exact) as the kernel
    sums it: runs of ``run`` along the contraction, each run an mma
    accumulator from zero taking one k-step of 16 at a time, the pieces
    smallest first (each mma an f64 sum rounded to f32), the runs added in
    f32."""
    k = a.shape[-1]
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for r0 in range(0, k, run):
        acc = torch.zeros_like(total)
        for r in range(r0, min(k, r0 + run), 16):
            for p in reversed(pieces(a[..., r:r + 16], n_pieces)):
                acc = (acc.double() + p.double() @ b[..., r:r + 16, :].double()).float()
        total = total + acc
    return total


def chunk_f(lf):
    """The kernels' in-chunk cumulative sum F of lf (..., c) f32: 32 lanes
    each sum ceil(c / 32) steps in order, a shuffle scan adds the lanes'
    sums before each."""
    c = lf.shape[-1]
    per = -(-c // 32)
    runs, f = [], torch.zeros_like(lf)
    for lane in range(32):
        lo, hi = min(c, lane * per), min(c, lane * per + per)
        run = torch.zeros_like(lf[..., 0])
        for s in range(lo, hi):
            run = run + lf[..., s]
            f[..., s] = run
        runs.append(run)
    incl = list(runs)
    off = 1
    while off < 32:
        incl = [incl[i] + incl[i - off] if i >= off else incl[i] for i in range(32)]
        off *= 2
    for lane in range(1, 32):
        lo, hi = min(c, lane * per), min(c, lane * per + per)
        f[..., lo:hi] = incl[lane - 1][..., None] + f[..., lo:hi]
    return f


def logsigmoid(x):
    """The kernels' logsigmoid, min(x, 0) - log1p(e^{-|x|}), in x's type."""
    return torch.minimum(x, torch.zeros_like(x)) - torch.log1p(torch.exp(-x.abs()))


def mlstm_emulated(q, k, v, i_pre, f_pre, chunk, state_pieces=STATE_PIECES,
                   out_pieces=OUT_PIECES):
    """The bf16 kernel's three passes for q, k (S, H, dk), v (S, H, dv) f32
    holding bf16 values, i_pre and f_pre (S, H) f32: (y f32 before its bf16
    rounding, (C, n, m) f32)."""
    s, h, dk = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    scale = torch.tensor(scale, dtype=torch.float32)
    lf = logsigmoid(f_pre)
    c_st = torch.zeros((h, dk, dv), dtype=torch.float32)
    n_st = torch.zeros((h, dk), dtype=torch.float32)
    m_st = torch.full((h,), NEG_BIG, dtype=torch.float32)
    y = torch.zeros((s, h, dv), dtype=torch.float32)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ones = torch.ones((h, chunk, 1), dtype=torch.float32)
    for ci in range(s // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qc, kc, vc = (t[sl].permute(1, 0, 2) for t in (q, k, v))      # (H, c, d)
        f = chunk_f(lf[sl].T.contiguous())                              # (H, c)
        li = i_pre[sl].T
        # Kernel 1: the chunk's state, (w k)^T v over runs of RUN keys.
        s_log = (f[:, -1:] - f) + li
        m_c = s_log.max(dim=1).values
        w = torch.exp(s_log - m_c[:, None])
        wk_t = (w[:, :, None] * kc).mT                                  # (H, dk, c)
        c_c = mma_runs(wk_t, vc, RUN, state_pieces)
        n_c = mma_runs(wk_t, ones, RUN, state_pieces)[..., 0]
        # Kernel 3: y from the state at the chunk's start.
        # m_t = max(F_t + max_{s <= t} (i_s - F_s), F_t + m_prev, -1e30).
        d_log = (f[:, :, None] - f[:, None, :]) + li[:, None, :]        # (H, t, s)
        inter = f + m_st[:, None]
        m_t = torch.clamp_min(torch.maximum(f + torch.cummax(li - f, dim=1).values, inter),
                              NEG_BIG)
        w_inter = scale * torch.exp(inter - m_t)
        # q C_prev as (C_prev^T q^T)^T: C_prev in pieces, runs of DK_RUN of dk.
        acc = mma_runs(c_st.mT, qc.mT, DK_RUN, out_pieces).mT * w_inter[..., None]
        qn = (qc.double() @ n_st.double()[..., None])[..., 0].float()
        den = qn * w_inter
        sc = mma_runs(qc, kc.mT, DK_RUN, 1)                             # (H, t, s)
        p_full = torch.where(causal, (sc * scale) * torch.exp(d_log - m_t[..., None]),
                             torch.zeros(()))
        for k0 in range(0, chunk, KEY_RUN):
            den = den + p_full[..., k0:k0 + KEY_RUN].sum(dim=-1)
            acc = acc + mma_runs(p_full[..., k0:k0 + KEY_RUN], vc[:, k0:k0 + KEY_RUN], KEY_RUN,
                                 out_pieces)
        y[sl] = (acc / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]).permute(1, 0, 2)
        # Kernel 2: the carry, one fmaf per entry.
        mo = m_st + f[:, -1]
        mn = torch.maximum(mo, m_c)
        a, bq = torch.exp(mo - mn), torch.exp(m_c - mn)
        c_st = (a[:, None, None].double() * c_st.double()
                + (bq[:, None, None] * c_c).double()).float()
        n_st = (a[:, None].double() * n_st.double() + (bq[:, None] * n_c).double()).float()
        m_st = mn
    return y, (c_st, n_st, m_st)


def mlstm_f64(q, k, v, i_pre, f_pre, chunk):
    """The chunked mLSTM in float64: (num, den, floor (S, H, ...), (C, n,
    m)); y = num / max(|den|, floor)."""
    q, k, v, i_pre, f_pre = (t.double() for t in (q, k, v, i_pre, f_pre))
    s, h, dk = q.shape
    dv = v.shape[-1]
    lf = torch.nn.functional.logsigmoid(f_pre)
    c_st = torch.zeros((h, dk, dv), dtype=torch.float64)
    n_st = torch.zeros((h, dk), dtype=torch.float64)
    m_st = torch.full((h,), NEG_BIG, dtype=torch.float64)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[:, :, None]
    nums, dens, floors = [], [], []
    for ci in range(s // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qc, kc, vc, li = q[sl] / math.sqrt(dk), k[sl], v[sl], i_pre[sl]
        f = torch.cumsum(lf[sl], dim=0)                                 # (c, H)
        d_log = torch.where(causal, f[:, None] - f[None] + li[None], -torch.inf)
        inter = f + m_st[None]
        m_t = torch.clamp_min(torch.maximum(d_log.amax(dim=1), inter), NEG_BIG)
        scores = torch.einsum("thd,shd->tsh", qc, kc) * torch.exp(d_log - m_t[:, None])
        w_inter = torch.exp(inter - m_t)
        nums.append(torch.einsum("tsh,shv->thv", scores, vc)
                    + w_inter[..., None] * torch.einsum("thd,hdv->thv", qc, c_st))
        dens.append(scores.sum(dim=1) + w_inter * torch.einsum("thd,hd->th", qc, n_st))
        floors.append(torch.exp(-m_t))
        s_log = f[-1:] - f + li
        m_new = torch.maximum(m_st + f[-1], s_log.amax(dim=0))
        w = torch.exp(s_log - m_new[None])
        carry = torch.exp(m_st + f[-1] - m_new)
        c_st = carry[:, None, None] * c_st + torch.einsum("sh,shd,shv->hdv", w, kc, vc)
        n_st = carry[:, None] * n_st + torch.einsum("sh,shd->hd", w, kc)
        m_st = m_new
    return torch.cat(nums), torch.cat(dens), torch.cat(floors), (c_st, n_st, m_st)


def _inputs(s, h, dk, dv, seed, valid=None):
    """The model's distributions, as the kernel tests draw them: q, k, v ~
    N(0, 1) rounded to bf16, i_pre ~ N(0, 1), f_pre ~ N(3, 1); steps past
    ``valid`` are the model's padding."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((s, h, dk)).astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((s, h, dv)).astype(np.float32))
    i_pre = torch.from_numpy(rng.standard_normal((s, h)).astype(np.float32))
    f_pre = torch.from_numpy((rng.standard_normal((s, h)) + 3.0).astype(np.float32))
    if valid is not None:
        for t in (q, k, v):
            t[valid:] = 0.0
        i_pre[valid:] = -1e9
        f_pre[valid:] = 1e9
    to16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    return to16(q), to16(k), to16(v), i_pre, f_pre


def _excess(inputs, chunk, state_pieces=STATE_PIECES, out_pieces=OUT_PIECES):
    """Max over elements of |emulated - float64| less its allowance, for y
    (bf16-rounded, with 2**-7 |exact|) and for the state (C, n, m)."""
    q, k, v, i_pre, f_pre = inputs
    s, h, dk = q.shape
    y, (c, n, m) = mlstm_emulated(*inputs, chunk, state_pieces, out_pieces)
    y = y.to(torch.bfloat16).double()
    num, den, floor, (c64, n64, m64) = mlstm_f64(*inputs, chunk)
    num_a, den_a, _, (c_a, n_a, _) = mlstm_f64(q.abs(), k.abs(), v.abs(), i_pre, f_pre, chunk)
    d = torch.maximum(den.abs(), floor)
    y64 = num / d[..., None]
    f_max = (torch.nn.functional.logsigmoid(f_pre.double()).reshape(s // chunk, chunk, h)
             .cumsum(1).abs().max().item())
    eps = 2.0**-20 * f_max + (2 * chunk + dk) * 2.0**-24
    terms_y = num_a / d[..., None] + y64.abs() * ((den_a + d) / d)[..., None]
    ex_y = ((y - y64).abs() - MLSTM_REL_BF16 * y64.abs() - eps * terms_y).max().item()
    ex_state = max(((c.double() - c64).abs() - eps * c_a).max().item(),
                   ((n.double() - n64).abs() - eps * n_a).max().item(),
                   ((m.double() - m64).abs() - eps * (f_max + m64.abs())).max().item())
    return ex_y, ex_state


def test_source_constants():
    from repro_torch.kernels.mlstm_scan import kernel

    assert STATE_PIECES == 3 and OUT_PIECES == 2 and RUN == 16
    assert DK_RUN % 16 == 0 and KEY_RUN % 16 == 0
    assert kernel.OUT_PIECES == OUT_PIECES   # the wrapper sizes the pieces' scratch


def test_emulated_f_is_a_cumulative_sum():
    """chunk_f's lane order gives torch.cumsum to f32 rounding."""
    lf = logsigmoid(torch.from_numpy(
        (np.random.default_rng(1).standard_normal((3, 256)) + 3.0).astype(np.float32)))
    want = torch.cumsum(lf.double(), dim=-1)
    assert ((chunk_f(lf).double() - want).abs() <= 64 * 2.0**-24 * want.abs().max()).all()


# (S, H, dk, dv, chunk, valid): xLSTM-350M's head (dk = dv = 256, chunk
# 256) over two chunks, the reduced config's (64, chunk 16) with padded
# steps, and dk = 128 (its scale 1/sqrt(128) is not a power of two) with
# dv != dk.
CASES = [(512, 1, 256, 256, 256, None), (96, 2, 64, 64, 16, 90), (192, 2, 128, 64, 64, None)]


@pytest.mark.parametrize("s,h,dk,dv,chunk,valid", CASES)
def test_emulated_bf16_scan_meets_the_per_element_bar(s, h, dk, dv, chunk, valid):
    inputs = _inputs(s, h, dk, dv, seed=dk + chunk, valid=valid)
    ex_y, ex_state = _excess(inputs, chunk)
    assert ex_y <= 0.0 and ex_state <= 0.0, (ex_y, ex_state)


def test_one_out_piece_misses_the_bar():
    """A bf16 weighted score (8 significant bits) is not enough for y: the
    bar tells two pieces apart from a plain bf16 product."""
    inputs = _inputs(128, 2, 64, 64, seed=7)
    assert _excess(inputs, 64, out_pieces=1)[0] > 0.0
    assert _excess(inputs, 64)[0] <= 0.0


def test_two_state_pieces_miss_the_state_bar():
    """Two real steps (the rest padding), the first, of weight 1, with k =
    0: every state entry is the single product w_1 k_1 v_1 with w_1 =
    e^{-0.3} of 24 significant bits, and F is near 0.  Two pieces of w_s
    k_s (16 bits) leave more than the bar's f32 allowance; three keep the
    f32 product whole."""
    q, k, v, i_pre, f_pre = _inputs(16, 1, 16, 8, seed=3, valid=2)
    k[0] = 0.0
    i_pre[:2, 0] = torch.tensor([0.0, -0.3])
    f_pre[:2] = 20.0
    two = _excess((q, k, v, i_pre, f_pre), 16, state_pieces=2)
    three = _excess((q, k, v, i_pre, f_pre), 16)
    assert two[1] > 0.0 >= three[1] and max(two[0], three[0]) <= 0.0
