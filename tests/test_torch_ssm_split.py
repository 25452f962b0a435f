"""The bf16 ``ssm_scan`` kernel's and ``matmul_relu``'s arithmetic,
emulated on the CPU.

``ssm_scan``'s bf16 instance (``csrc/ssm_scan.cu``) runs on the tensor
cores: each f32 factor enters as bf16 pieces (kStatePieces for the state
sum's weighted B_s, kOutPieces for y's masked scores and state h), and
an mma accumulator sums one run of kRun keys or state columns (kKeyRun
keys for y's product with x) from zero, the pieces smallest first, the
runs added in f32.  ``matmul_relu``
(``csrc/matmul_relu.cu``) sums each K slice of kSlice from zero, adds a
warp's slices in order and the warps of a block (at most kRanks) in warp
order.  The constants are read from the sources, so the emulation
follows the code.

An mma's sum of exact products is emulated as an f64 sum rounded to f32
(the tensor cores truncate instead, a difference of an f32 ulp of a
run's sum), and the decays as exp where the kernel's y takes the 2^x of
the special-function unit (2^-22 relative); the card tests in ``tests/test_torch_cuda.py`` hold the
kernels themselves to the same bars.

Bars: ``chip_smoke.py``'s ``ssm_excess``, per element |kernel - exact| <=
2**-7 |exact| (bf16 y) + eps |terms|, eps = 2**-20 max|la| + (chunk + ds)
2**-24, against a float64 scan of the same bf16 inputs; and 1e-5 x max of
a float64 product for ``matmul_relu``'s f32 order.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build


def _constant(source, name):
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


STATE_PIECES = _constant("ssm_scan.cu", "kStatePieces")
OUT_PIECES = _constant("ssm_scan.cu", "kOutPieces")
RUN, KEY_RUN = _constant("ssm_scan.cu", "kRun"), _constant("ssm_scan.cu", "kKeyRun")
SLICE, RANKS = _constant("matmul_relu.cu", "kSlice"), _constant("matmul_relu.cu", "kRanks")
SSM_REL_BF16 = 2.0**-7


def pieces(v, n):
    """f32 v as n bf16 pieces (as f32 tensors): p_i = bf16(v - p_0 - ... - p_(i-1))."""
    out, rest = [], v.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def decay(u):
    return torch.exp(torch.clamp(u, -60.0, 0.0))


def chunk_la(a_dt):
    """The kernels' in-chunk cumulative sum of a * dt (..., c) f32: 32 lanes
    each sum ceil(c / 32) steps in order, a shuffle scan adds the lanes'
    sums before each."""
    c = a_dt.shape[-1]
    per = -(-c // 32)
    runs, la = [], torch.zeros_like(a_dt)
    for lane in range(32):
        lo, hi = min(c, lane * per), min(c, lane * per + per)
        run = torch.zeros_like(a_dt[..., 0])
        for s in range(lo, hi):
            run = run + a_dt[..., s]
            la[..., s] = run
        runs.append(run)
    incl = list(runs)
    off = 1
    while off < 32:
        incl = [incl[i] + incl[i - off] if i >= off else incl[i] for i in range(32)]
        off *= 2
    for lane in range(1, 32):
        lo, hi = min(c, lane * per), min(c, lane * per + per)
        la[..., lo:hi] = incl[lane - 1][..., None] + la[..., lo:hi]
    return la


def ssm_emulated(x, dt, a, bm, cm, chunk, state_pieces=STATE_PIECES, out_pieces=OUT_PIECES):
    """The bf16 kernel's three passes for x (S, H, dh), dt (S, H), a (H,),
    B and C (S, ds), all f32 holding bf16 x, B, C: (y f32 before its bf16
    rounding, h_final f32)."""
    s, h, dh = x.shape
    ds = bm.shape[-1]
    nc = s // chunk
    y = torch.zeros((s, h, dh), dtype=torch.float32)
    state = torch.zeros((h, dh, ds), dtype=torch.float32)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, bc, cc = x[sl], bm[sl], cm[sl]
        la = chunk_la((a[:, None] * dt[sl].T).float())                     # (H, c)
        dtc = dt[sl].T                                                      # (H, c)
        w = decay(la[:, -1:] - la) * dtc                                    # (H, c)
        # Kernel 1: S = x^T (w B) over runs of RUN keys, w B in pieces.
        s_c = torch.zeros((h, dh, ds), dtype=torch.float32)
        for r in range(0, chunk, RUN):
            wb = w[:, r:r + RUN, None] * bc[None, r:r + RUN]                # (H, run, ds)
            xt = xc[r:r + RUN].permute(1, 2, 0)                             # (H, dh, run)
            tmp = torch.zeros_like(s_c)
            for p in reversed(pieces(wb, state_pieces)):
                tmp = (tmp.double() + xt.double() @ p.double()).float()
            s_c = s_c + tmp
        # Kernel 3: the inter-chunk term over runs of RUN state columns, h in pieces.
        acc = torch.zeros((h, chunk, dh), dtype=torch.float32)
        for r in range(0, ds, RUN):
            hp = pieces(state[:, :, r:r + RUN], out_pieces)                 # (H, dh, run)
            tmp = torch.zeros_like(acc)
            for p in reversed(hp):
                tmp = (tmp.double() + cc[None, :, r:r + RUN].double() @ p.double().mT).float()
            acc = acc + tmp
        acc = acc * decay(la)[:, :, None]
        # Scores C B^T chained over the ds k-steps, scaled, masked, in pieces.
        sc = torch.zeros((chunk, chunk), dtype=torch.float32)
        for r in range(0, ds, 16):
            sc = (sc.double() + cc[:, r:r + 16].double() @ bc[:, r:r + 16].double().T).float()
        p_full = sc[None] * decay(la[:, :, None] - la[:, None, :]) * dtc[:, None, :]
        p_full = torch.where(causal[None], p_full, torch.zeros(()))
        xh = xc.permute(1, 0, 2)                                            # (H, c, dh)
        for r0 in range(0, chunk, KEY_RUN):
            tmp = torch.zeros_like(acc)
            for r in range(r0, min(chunk, r0 + KEY_RUN), 16):
                for p in reversed(pieces(p_full[:, :, r:r + 16], out_pieces)):
                    tmp = (tmp.double() + p.double() @ xh[:, r:r + 16].double()).float()
            acc = acc + tmp
        y[sl] = acc.permute(1, 0, 2)
        # Kernel 2: the carry, one fmaf per element.
        g = decay(la[:, -1])[:, None, None]
        state = (g.double() * state.double() + s_c.double()).float()
    return y, state


def ssm_f64(x, dt, a, bm, cm, chunk):
    """The chunked scan in float64: (y, h_final)."""
    x, dt, a, bm, cm = (t.double() for t in (x, dt, a, bm, cm))
    s, h, dh = x.shape
    state = torch.zeros((h, dh, bm.shape[-1]), dtype=torch.float64)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ys = []
    for ci in range(s // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, bc, cc, dtc = x[sl], bm[sl], cm[sl], dt[sl]
        la = torch.cumsum(a[None] * dtc, dim=0)                             # (c, H)
        scores = (cc @ bc.T)[:, :, None] * decay(la[:, None] - la[None]) * dtc[None]
        scores = torch.where(causal[:, :, None], scores, torch.zeros((), dtype=torch.float64))
        y = torch.einsum("tsh,shd->thd", scores, xc)
        y = y + torch.einsum("tp,hdp->thd", cc, state) * decay(la)[:, :, None]
        w = decay(la[-1:] - la) * dtc
        state = decay(la[-1])[:, None, None] * state + torch.einsum("sh,shd,sp->hdp", w, xc, bc)
        ys.append(y)
    return torch.cat(ys), state


def _inputs(s, h, dh, ds, seed):
    """The model's distributions, as the kernel tests draw them; x, B, C
    rounded to bf16."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((s, h, dh)).astype(np.float32))
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((s, h)) - 2.0, 0.0).astype(np.float32))
    bm = torch.from_numpy(rng.standard_normal((s, ds)).astype(np.float32))
    cm = torch.from_numpy(rng.standard_normal((s, ds)).astype(np.float32))
    a = -torch.linspace(1.0, 16.0, h)
    to16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    return to16(x), dt, a, to16(bm), to16(cm)


def _excess(inputs, chunk, state_pieces=STATE_PIECES, out_pieces=OUT_PIECES):
    """Max over elements of |emulated - float64| less its allowance, for y
    (bf16-rounded, with 2**-7 |exact|) and h."""
    x, dt, a, bm, cm = inputs
    y, h = ssm_emulated(x, dt, a, bm, cm, chunk, state_pieces, out_pieces)
    y = y.to(torch.bfloat16).double()
    y64, h64 = ssm_f64(x, dt, a, bm, cm, chunk)
    y_abs, h_abs = ssm_f64(x.abs(), dt, a, bm.abs(), cm.abs(), chunk)
    la_max = (a[None] * dt).reshape(-1, chunk, x.shape[1]).sum(1).abs().max().item()
    eps = 2.0**-20 * la_max + (chunk + bm.shape[-1]) * 2.0**-24
    ex_y = ((y - y64).abs() - SSM_REL_BF16 * y64.abs() - eps * y_abs).max().item()
    ex_h = ((h.double() - h64).abs() - eps * h_abs).max().item()
    return ex_y, ex_h


def test_source_constants():
    from repro_torch.kernels.ssm_scan import kernel

    assert STATE_PIECES == 3 and OUT_PIECES >= 2 and RUN == 16 and KEY_RUN % RUN == 0
    assert kernel.OUT_PIECES == OUT_PIECES   # the wrapper sizes the pieces' scratch
    assert SLICE % 32 == 0 and 1 <= RANKS <= 8


@pytest.mark.parametrize("n_pieces", [OUT_PIECES, STATE_PIECES])
@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e30])
def test_pieces_hold_the_bits_of_f32(scale, n_pieces):
    """Three pieces hold every bit of an f32 value, two its top 16."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy((rng.standard_normal(100_000) * scale).astype(np.float32))
    ps = pieces(v, n_pieces)
    for p in ps:
        assert torch.equal(p.to(torch.bfloat16).float(), p)   # each piece is a bf16 value
    total = ps[0].double()
    for p in ps[1:]:
        total = total + p.double()
    if n_pieces >= 3:
        assert torch.equal(total, v.double())
    assert ((total - v.double()).abs() <= 2.0**-(8 * n_pieces) * v.double().abs()).all()


@pytest.mark.parametrize("n_pieces", [2, 3])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_split_keeps_nan_and_inf(n_pieces, bad):
    """A NaN or inf factor's pieces carry it into every product: the
    first piece is the value itself, and v - bf16(v) is NaN for both."""
    v = torch.tensor([1.5, bad, -2.25], dtype=torch.float32)
    ps = pieces(v, n_pieces)
    assert torch.isnan(ps[1][1]) and all(torch.isfinite(p[[0, 2]]).all() for p in ps)
    x = torch.tensor([0.5, 3.0, -1.0], dtype=torch.float32)
    dot = sum((p.double() * x.double()).sum() for p in reversed(ps))
    assert torch.isnan(dot)


@pytest.mark.parametrize("chunk,dh,ds", [(16, 24, 16), (64, 24, 16), (256, 24, 16), (64, 16, 64)])
def test_emulated_bf16_scan_meets_the_per_element_bar(chunk, dh, ds):
    inputs = _inputs(2 * chunk, 2, dh, ds, seed=chunk + ds)
    ex_y, ex_h = _excess(inputs, chunk)
    assert ex_y <= 0.0 and ex_h <= 0.0, (ex_y, ex_h)


def test_one_piece_misses_the_bar():
    """bf16 factors (8 significant bits) are not enough: the bar tells
    the pieces apart from a plain bf16 product."""
    ex_y, ex_h = _excess(_inputs(128, 2, 24, 16, seed=64), 64, state_pieces=1, out_pieces=1)
    assert max(ex_y, ex_h) > 0.0


def test_two_pieces_miss_the_state_bar_at_one_step():
    """One real step (the rest padding, dt = 0): the state is a single
    product dt_0 x_0 B_0, |la| is tiny, and two pieces of w_s B_s (16
    bits) leave more than the bar's f32 allowance; three keep every bit.
    y, rounded to bf16, is held to 2**-7 of itself, so two pieces do."""
    x, dt, a, bm, cm = _inputs(16, 1, 8, 4, seed=3)
    for t in (x, dt, bm, cm):
        t[1:] = 0.0
    two = _excess((x, dt, a, bm, cm), 16, state_pieces=2)
    three = _excess((x, dt, a, bm, cm), 16, state_pieces=3)
    assert two[1] > 0.0 >= three[1] and max(two[0], three[0]) <= 0.0


def matmul_relu_emulated(w, x):
    """relu(W X) in f32 as the kernel sums it: per slice of SLICE k an fmaf
    chain in order from zero (each step rounded once), a warp's slices
    added in order, the R = min(S, RANKS) warps in warp order; the columns
    in the tiles of the width the kernel picks for n."""
    k, n = x.shape
    s = -(-k // SLICE)
    c = min(s, RANKS)
    bn = 8 if n <= 8 else 32
    cols = []
    for c0 in range(0, n, bn):
        xt = x[:, c0:c0 + bn].double()
        total = None
        for rank in range(c):
            kb, ke = rank * s // c * SLICE, min(k, (rank + 1) * s // c * SLICE)
            run = torch.zeros((w.shape[0], xt.shape[1]), dtype=torch.float32)
            for k0 in range(kb, ke, SLICE):
                acc = torch.zeros_like(run)
                for kk in range(k0, min(ke, k0 + SLICE)):
                    acc = (acc.double() + w[:, kk:kk + 1].double() * xt[kk]).float()
                run = run + acc
            total = run if total is None else total + run
        cols.append(total)
    return torch.relu(torch.cat(cols, dim=1))


@pytest.mark.parametrize("k", [784, 1020, 3000])
def test_matmul_relu_slice_order_gives_column_bits_independent_of_n(k):
    rng = np.random.default_rng(k)
    w = torch.from_numpy((rng.standard_normal((16, k)) / np.sqrt(k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((k, 128)).astype(np.float32))
    full = matmul_relu_emulated(w, x)
    for n in (1, 8, 32, 65):
        assert torch.equal(matmul_relu_emulated(w, x[:, :n].contiguous()), full[:, :n]), n
    want = torch.relu(w.double() @ x.double())
    assert (full.double() - want).abs().max() <= 1e-5 * want.abs().max()
