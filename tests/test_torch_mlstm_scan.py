"""repro_torch's mLSTM scan on the CPU against ``repro``'s.

The same numpy inputs go through ``repro`` (the ``mlstm_scan`` Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it, and
``repro.nn.xlstm.chunked_mlstm``) and through the port, whose
``mlstm_scan`` op takes its plain version for CPU tensors.

Tolerances, against max|want|: f32 2e-5.  Both sum in f32 in other
orders, and each weight exp(F_t - F_s + i_s - m_t) carries the rounding
of the in-chunk cumulative sum F of logsigmoid(f) (about -13 over 64
steps here, an ulp of 1e-6) as a relative error.  bf16 1e-2: both round
one f32 result to bf16 (one bf16 ulp, 2**-8 of its size).  The state (C,
n, m) is f32 in both and keeps the f32 tolerance.  The chunked form
against the step-by-step recurrence: 1e-5 x max|y| (the same f32 math
grouped per step instead of per chunk).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan.kernel import mlstm_scan_pallas as j_mlstm_scan_pallas
from repro.nn import xlstm as j_xlstm
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.nn import xlstm

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _inputs(b, s, h, dk, dv, seed):
    """q, k, v ~ N(0, 1); i_pre ~ N(0, 1); f_pre ~ N(3, 1), the model's
    forget-gate bias of +3, as f32 numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    i_pre = rng.standard_normal((b, s, h)).astype(np.float32)
    f_pre = (rng.standard_normal((b, s, h)) + 3.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _both(arrays, dtype):
    """(jax arrays, torch tensors): q, k and v in ``dtype``, the gates f32."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, i_pre, f_pre = arrays
    j = tuple(jnp.asarray(a).astype(jdt) for a in (q, k, v)) + (jnp.asarray(i_pre),
                                                               jnp.asarray(f_pre))
    t = tuple(torch.from_numpy(a).to(tdt) for a in (q, k, v)) + (torch.from_numpy(i_pre),
                                                                 torch.from_numpy(f_pre))
    return j, t


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_scaled(got, want, rel):
    got, want = _f32(got), _f32(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel * float(np.abs(want).max()))


def _j_state(b, h, dk, dv):
    return j_xlstm.init_mlstm_state(b, h, dk, dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk,dk,dv", [(64, 16, 16, 16), (128, 32, 32, 48),
                                           (256, 64, 64, 64), (192, 64, 16, 32)])
def test_plain_matches_pallas_and_reference(s, chunk, dk, dv, dtype):
    (jq, jk, jv, ji, jf), (q, k, v, i_pre, f_pre) = _both(_inputs(2, s, 3, dk, dv, s + dk),
                                                          dtype)
    before = ms.launch_count()
    y, (c, n, m) = ms.mlstm_scan(q, k, v, i_pre, f_pre, chunk=chunk)
    assert ms.launch_count() == before                 # the CPU takes the plain version
    assert y.dtype == q.dtype and y.shape == (2, s, 3, dv)
    assert (c.shape, n.shape, m.shape) == ((2, 3, dk, dv), (2, 3, dk), (2, 3))
    assert c.dtype == n.dtype == m.dtype == torch.float32
    want_y, (want_c, want_n, want_m) = j_mlstm_scan_pallas(jq, jk, jv, ji, jf, chunk=chunk,
                                                           interpret=True)
    ref_y, ref_st = j_xlstm.chunked_mlstm(jq, jk, jv, ji, jf, _j_state(2, 3, dk, dv),
                                          chunk=chunk)
    for wy, wc, wn, wm in ((want_y, want_c, want_n, want_m),
                           (ref_y, ref_st.c, ref_st.n, ref_st.m)):
        _close_scaled(y, wy, TOL[dtype])
        _close_scaled(c, wc, TOL["float32"])
        _close_scaled(n, wn, TOL["float32"])
        _close_scaled(m, wm, TOL["float32"])


def test_op_is_the_plain_version_on_the_cpu():
    _, t = _both(_inputs(2, 96, 2, 16, 24, 0), "float32")
    got = ms.mlstm_scan(*t, chunk=32)
    want = ms.mlstm_scan_ref(*t, chunk=32)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_scan_refuses_a_sequence_that_is_not_whole_chunks():
    _, t = _both(_inputs(1, 40, 2, 16, 16, 0), "float32")
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ms.mlstm_scan(*t, chunk=16)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_chunked_matches_sequential_decode_steps(chunk):
    """From a nonzero state, against ``repro``'s chunked form and against a
    step-by-step loop of the port's decode step."""
    b, s, h, dk, dv = 2, 96, 3, 16, 24
    q, k, v, i_pre, f_pre = (torch.from_numpy(a) for a in _inputs(b, s, h, dk, dv, chunk))
    rng = np.random.default_rng(1)
    st0 = xlstm.MLSTMState(
        c=torch.from_numpy(rng.standard_normal((b, h, dk, dv)).astype(np.float32)),
        n=torch.from_numpy(rng.standard_normal((b, h, dk)).astype(np.float32)),
        m=torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32)),
    )
    y, st = xlstm.chunked_mlstm(q, k, v, i_pre, f_pre, st0, chunk=chunk)
    jy, jst = j_xlstm.chunked_mlstm(*(jnp.asarray(t.numpy()) for t in (q, k, v, i_pre, f_pre)),
                                    j_xlstm.MLSTMState(*(jnp.asarray(t.numpy()) for t in st0)),
                                    chunk=chunk)
    _close_scaled(y, jy, TOL["float32"])
    for got, want in zip(st, jst):
        _close_scaled(got, want, TOL["float32"])
    state = st0
    for t in range(s):
        yt, state = xlstm.mlstm_decode_step(q[:, t], k[:, t], v[:, t], i_pre[:, t],
                                            f_pre[:, t], state)
        assert np.abs(_f32(yt) - _f32(y[:, t])).max() <= 1e-5 * float(y.abs().max())
    # The states agree once each is scaled back by exp(m).
    scale = torch.exp(state.m - st.m)
    _close_scaled(state.c * scale[..., None, None], st.c, 1e-5)
    _close_scaled(state.n * scale[..., None], st.n, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    b, h, dk, dv = 2, 3, 16, 24
    q, k = (rng.standard_normal((b, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, h, dv)).astype(np.float32)
    i_pre, f_pre = (rng.standard_normal((b, h)).astype(np.float32) for _ in range(2))
    st = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((b, h, dk, dv), (b, h, dk), (b, h))]
    y, new = xlstm.mlstm_decode_step(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(i_pre),
        torch.from_numpy(f_pre), xlstm.MLSTMState(*(torch.from_numpy(a) for a in st)))
    jy, jnew = j_xlstm.mlstm_decode_step(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(i_pre),
        jnp.asarray(f_pre), j_xlstm.MLSTMState(*(jnp.asarray(a) for a in st)))
    assert y.dtype == tdt and all(t.dtype == torch.float32 for t in new)
    _close_scaled(y, jy, TOL[dtype])
    for got, want in zip(new, jnew):
        _close_scaled(got, want, TOL["float32"])


def _pad(arrays, s_to):
    """The model's padding: zeros for q, k, v; i_pre -1e9, f_pre +1e9."""
    q, k, v, i_pre, f_pre = arrays
    pad = s_to - q.shape[1]
    z = lambda a: np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))
    return (z(q), z(k), z(v), np.pad(i_pre, ((0, 0), (0, pad), (0, 0)), constant_values=-1e9),
            np.pad(f_pre, ((0, 0), (0, pad), (0, 0)), constant_values=1e9))


@pytest.mark.parametrize("s", [7, 40, 100])
def test_padded_steps_change_neither_outputs_nor_state(s):
    """S padded to whole chunks of 16 with the model's padding gives the
    unpadded y on the real steps and the unpadded final state (``repro``'s
    chunked form over one chunk of S, its fallback for S % chunk != 0)."""
    arrays = _inputs(2, s, 3, 16, 24, s)
    padded = _pad(arrays, -(-s // 16) * 16)
    y, (c, n, m) = ms.mlstm_scan(*(torch.from_numpy(a) for a in padded), chunk=16)
    jy, jst = j_xlstm.chunked_mlstm(*(jnp.asarray(a) for a in arrays), _j_state(2, 3, 16, 24),
                                    chunk=s)
    _close_scaled(y[:, :s], jy, TOL["float32"])
    assert not y[:, s:].any()                  # q = 0 on padded rows
    for got, want in zip((c, n, m), jst):
        _close_scaled(got, want, TOL["float32"])
