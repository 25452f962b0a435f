"""repro_torch's Mamba2 scan, conv and layer on the CPU against ``repro``'s.

The same numpy inputs go through ``repro`` (the ``ssm_scan`` Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it, its ``ssm_scan_ref``
and ``repro.nn.ssm``) and through the port, whose ``ssm_scan`` op takes
its plain version for CPU tensors.

Tolerances, against max|want|: f32 2e-5.  Both sum in f32 in other
orders, and the decays exp(la_t - la_s) carry the rounding of the
in-chunk cumulative sum la (|la| reaches about 100 at chunk 64 here, an
ulp of 7.6e-6), which enters each term as a relative error; measured
below 4e-6.  bf16 1e-2: both round one f32 result to bf16, so an element
may differ by one bf16 ulp (2**-8 of its size); measured below 4e-4.
The final state h is f32 in both and keeps the f32 tolerance.  The
sequential recurrence against the chunked scan: 1e-5 x max|y| (the same
f32 math grouped per step instead of per chunk).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan
from repro.kernels.ssm_scan import ssm_scan_ref as j_ssm_scan_ref
from repro.models import blocks as j_blocks
from repro.nn import ssm as j_ssm
from repro_torch.configs import get_config
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import blocks
from repro_torch.nn import ssm

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _inputs(b, s, h, dh, ds, seed):
    """x, dt = softplus(N(0, 1)), a = -exp(N(0, 1)), B, C as f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    cm = rng.standard_normal((b, s, ds)).astype(np.float32)
    return x, dt, a, bm, cm


def _both(arrays, dtype):
    """(jax arrays, torch tensors): x, B and C in ``dtype``, dt and a f32."""
    jdt, tdt = DTYPES[dtype]
    x, dt, a, bm, cm = arrays
    j = (jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(a),
         jnp.asarray(bm).astype(jdt), jnp.asarray(cm).astype(jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(a),
         torch.from_numpy(bm).to(tdt), torch.from_numpy(cm).to(tdt))
    return j, t


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_scaled(got, want, rel):
    got, want = _f32(got), _f32(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel * float(np.abs(want).max()))


# ------------------------------------------------------------------ ssm_scan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk,dh,ds", [(64, 16, 16, 8), (128, 32, 80, 16),
                                           (256, 64, 128, 16), (192, 64, 16, 8)])
def test_plain_matches_pallas_and_reference(s, chunk, dh, ds, dtype):
    (jx, jdt, ja, jb, jc), (x, dt, a, bm, cm) = _both(_inputs(2, s, 3, dh, ds, s + dh), dtype)
    before = ss.launch_count()
    y, h = ss.ssm_scan(x, dt, a, bm, cm, chunk=chunk)
    assert ss.launch_count() == before                 # the CPU takes the plain version
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (2, 3, dh, ds)
    for want_y, want_h in (j_ssm_scan(jx, jdt, ja, jb, jc, chunk=chunk),
                           j_ssm_scan_ref(jx, jdt, ja, jb, jc, chunk=chunk)):
        _close_scaled(y, want_y, TOL[dtype])
        _close_scaled(h, want_h, TOL["float32"])


def test_op_is_the_plain_version_on_the_cpu():
    _, (x, dt, a, bm, cm) = _both(_inputs(2, 96, 2, 16, 8, 0), "float32")
    got = ss.ssm_scan(x, dt, a, bm, cm, chunk=32)
    want = ss.ssm_scan_ref(x, dt, a, bm, cm, chunk=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scan_refuses_a_sequence_that_is_not_whole_chunks():
    _, (x, dt, a, bm, cm) = _both(_inputs(1, 40, 2, 16, 8, 0), "float32")
    with pytest.raises(ValueError, match="not divisible by chunk"):
        ss.ssm_scan(x, dt, a, bm, cm, chunk=16)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_chunked_scan_matches_sequential_decode_steps(chunk):
    """From a nonzero state, against the port's and ``repro``'s chunked
    scans and against a step-by-step loop of the port's decode step."""
    b, s, h, dh, ds = 2, 96, 3, 16, 8
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in _inputs(b, s, h, dh, ds, chunk))
    h0 = torch.from_numpy(np.random.default_rng(1).standard_normal((b, h, dh, ds))
                          .astype(np.float32))
    y, hf = ssm.chunked_ssm_scan(x, dt, a, bm, cm, h0, chunk=chunk)
    jy, jh = j_ssm.chunked_ssm_scan(*(jnp.asarray(t.numpy()) for t in (x, dt, a, bm, cm, h0)),
                                    chunk=chunk)
    _close_scaled(y, jy, TOL["float32"])
    _close_scaled(hf, jh, TOL["float32"])
    state = h0
    for t in range(s):
        yt, state = ssm.ssm_decode_step(x[:, t], dt[:, t], a, bm[:, t], cm[:, t], state)
        assert np.abs(_f32(yt) - _f32(y[:, t])).max() <= 1e-5 * float(y.abs().max())
    _close_scaled(state, hf, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    b, h, dh, ds = 2, 3, 16, 8
    x = rng.standard_normal((b, h, dh)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, h)), 0.0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, ds)).astype(np.float32) for _ in range(2))
    hs = rng.standard_normal((b, h, dh, ds)).astype(np.float32)
    y, hn = ssm.ssm_decode_step(torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                                torch.from_numpy(a), torch.from_numpy(bm).to(tdt),
                                torch.from_numpy(cm).to(tdt), torch.from_numpy(hs))
    jy, jh = j_ssm.ssm_decode_step(jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(a),
                                   jnp.asarray(bm).astype(jdt), jnp.asarray(cm).astype(jdt),
                                   jnp.asarray(hs))
    assert y.dtype == tdt and hn.dtype == torch.float32
    _close_scaled(y, jy, TOL[dtype])
    _close_scaled(hn, jh, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv1d_matches_reference(with_prev, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    b, s, c, ker = 2, 7, 12, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = (rng.standard_normal((ker, c)) * 0.5).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    prev = rng.standard_normal((b, ker - 1, c)).astype(np.float32) if with_prev else None
    got, got_prev = ssm.causal_conv1d(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(bias).to(tdt),
        None if prev is None else torch.from_numpy(prev).to(tdt))
    want, want_prev = j_ssm.causal_conv1d(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), jnp.asarray(bias).astype(jdt),
        None if prev is None else jnp.asarray(prev).astype(jdt))
    assert got.dtype == tdt and got_prev.shape == (b, ker - 1, c)
    _close_scaled(got, want, 1e-6 if dtype == "float32" else TOL[dtype])
    assert np.array_equal(_f32(got_prev), _f32(want_prev))   # the last ker-1 inputs
    # One step with the carried inputs equals the last row of the whole pass.
    whole, _ = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(bias))
    _, prev_in = ssm.causal_conv1d(torch.from_numpy(x[:, :-1]), torch.from_numpy(w),
                                   torch.from_numpy(bias))
    step, _ = ssm.causal_conv1d(torch.from_numpy(x[:, -1:]), torch.from_numpy(w),
                                torch.from_numpy(bias), prev_in)
    np.testing.assert_allclose(step[:, 0].numpy(), whole[:, -1].numpy(), rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- mamba layer


def _layer_configs(**over):
    jcfg = dataclasses.replace(j_get_config("zamba2_2_7b").reduced(), **over)
    cfg = dataclasses.replace(get_config("zamba2_2_7b").reduced(), **over)
    return jcfg, cfg


def _layer_params(jcfg, cfg):
    jp = j_blocks.init_mamba_layer(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    p = {k: torch.tensor(np.asarray(v, np.float32),
                         dtype=torch.float32 if k in ("a_log", "dt_bias") else cfg.torch_dtype)
         for k, v in tree.items()}
    return jp, p


def _hidden(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("s", [64, 40, 7])
def test_mamba_layer_forward_matches_reference(s, kernels):
    """State None: the scoring forward's layer.  S = 40 and 7 pad the scan
    to whole chunks (of 16)."""
    jcfg, cfg = _layer_configs(use_pallas_kernels=kernels)
    jp, p = _layer_params(jcfg, cfg)
    x = _hidden(2, s, cfg.d_model, s)
    want, want_state = j_blocks.apply_mamba_layer(jp, jnp.asarray(x), jcfg, None)
    before = ss.launch_count()
    got, state = blocks.apply_mamba_layer(p, torch.from_numpy(x), cfg, None)
    assert ss.launch_count() == before and state is None and want_state is None
    _close_scaled(got, want, 1e-5)


def test_mamba_layer_prefill_and_decode_match_reference():
    """With a state: S > 1 (prefill, the plain chunked scan from zero) gives
    the final state and the last conv inputs; S = 1 steps them on."""
    jcfg, cfg = _layer_configs()
    jp, p = _layer_params(jcfg, cfg)
    di, h = cfg.d_inner_eff, cfg.ssm_heads
    x = _hidden(2, 45, cfg.d_model, 9)
    jzero = j_ssm.SSMState(h=jnp.zeros((2, h, di // h, cfg.ssm_state)),
                           conv=jnp.zeros((2, cfg.conv_kernel - 1, di)))
    zero = ssm.SSMState(h=torch.zeros((2, h, di // h, cfg.ssm_state)),
                        conv=torch.zeros((2, cfg.conv_kernel - 1, di)))
    full, _ = blocks.apply_mamba_layer(p, torch.from_numpy(x), cfg, None)
    got, st = blocks.apply_mamba_layer(p, torch.from_numpy(x[:, :42]), cfg, zero)
    want, jst = j_blocks.apply_mamba_layer(jp, jnp.asarray(x[:, :42]), jcfg, jzero)
    _close_scaled(got, want, 1e-5)
    _close_scaled(st.h, jst.h, TOL["float32"])
    _close_scaled(st.conv, jst.conv, 1e-5)        # the last 3 steps' x projections
    for t in range(42, 45):
        got, st = blocks.apply_mamba_layer(p, torch.from_numpy(x[:, t:t + 1]), cfg, st)
        want, jst = j_blocks.apply_mamba_layer(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jst)
        _close_scaled(got, want, 1e-5)
        _close_scaled(st.h, jst.h, TOL["float32"])
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(), atol=1e-4)


def test_mamba_layer_bf16_matches_reference_and_keeps_f32_rates():
    jcfg, cfg = _layer_configs(dtype="bfloat16", use_pallas_kernels=True)
    jp, p = _layer_params(jcfg, cfg)
    assert p["a_log"].dtype == torch.float32 and p["in_x"].dtype == torch.bfloat16
    x = _hidden(2, 48, cfg.d_model, 11)
    want, _ = j_blocks.apply_mamba_layer(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg, None)
    got, _ = blocks.apply_mamba_layer(p, torch.from_numpy(x).to(torch.bfloat16), cfg, None)
    assert got.dtype == torch.bfloat16
    _close_scaled(got, want, 3e-2)


def test_mamba_init_matches_reference_shapes_and_dtypes():
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _layer_configs(dtype=dtype)
        jp = j_blocks.init_mamba_layer(jax.random.PRNGKey(0), jcfg)
        p = blocks.init_mamba_layer(torch.Generator().manual_seed(0), cfg, stack=(2, 3))
        assert set(p) == set(jp)
        for k, v in jp.items():
            assert tuple(p[k].shape) == (2, 3) + v.shape, k
            want = torch.float32 if v.dtype == jnp.float32 else torch.bfloat16
            assert p[k].dtype == want, k
        np.testing.assert_allclose(p["a_log"][1, 2].numpy(), np.asarray(jp["a_log"]), rtol=1e-6)
        assert torch.equal(p["dt_bias"], torch.full((2, 3, cfg.ssm_heads), -2.0))
