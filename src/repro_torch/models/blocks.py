"""Parameter init and application of the per-layer blocks.

Port of ``repro/models/blocks.py``: attention, the FFN, the transformer
layer, the Mamba2 layer and the mLSTM and sLSTM layers.  Parameters are
plain dicts of tensors with the reference's names; an init function
given ``stack=(L,)`` draws L layers at once, stacked on leading axes as
the reference's vmapped init stacks them.  The MoE FFN is not ported
yet and raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mlstm_scan import mlstm_scan
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.config import ModelConfig
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn import xlstm as xlstm_lib
from repro_torch.nn.layers import dense_init, rms_norm, round_up
from repro_torch.nn.mlp import swiglu
from repro_torch.nn.rope import apply_rope

Params = dict[str, Any]


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 {item})"
    )


# ---------------------------------------------------------------- attention

def init_attn_params(gen: torch.Generator, cfg: ModelConfig, stack: tuple[int, ...] = ()) -> Params:
    d, hd = cfg.d_model, cfg.hd
    dt = cfg.torch_dtype
    return {
        "wq": dense_init(gen, stack + (d, cfg.num_heads * hd), dt),
        "wk": dense_init(gen, stack + (d, cfg.num_kv_heads * hd), dt),
        "wv": dense_init(gen, stack + (d, cfg.num_kv_heads * hd), dt),
        "wo": dense_init(gen, stack + (cfg.num_heads * hd, d), dt),
    }


def apply_attention(
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    cache: attn_lib.KVCache | None,
    *,
    window: int | None,
) -> tuple[torch.Tensor, attn_lib.KVCache | None]:
    """Self-attention of x (B, S, d).  Without a cache (the full-sequence
    forward) and with ``cfg.use_pallas_kernels``, attention goes through
    the ``flash_attention`` op: the hand-written CUDA kernel on the card,
    at every S (where the reference falls back to the chunked path unless
    S % 128 == 0), or its plain version on the CPU.  Both compute the same
    exact causal (sliding-window) attention as the chunked path; the op
    takes the KV heads unrepeated, the chunked path repeated.  With a
    cache, one token is written to it and attends to it."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if cfg.use_pallas_kernels:  # the op reads each KV head in place (GQA)
            out = flash_attention(
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(),
                window=window,
            ).transpose(1, 2)
        else:
            out = attn_lib.chunked_causal_attention(
                q, attn_lib.repeat_kv(k, cfg.num_heads), attn_lib.repeat_kv(v, cfg.num_heads),
                chunk_size=min(cfg.attn_chunk, s), window=window
            )
        new_cache = None
    else:
        cache = attn_lib.cache_update(cache, k, v)
        out = attn_lib.decode_attention(q, cache, num_heads=cfg.num_heads, window=window)
        new_cache = cache
    y = out.reshape(b, s, cfg.num_heads * hd) @ p["wo"]
    return y, new_cache


# ---------------------------------------------------------------- mlp / moe

def init_ffn_params(gen: torch.Generator, cfg: ModelConfig, stack: tuple[int, ...] = ()) -> Params:
    if cfg.num_experts:
        raise unported("the MoE FFN", "item 12")
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "wg": dense_init(gen, stack + (d, f), dt),
        "wu": dense_init(gen, stack + (d, f), dt),
        "wd": dense_init(gen, stack + (f, d), dt),
    }


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, moe_aux_loss); the aux loss is 0 without experts."""
    if cfg.num_experts:
        raise unported("the MoE FFN", "item 12")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return swiglu(x, p["wg"], p["wu"], p["wd"]), aux


# ------------------------------------------------------- transformer layer

def init_transformer_layer(
    gen: torch.Generator, cfg: ModelConfig, stack: tuple[int, ...] = ()
) -> Params:
    d, dt = cfg.d_model, cfg.torch_dtype
    return {
        "ln1": torch.ones(stack + (d,), dtype=dt, device=gen.device),
        "ln2": torch.ones(stack + (d,), dtype=dt, device=gen.device),
        "attn": init_attn_params(gen, cfg, stack),
        "ffn": init_ffn_params(gen, cfg, stack),
    }


def apply_transformer_layer(
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    cache: attn_lib.KVCache | None,
) -> tuple[torch.Tensor, attn_lib.KVCache | None, torch.Tensor]:
    window = cfg.window if cfg.attention == "swa" else None
    h, new_cache = apply_attention(
        p["attn"], rms_norm(x, p["ln1"]), positions, cfg, cache, window=window
    )
    x = x + h
    f, aux = apply_ffn(p["ffn"], rms_norm(x, p["ln2"]), cfg)
    if cfg.d_ff:
        x = x + f
    return x, new_cache, aux


# ------------------------------------------------------------ mamba2 layer

def init_mamba_layer(gen: torch.Generator, cfg: ModelConfig, stack: tuple[int, ...] = ()) -> Params:
    """A Mamba2 layer's parameters in ``cfg.torch_dtype``, except ``a_log``
    and ``dt_bias``, which are f32 whatever the model's dtype, as in the
    reference."""
    d, di = cfg.d_model, cfg.d_inner_eff
    ds, h = cfg.ssm_state, cfg.ssm_heads
    dt, dev = cfg.torch_dtype, gen.device
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev))
    return {
        "ln": torch.ones(stack + (d,), dtype=dt, device=dev),
        "in_x": dense_init(gen, stack + (d, di), dt),
        "in_z": dense_init(gen, stack + (d, di), dt),
        "in_b": dense_init(gen, stack + (d, ds), dt),
        "in_c": dense_init(gen, stack + (d, ds), dt),
        "in_dt": dense_init(gen, stack + (d, h), dt),
        "conv_w": dense_init(gen, stack + (cfg.conv_kernel, di), dt, scale=0.5),
        "conv_b": torch.zeros(stack + (di,), dtype=dt, device=dev),
        "a_log": a_log.expand(stack + (h,)).clone(),     # A = -exp(a_log)
        "dt_bias": torch.full(stack + (h,), -2.0, dtype=torch.float32, device=dev),
        "gn": torch.ones(stack + (di,), dtype=dt, device=dev),
        "out": dense_init(gen, stack + (di, d), dt),
    }


def apply_mamba_layer(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: ssm_lib.SSMState | None,
) -> tuple[torch.Tensor, ssm_lib.SSMState | None]:
    """A Mamba2 layer on x (B, S, d), routed as the reference routes it:
    with no state (the full-sequence scoring forward) the scan goes through
    the ``ssm_scan`` op when ``cfg.use_pallas_kernels`` (the CUDA kernel on
    the card, its plain version on the CPU), else through the plain chunked
    scan; with a state and S > 1 (prefill) through the plain chunked scan
    from a zero state; with a state and S = 1 (decode) one recurrence step
    on the carried state and the rolling conv inputs.  Returns (x + the
    layer's output, the new state or None).

    The sequence is padded with dt = 0 steps (no decay, no input) to whole
    chunks of min(cfg.ssm_chunk, S rounded up to 16); the reference's
    chunk is min(cfg.ssm_chunk, S).  The two give the same function, and
    the kernel takes only chunks that are multiples of 16."""
    b, s, _ = x.shape
    di = cfg.d_inner_eff
    h_heads = cfg.ssm_heads
    dh = di // h_heads
    res = x
    xn = rms_norm(x, p["ln"])
    xs = xn @ p["in_x"]
    z = xn @ p["in_z"]
    bm = xn @ p["in_b"]
    cm = xn @ p["in_c"]
    dt = torch.nn.functional.softplus((xn @ p["in_dt"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    if state is not None and s == 1:
        xs, conv_new = ssm_lib.causal_conv1d(xs, p["conv_w"], p["conv_b"], state.conv)
        y, h_new = ssm_lib.ssm_decode_step(
            xs.reshape(b, h_heads, dh), dt[:, 0], a, bm[:, 0], cm[:, 0], state.h
        )
        y = y.reshape(b, 1, di)
        new_state = ssm_lib.SSMState(h=h_new, conv=conv_new)
    else:
        xs, conv_new = ssm_lib.causal_conv1d(xs, p["conv_w"], p["conv_b"])
        chunk = min(cfg.ssm_chunk, round_up(s, 16))
        pad = (-s) % chunk
        if pad:
            # dt = 0 on padded steps: no decay (a = 1), no input contribution.
            xs, dt, bm, cm = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (xs, dt, bm, cm))
        x4 = xs.reshape(b, s + pad, h_heads, dh)
        if cfg.use_pallas_kernels and state is None:
            y, h_new = ssm_scan(x4, dt, a, bm, cm, chunk=chunk)
        else:
            h0 = torch.zeros((b, h_heads, dh, cfg.ssm_state), dtype=torch.float32,
                             device=x.device)
            y, h_new = ssm_lib.chunked_ssm_scan(x4, dt, a, bm, cm, h0, chunk=chunk)
        y = y[:, :s].reshape(b, s, di)
        new_state = ssm_lib.SSMState(h=h_new, conv=conv_new) if state is not None else None
    y = rms_norm(y * torch.nn.functional.silu(z), p["gn"])
    return res + y @ p["out"], new_state


# ------------------------------------------------------------ xlstm layers

def init_mlstm_layer(gen: torch.Generator, cfg: ModelConfig, stack: tuple[int, ...] = ()) -> Params:
    """An mLSTM layer's parameters in ``cfg.torch_dtype``, except the gate
    projections ``wi`` and ``wf``, which are f32 whatever the model's
    dtype, as in the reference."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.hd
    dt, dev = cfg.torch_dtype, gen.device
    return {
        "ln": torch.ones(stack + (d,), dtype=dt, device=dev),
        "wq": dense_init(gen, stack + (d, h * hd), dt),
        "wk": dense_init(gen, stack + (d, h * hd), dt),
        "wv": dense_init(gen, stack + (d, h * hd), dt),
        "wi": dense_init(gen, stack + (d, h), torch.float32),
        "wf": dense_init(gen, stack + (d, h), torch.float32),
        "gn": torch.ones(stack + (h * hd,), dtype=dt, device=dev),
        "out": dense_init(gen, stack + (h * hd, d), dt),
    }


def apply_mlstm_layer(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: xlstm_lib.MLSTMState | None,
) -> tuple[torch.Tensor, xlstm_lib.MLSTMState | None]:
    """An mLSTM layer on x (B, S, d), routed as the reference routes it:
    with no state (the full-sequence scoring forward) the scan goes through
    the ``mlstm_scan`` op when ``cfg.use_pallas_kernels`` (the CUDA kernel
    on the card, its plain version on the CPU), else through the plain
    chunked scan; with a state and S > 1 (prefill) through the plain
    chunked scan from that state; with a state and S = 1 (decode) one
    recurrence step.  Returns (x + the layer's output, the new state or
    None).

    The sequence is padded with steps of input gate -1e9 and forget gate
    +1e9 (nothing enters, nothing decays) to whole chunks of
    min(cfg.ssm_chunk, S rounded up to 16); the reference's chunk is
    min(cfg.ssm_chunk, S).  The two give the same function, and the kernel
    takes only chunks that are multiples of 16."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    res = x
    xn = rms_norm(x, p["ln"])
    q = (xn @ p["wq"]).reshape(b, s, h, hd)
    k = (xn @ p["wk"]).reshape(b, s, h, hd)
    v = (xn @ p["wv"]).reshape(b, s, h, hd)
    i_pre = xn.float() @ p["wi"]
    f_pre = xn.float() @ p["wf"] + 3.0

    if state is not None and s == 1:
        y, new_state = xlstm_lib.mlstm_decode_step(
            q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0], state
        )
        y = y.reshape(b, 1, h * hd)
    else:
        chunk = min(cfg.ssm_chunk, round_up(s, 16))
        pad = (-s) % chunk
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            i_pre = torch.nn.functional.pad(i_pre, (0, 0, 0, pad), value=-1e9)
            f_pre = torch.nn.functional.pad(f_pre, (0, 0, 0, pad), value=1e9)
        if cfg.use_pallas_kernels and state is None:
            y, _ = mlstm_scan(q, k, v, i_pre, f_pre, chunk=chunk)
            new_state = None
        else:
            st0 = state if state is not None else xlstm_lib.init_mlstm_state(
                b, h, hd, hd, device=x.device)
            y, new_state = xlstm_lib.chunked_mlstm(q, k, v, i_pre, f_pre, st0, chunk=chunk)
            if state is None:
                new_state = None
        y = y[:, :s].reshape(b, s, h * hd)
    y = rms_norm(y, p["gn"])
    return res + y @ p["out"], new_state


def init_slstm_layer(gen: torch.Generator, cfg: ModelConfig, stack: tuple[int, ...] = ()) -> Params:
    """An sLSTM layer's parameters in ``cfg.torch_dtype``, except the
    block-diagonal recurrent weights ``rw`` (4, H, dh, dh), which are f32
    whatever the model's dtype, as in the reference."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    dt, dev = cfg.torch_dtype, gen.device
    return {
        "ln": torch.ones(stack + (d,), dtype=dt, device=dev),
        "wx": dense_init(gen, stack + (d, 4 * d), dt),
        "rw": dense_init(gen, stack + (4, h, dh, dh), torch.float32, scale=1.0 / math.sqrt(dh)),
        "gn": torch.ones(stack + (d,), dtype=dt, device=dev),
        "out": dense_init(gen, stack + (d, d), dt),
    }


def apply_slstm_layer(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    state: xlstm_lib.SLSTMState | None,
) -> tuple[torch.Tensor, xlstm_lib.SLSTMState | None]:
    """An sLSTM layer on x (B, S, d): the step-by-step recurrence from
    ``state`` (or the zero state), which has no kernel in the reference
    either.  Returns (x + the layer's output, the new state, or None when
    no state was given)."""
    b, _, d = x.shape
    res = x
    x_gates = rms_norm(x, p["ln"]) @ p["wx"]
    st0 = state if state is not None else xlstm_lib.init_slstm_state(b, d, device=x.device)
    hs, new_state = xlstm_lib.slstm_scan(x_gates, p["rw"], st0, cfg.num_heads)
    y = rms_norm(hs.to(x.dtype), p["gn"]) @ p["out"]
    return res + y, new_state if state is not None else None
