"""Parameter init and application of the per-layer blocks.

Port of ``repro/models/blocks.py``: attention, the FFN, the transformer
layer, the Mamba2 layer and the mLSTM and sLSTM layers.  Parameters are
plain dicts of tensors with the reference's names; an init function
given ``stack=(L,)`` draws L layers at once, stacked on leading axes as
the reference's vmapped init stacks them.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mlstm_scan import mlstm_scan
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.config import ModelConfig
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn import xlstm as xlstm_lib
from repro_torch.nn.layers import (GenDraw, dense_init, rms_norm, rms_norm_split,
                                   round_up)
from repro_torch.nn.mlp import swiglu
from repro_torch.nn.rope import apply_rope
from repro_torch.sharding import parallel as par

Params = dict[str, Any]


# ---------------------------------------------------------------- attention

def init_attn_params(draw: GenDraw, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.hd
    dt = cfg.torch_dtype
    kq, kk, kv, ko = draw.split(4)
    return {
        "wq": kq.dense((d, cfg.num_heads * hd), dt),
        "wk": kk.dense((d, cfg.num_kv_heads * hd), dt),
        "wv": kv.dense((d, cfg.num_kv_heads * hd), dt),
        "wo": ko.dense((cfg.num_heads * hd, d), dt),
    }


def local_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(query heads, KV heads) of this rank: the config's on one device;
    on a grid, H / model and KV / model where the spec splits ``wq`` and
    ``wk`` over the model row (their columns divide), else the whole
    count.  Heads are split in contiguous blocks, so GQA's grouping (query
    head h reads KV head h // (H / KV)) holds within a rank.  A split that
    would cut a head raises."""
    grid = par.current_grid()
    mp = 1 if grid is None else grid.model_parallel
    out = []
    for heads in (cfg.num_heads, cfg.num_kv_heads):
        if mp == 1 or (heads * cfg.hd) % mp:
            out.append(heads)
        elif heads % mp:
            raise ValueError(f"{cfg.name}: a model row of {mp} would split one of "
                             f"{heads} heads of {cfg.hd}; choose a model_parallel that "
                             "divides the head counts")
        else:
            out.append(heads // mp)
    hl, kvl = out
    if hl % kvl:
        raise ValueError(f"{cfg.name}: {hl} local query heads over {kvl} KV heads")
    return hl, kvl


def local_units(cfg: ModelConfig, units: int, local: int, full: int) -> int:
    """How many of a block's ``units`` heads this rank holds when it holds
    ``local`` of the ``full`` channels they fill (a ``"T"`` dim split over
    the model row in contiguous blocks); a split that cuts a head
    raises."""
    if local == full:
        return units
    if (units * local) % full:
        raise ValueError(f"{cfg.name}: a model row of {full // local} would split one of "
                         f"{units} heads; choose a model_parallel that divides the head count")
    return units * local // full


def local_block(cfg: ModelConfig, *path: str) -> int:
    """The last dim of this rank's block of the parameter at ``path``
    (``"mamba", "in_x"``): the whole dim with no grid current, else as the
    planner's spec tree (``rules.param_specs``) cuts it over the model
    row, the layout the layers read from their shards.  What a cache or a
    zero state is sized by before any weight is at hand."""
    from repro_torch.convert import param_shapes
    from repro_torch.launch.specs import lookup
    from repro_torch.sharding import rules as rules_lib

    full = lookup(param_shapes(cfg), path)[-1]
    grid = par.current_grid()
    if grid is None:
        return full
    spec = lookup(rules_lib.param_specs(cfg, grid.rules, grid.plan), path)
    return full // rules_lib.axes_size(spec[-1], grid.plan)


def attention_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Rotated q (B, S, H', hd) and k, v (B, S, KV', hd) of x (B, S, d),
    and this rank's ``wo`` and whether the block is split over the model
    row.  H' and KV' are this rank's heads, read from the weights' shapes
    (``local_heads``): on a grid the weights are this rank's shards, their
    FSDP rows gathered, and x enters the column-parallel products through
    ``sharding/parallel.enter_model``."""
    b, s, _ = x.shape
    hd = cfg.hd
    wq, wk, wv, wo = (par.fsdp(p[n], n, cfg.d_model) for n in ("wq", "wk", "wv", "wo"))
    split = par.model_split(wq.shape[-1], cfg.num_heads * hd)
    hl, kvl = local_heads(cfg)
    if (hl * hd, kvl * hd) != (wq.shape[-1], wk.shape[-1]):
        raise ValueError(f"attention weights {tuple(wq.shape)}, {tuple(wk.shape)} are not "
                         f"{hl} and {kvl} heads of {hd}")
    if split:
        x = par.enter_model(x)
    q = (x @ wq).reshape(b, s, hl, hd)
    k = (x @ wk).reshape(b, s, kvl, hd)
    v = (x @ wv).reshape(b, s, kvl, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, wo, split


def attention_out(out: torch.Tensor, wo: torch.Tensor, split: bool) -> torch.Tensor:
    """The output projection of attention's (B, S, H', hd) result: on a
    grid the row-parallel product, its partial sums added over the model
    row in f32 (``parallel.row_parallel``)."""
    b, s = out.shape[:2]
    y = out.reshape(b, s, -1)
    return par.row_parallel(y, wo) if split else y @ wo


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
    cache, one token is written to it and attends to it.  On a grid every
    route runs over this rank's heads (``attention_qkv``) and the cache
    holds them."""
    s = x.shape[1]
    q, k, v, wo, split = attention_qkv(p, x, positions, cfg)
    heads = q.shape[2]

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
                q, attn_lib.repeat_kv(k, heads), attn_lib.repeat_kv(v, heads),
                chunk_size=min(cfg.attn_chunk, s), window=window
            )
        new_cache = None
    else:
        cache = attn_lib.cache_update(cache, k, v)
        out = attn_lib.decode_attention(q, cache, num_heads=heads, window=window)
        new_cache = cache
    return attention_out(out, wo, split), new_cache


# ---------------------------------------------------------------- mlp / moe

def init_ffn_params(draw: GenDraw, cfg: ModelConfig) -> Params:
    """The SwiGLU FFN's weights, or with ``cfg.num_experts`` the MoE's: a
    router (d, E) in f32 whatever the model's dtype, as in the reference,
    and expert weights (E, d, f), (E, f, d) drawn one expert at a time
    (a whole stacked expert tensor drawn in f32 would need, for
    Phi-3.5-MoE at full width, 40 GB beside the weights)."""
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    if cfg.num_experts:
        e = cfg.num_experts
        kr, kg, ku, kd = draw.split(4)
        return {
            "router": kr.dense((d, e), torch.float32),
            "wg": kg.dense((e, d, f), dt, by_slice=True),
            "wu": ku.dense((e, d, f), dt, by_slice=True),
            "wd": kd.dense((e, f, d), dt, by_slice=True),
        }
    kg, ku, kd = draw.split(3)
    return {
        "wg": kg.dense((d, f), dt),
        "wu": ku.dense((d, f), dt),
        "wd": kd.dense((f, d), dt),
    }


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, moe_aux_loss); the aux loss is 0 without experts.
    On a grid the weights are this rank's shards: the MoE takes
    ``moe_ffn_parallel`` (its aux loss averaged over the data rows), the
    SwiGLU gathers its FSDP rows and runs column- then row-parallel where
    d_ff splits over the model row."""
    grid = par.current_grid()
    if cfg.num_experts:
        fn = moe_lib.moe_ffn if grid is None else functools.partial(
            moe_lib.moe_ffn_parallel, d_ff=cfg.d_ff)
        out, stats = fn(x, p["router"], p["wg"], p["wu"], p["wd"],
                        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        return out, stats.aux_loss
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    wg, wu, wd = (par.fsdp(p[n], n, cfg.d_model) for n in ("wg", "wu", "wd"))
    return swiglu(x, wg, wu, wd, model_split=par.model_split(wd.shape[-2], cfg.d_ff)), aux


# ------------------------------------------------------- transformer layer

def init_transformer_layer(draw: GenDraw, cfg: ModelConfig) -> Params:
    """One layer's parameters (a stack of them from a stacked draw, e.g.
    ``GenDraw(gen).layers(L)``)."""
    d, dt = cfg.d_model, cfg.torch_dtype
    k_attn, k_ffn = draw.split(2)
    return {
        "ln1": draw.ones((d,), dt),
        "ln2": draw.ones((d,), dt),
        "attn": init_attn_params(k_attn, cfg),
        "ffn": init_ffn_params(k_ffn, cfg),
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
    if cfg.d_ff or cfg.num_experts:
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
    the kernel takes only chunks that are multiples of 16.

    On a grid the layer runs this rank's block of di / model channels and
    H / model heads (``repro`` constrains ``xs`` and ``z`` on "tensor"):
    ``in_x`` and ``in_z`` column-parallel, B and C whole (their gradient
    summed over the row by ``enter_model``), dt, A, ``conv_b`` and ``gn``
    sliced to this rank's heads and channels, the gated norm over all di
    (``rms_norm_split``) and ``out`` row-parallel; the state holds this
    rank's heads and channels."""
    b, s, _ = x.shape
    di, ds = cfg.d_inner_eff, cfg.ssm_state
    dh = di // cfg.ssm_heads
    res = x
    xn = rms_norm(x, p["ln"])
    in_x, in_z, in_b, in_c, in_dt, w_out = (
        par.fsdp(p[n], n, cfg.d_model) for n in ("in_x", "in_z", "in_b", "in_c", "in_dt", "out"))
    dl = in_x.shape[-1]
    split = par.model_split(dl, di)
    h_heads = local_units(cfg, cfg.ssm_heads, dl, di)
    xin = par.enter_model(xn) if split else xn
    xs = xin @ in_x
    z = xin @ in_z
    bm = xn @ in_b
    cm = xn @ in_c
    dt = torch.nn.functional.softplus((xn @ in_dt).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    conv_b, gn = p["conv_b"], p["gn"]
    if split:
        # Every rank's heads read B and C whole; dt, A, conv_b and gn
        # are cut to this rank's heads and channels.
        bm, cm = par.enter_model(torch.stack([bm, cm])).unbind(0)
        dt, a = par.slice_model(dt, -1), par.slice_model(a, -1)
        conv_b, gn = par.slice_model(torch.stack([conv_b, gn]), -1).unbind(0)

    if state is not None and s == 1:
        xs, conv_new = ssm_lib.causal_conv1d(xs, p["conv_w"], conv_b, state.conv)
        y, h_new = ssm_lib.ssm_decode_step(
            xs.reshape(b, h_heads, dh), dt[:, 0], a, bm[:, 0], cm[:, 0], state.h
        )
        y = y.reshape(b, 1, dl)
        new_state = ssm_lib.SSMState(h=h_new, conv=conv_new)
    else:
        xs, conv_new = ssm_lib.causal_conv1d(xs, p["conv_w"], conv_b)
        chunk = min(cfg.ssm_chunk, round_up(s, 16))
        pad = (-s) % chunk
        if pad:
            # dt = 0 on padded steps: no decay (a = 1), no input contribution.
            xs, dt, bm, cm = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (xs, dt, bm, cm))
        x4 = xs.reshape(b, s + pad, h_heads, dh)
        if cfg.use_pallas_kernels and state is None:
            y, h_new = ssm_scan(x4, dt, a, bm, cm, chunk=chunk)
        else:
            h0 = torch.zeros((b, h_heads, dh, ds), dtype=torch.float32, device=x.device)
            y, h_new = ssm_lib.chunked_ssm_scan(x4, dt, a, bm, cm, h0, chunk=chunk)
        y = y[:, :s].reshape(b, s, dl)
        new_state = ssm_lib.SSMState(h=h_new, conv=conv_new) if state is not None else None
    y = rms_norm_split(y * torch.nn.functional.silu(z), gn, di)
    return res + (par.row_parallel(y, w_out) if split else y @ w_out), new_state


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
    takes only chunks that are multiples of 16.

    On a grid the layer runs this rank's H / model heads (``repro``
    constrains q, k and v on "tensor"): ``wq``, ``wk`` and ``wv``
    column-parallel, the replicated gate projections' pre-activations
    sliced to this rank's heads, the norm over all h * hd
    (``rms_norm_split``) and ``out`` row-parallel; the state holds this
    rank's heads."""
    b, s, _ = x.shape
    hd, width = cfg.hd, cfg.num_heads * cfg.hd
    res = x
    xn = rms_norm(x, p["ln"])
    wq, wk, wv, wi, wf, w_out = (
        par.fsdp(p[n], n, cfg.d_model) for n in ("wq", "wk", "wv", "wi", "wf", "out"))
    split = par.model_split(wq.shape[-1], width)
    h = local_units(cfg, cfg.num_heads, wq.shape[-1], width)
    xin = par.enter_model(xn) if split else xn
    q = (xin @ wq).reshape(b, s, h, hd)
    k = (xin @ wk).reshape(b, s, h, hd)
    v = (xin @ wv).reshape(b, s, h, hd)
    i_pre = xn.float() @ wi
    f_pre = xn.float() @ wf + 3.0
    gn = p["gn"]
    if split:
        i_pre, f_pre = par.slice_model(torch.stack([i_pre, f_pre]), -1).unbind(0)
        gn = par.slice_model(gn, -1)

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
    y = rms_norm_split(y, gn, width)
    return res + (par.row_parallel(y, w_out) if split else y @ w_out), new_state


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
    no state was given).

    On a grid ``wx``'s columns split in contiguous blocks of the four
    gates [z, i, f, o] (a rank of a row of 2 holds [z, i] or [f, o]), the
    one layout the planner reads; the gate pre-activations are gathered
    over the row (the gradient reduce-scattered back), each rank runs the
    recurrence over its H / model heads, their columns of every gate, with
    its block of ``rw`` and a (B, d / model) state, the norm over all d
    (``rms_norm_split``) and ``out`` row-parallel (its rows are the heads'
    channels)."""
    b, s, d = x.shape
    res = x
    xn = rms_norm(x, p["ln"])
    wx, w_out = par.fsdp(p["wx"], "wx", d), par.fsdp(p["out"], "out", d)
    rw, gn = p["rw"], p["gn"]
    if par.model_split(wx.shape[-1], 4 * d):
        grid = par.current_grid()
        dl = wx.shape[-1] // 4
        heads = local_units(cfg, cfg.num_heads, dl, d)
        if not par.model_split(w_out.shape[-2], d):
            raise ValueError(f"{cfg.name}: the sLSTM's wx splits over the model row but its "
                             "out does not")
        gates = par.gather_model(par.enter_model(xn) @ wx, -1, scatter=True)
        lo = grid.model_index * dl
        x_gates = gates.reshape(b, s, 4, d)[..., lo:lo + dl].reshape(b, s, 4 * dl)
        rw, gn = par.slice_model(rw, 1), par.slice_model(gn, -1)
    else:
        dl, heads, x_gates = d, cfg.num_heads, xn @ wx
    st0 = state if state is not None else xlstm_lib.init_slstm_state(b, dl, device=x.device)
    hs, new_state = xlstm_lib.slstm_scan(x_gates, rw, st0, heads)
    y = rms_norm_split(hs.to(x.dtype), gn, d)
    y = par.row_parallel(y, w_out) if dl != d else y @ w_out
    return res + y, new_state if state is not None else None
