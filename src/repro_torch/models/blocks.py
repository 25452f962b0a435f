"""Parameter init and application of the per-layer blocks.

Port of the attention, FFN and transformer-layer part of
``repro/models/blocks.py``.  Parameters are plain dicts of tensors with
the reference's names; an init function given ``stack=(L,)`` draws L
layers at once, stacked on a leading axis as the reference's vmapped init
stacks them.  The MoE FFN and the Mamba2, mLSTM and sLSTM layers are not
ported yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.layers import dense_init, rms_norm
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
    exact causal (sliding-window) attention as the chunked path.  With a
    cache, one token is written to it and attends to it."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        kr = attn_lib.repeat_kv(k, cfg.num_heads)
        vr = attn_lib.repeat_kv(v, cfg.num_heads)
        if cfg.use_pallas_kernels:
            out = flash_attention(
                q.transpose(1, 2).contiguous(),
                kr.transpose(1, 2).contiguous(),
                vr.transpose(1, 2).contiguous(),
                window=window,
            ).transpose(1, 2)
        else:
            out = attn_lib.chunked_causal_attention(
                q, kr, vr, chunk_size=min(cfg.attn_chunk, s), window=window
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


# ------------------------------------------------- layers not ported yet

def init_mamba_layer(gen, cfg):
    raise unported("the Mamba2 layer", "item 10")


def apply_mamba_layer(p, x, cfg, state):
    raise unported("the Mamba2 layer", "item 10")


def init_mlstm_layer(gen, cfg):
    raise unported("the mLSTM layer", "item 11")


def apply_mlstm_layer(p, x, cfg, state):
    raise unported("the mLSTM layer", "item 11")


def init_slstm_layer(gen, cfg):
    raise unported("the sLSTM layer", "item 11")


def apply_slstm_layer(p, x, cfg, state):
    raise unported("the sLSTM layer", "item 11")
