"""Decoder-only transformer: the dense and sliding-window (SWA) family.

Port of ``repro/models/transformer.py`` for ``family == "dense"``.
Parameters are a dict of tensors with the reference's names and layout:
per-layer weights stacked on a leading L axis (``params["layers"]``), so
``convert.transformer_params_from_numpy`` carries ``repro``'s params
across unchanged.  The layer scan becomes a Python loop.  ``forward`` is
the full-sequence pass that scores a batch (through the flash_attention
op when ``cfg.use_pallas_kernels``); ``prefill`` and ``decode_step`` take
the plain chunked and decode attention, as the reference routes them.
Remat settings shape only a backward pass, which this inference slice
does not have.  The VLM, audio and MoE branches raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.layers import dense_init, embed_init, embed_lookup, rms_norm
from repro_torch.nn.rope import apply_rope

Params = dict[str, Any]


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: index the leading L axis of every leaf."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


class TransformerModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense" or cfg.num_experts:
            raise blocks.unported(f"the {cfg.family!r} transformer family", "item 12")
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Params:
        """Seeded random parameters on the generator's device."""
        cfg = self.cfg
        v, d = cfg.padded_vocab, cfg.d_model
        return {
            "layers": blocks.init_transformer_layer(gen, cfg, stack=(cfg.num_layers,)),
            "ln_f": torch.ones((d,), dtype=cfg.torch_dtype, device=gen.device),
            "embed": embed_init(gen, v, d, cfg.torch_dtype),
            "head": dense_init(gen, (d, v), cfg.torch_dtype),
        }

    # -------------------------------------------------------------- embed
    def _embed(self, params: Params, batch: dict) -> torch.Tensor:
        return embed_lookup(params["embed"], batch["tokens"])

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, params["ln_f"]) @ params["head"]

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits, moe_aux)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        auxs = []
        for i in range(cfg.num_layers):
            x, _, aux = blocks.apply_transformer_layer(
                layer_params(params["layers"], i), x, positions, cfg, None
            )
            auxs.append(aux)
        return self._head(params, x), torch.stack(auxs).mean()

    # ------------------------------------------------------------ prefill
    def prefill(self, params: Params, batch: dict, max_len: int | None = None):
        """Forward + collect the rotated KV into a decode cache sized for
        ``max_len`` total positions (defaults to the prompt length).
        Returns (logits of the last position, cache)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        window = cfg.window if cfg.attention == "swa" else None
        ks, vs = [], []
        for i in range(cfg.num_layers):
            layer_p = layer_params(params["layers"], i)
            h, (k, v) = _attention_collect_kv(layer_p, x, positions, cfg, window)
            x = x + h
            f, _ = blocks.apply_ffn(layer_p["ffn"], rms_norm(x, layer_p["ln2"]), cfg)
            if cfg.d_ff:
                x = x + f
            ks.append(k)
            vs.append(v)
        cache = _kv_to_cache((torch.stack(ks), torch.stack(vs)), s, cfg, max_len=max_len)
        return self._head(params, x[:, -1:, :]), cache

    def init_cache(self, batch_size: int, max_len: int, device=None) -> attn_lib.KVCache:
        """An empty stacked cache: k, v (L, B, slots, KVH, hd), index (L,)."""
        cfg = self.cfg
        slots = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch_size, slots, cfg.num_kv_heads, cfg.hd)
        return attn_lib.KVCache(
            k=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            index=torch.zeros((cfg.num_layers,), dtype=torch.int32, device=dev),
        )

    def decode_step(self, params: Params, batch: dict, cache: attn_lib.KVCache):
        """One-token step.  batch['tokens']: (B, 1); the position comes
        from the cache index.  Writes the token's KV into ``cache`` in
        place and returns (logits, cache with index + 1)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = cache.index[:1]  # (1,), the same for all layers
        for i in range(cfg.num_layers):
            layer_cache = attn_lib.KVCache(k=cache.k[i], v=cache.v[i], index=cache.index[i])
            x, _, _ = blocks.apply_transformer_layer(
                layer_params(params["layers"], i), x, positions, cfg, layer_cache
            )
        # Every layer's index advanced by one token.
        new_cache = attn_lib.KVCache(k=cache.k, v=cache.v, index=cache.index + 1)
        return self._head(params, x), new_cache


def _attention_collect_kv(layer_p, x, positions, cfg, window):
    """Attention that also returns the rotated (k, v) for cache building.
    Always the plain chunked attention, as the reference's prefill."""
    p = layer_p["attn"]
    b, s, _ = x.shape
    hd = cfg.hd
    xn = rms_norm(x, layer_p["ln1"])
    q = (xn @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (xn @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (xn @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attn_lib.chunked_causal_attention(
        q,
        attn_lib.repeat_kv(k, cfg.num_heads),
        attn_lib.repeat_kv(v, cfg.num_heads),
        chunk_size=min(cfg.attn_chunk, s),
        window=window,
    )
    y = out.reshape(b, s, cfg.num_heads * hd) @ p["wo"]
    return y, (k, v)


def _kv_to_cache(kv_stack, seq_len: int, cfg: ModelConfig, max_len: int | None = None):
    """(L, B, S, KVH, hd) k/v -> decode cache with room for ``max_len``
    total positions.  When the prompt is longer than a sliding window's
    slots, the last ``slots`` tokens are kept, each at slot pos % slots:
    the ring layout ``cache_update`` continues."""
    k, v = kv_stack
    total = max(max_len or seq_len, seq_len)
    slots = min(total, cfg.window) if cfg.attention == "swa" else total
    if slots < seq_len:
        pos = torch.arange(seq_len - slots, seq_len, device=k.device)
        slot_idx = torch.remainder(pos, slots)
        last, lastv = k[:, :, seq_len - slots:], v[:, :, seq_len - slots:]
        k = torch.zeros_like(last).index_copy_(2, slot_idx, last)
        v = torch.zeros_like(lastv).index_copy_(2, slot_idx, lastv)
    elif slots > seq_len:
        pad = (0, 0, 0, 0, 0, slots - seq_len)   # dim 2 of (L, B, S, KVH, hd)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    index = torch.full((k.shape[0],), seq_len, dtype=torch.int32, device=k.device)
    return attn_lib.KVCache(k=k, v=v, index=index)
