"""Zamba2-style hybrid: a Mamba2 backbone with a single *shared* attention
block (weight-tied) invoked after every ``shared_attn_period`` Mamba
layers (arXiv:2411.15242).

Port of ``repro/models/hybrid_model.py``.  Parameters keep the
reference's names and layout: the Mamba weights stacked on leading
(num_periods, per_period) axes, ``shared_attn`` one transformer-layer
dict, so ``convert.hybrid_params_from_numpy`` carries ``repro``'s params
across unchanged.  The two ``lax.scan``s (periods, Mamba layers within a
period) become Python loops.  ``forward`` is the full-sequence scoring
pass (through the ``ssm_scan`` and ``flash_attention`` ops when
``cfg.use_pallas_kernels``, which only inference may set); ``prefill``
and ``decode_step`` take the plain chunked scan, the decode recurrence and
the plain attention, as the reference routes them.  When autograd records,
``cfg.remat`` recomputes each period (its Mamba layers and the shared
block) in the backward pass, and the shared block's gradient sums over
its calls.  There is one KV cache per shared-attention call, stacked on a
leading num_periods axis.

On a (data, model) grid of ranks (``sharding/parallel.use_grid``) the
same methods run one rank's share on its shard of the parameters: the
embedding and head vocab-parallel (``transformer.embed_tokens``,
``head_logits``), each Mamba2 layer over this rank's heads and channels
(``blocks.apply_mamba_layer``), the shared block over its attention
heads and FFN slice; the cache holds this rank's states, conv inputs and
KV heads.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    _attention_collect_kv,
    _kv_to_cache,
    embed_tokens,
    head_logits,
    layer_views,
    remat,
)
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn.layers import GenDraw, dense_init, embed_init, rms_norm

Params = dict[str, Any]


class HybridCache(NamedTuple):
    ssm: ssm_lib.SSMState      # h (P, per, B, H, dh, ds) f32; conv (P, per, B, ker-1, di)
    attn: attn_lib.KVCache     # k, v (P, B, slots, KVH, hd); index (P,)


class HybridModel:
    def __init__(self, cfg: ModelConfig):
        period = cfg.shared_attn_period
        if cfg.family != "hybrid" or not period or cfg.num_layers % period:
            raise ValueError(
                f"HybridModel needs family 'hybrid' and num_layers a multiple of "
                f"shared_attn_period, got {cfg.family!r}, {cfg.num_layers} and {period}"
            )
        self.cfg = cfg
        self.num_periods = cfg.num_layers // period
        self.per_period = period

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Params:
        """Seeded random parameters on the generator's device."""
        cfg = self.cfg
        v, d = cfg.padded_vocab, cfg.d_model
        return {
            "embed": embed_init(gen, v, d, cfg.torch_dtype),
            "mamba": blocks.init_mamba_layer(gen, cfg, stack=(self.num_periods, self.per_period)),
            "shared_attn": blocks.init_transformer_layer(GenDraw(gen), cfg),   # ONE copy
            "ln_f": torch.ones((d,), dtype=cfg.torch_dtype, device=gen.device),
            "head": dense_init(gen, (d, v), cfg.torch_dtype),
        }

    def mamba_layers(self, params: Params) -> list[list[Params]]:
        """Views of the Mamba layers, indexed [period][layer]."""
        return [layer_views(p, self.per_period)
                for p in layer_views(params["mamba"], self.num_periods)]

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return head_logits(params, x, self.cfg)

    def _local(self) -> tuple[int, int]:
        """(SSM heads, inner channels) of this rank: its block of
        ``in_x``'s channels as the spec tree cuts them, and their heads."""
        cfg = self.cfg
        dl = blocks.local_block(cfg, "mamba", "in_x")
        return blocks.local_units(cfg, cfg.ssm_heads, dl, cfg.d_inner_eff), dl

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits, 0): no MoE term."""
        cfg = self.cfg
        x = embed_tokens(params, batch["tokens"], cfg)
        positions = torch.arange(x.shape[1], device=x.device)

        def period_body(x, mamba, shared):
            for mp in mamba:
                x, _ = blocks.apply_mamba_layer(mp, x, cfg, None)
            x, _, _ = blocks.apply_transformer_layer(shared, x, positions, cfg, None)
            return x

        run = remat(period_body, cfg)
        for mamba in self.mamba_layers(params):
            x = run(x, mamba, params["shared_attn"])
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------ prefill
    def init_cache(self, batch_size: int, max_len: int, device=None) -> HybridCache:
        """An empty cache: zero SSM states and conv inputs for every Mamba
        layer, and one KV cache of min(max_len, window) slots (SWA) per
        shared-attention call; on a grid of this rank's heads, channels and
        KV heads, B its data row's."""
        cfg = self.cfg
        dev = resolve_device(device)
        heads, dl = self._local()
        pm = (self.num_periods, self.per_period, batch_size)
        ssm = ssm_lib.SSMState(
            h=torch.zeros(pm + (heads, cfg.d_inner_eff // cfg.ssm_heads, cfg.ssm_state),
                          dtype=torch.float32, device=dev),
            conv=torch.zeros(pm + (cfg.conv_kernel - 1, dl), dtype=cfg.torch_dtype, device=dev),
        )
        slots = min(max(max_len, 1), cfg.window) if cfg.attention == "swa" else max(max_len, 1)
        shape = (self.num_periods, batch_size, slots, blocks.local_heads(cfg)[1], cfg.hd)
        attn = attn_lib.KVCache(
            k=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            index=torch.zeros((self.num_periods,), dtype=torch.int32, device=dev),
        )
        return HybridCache(ssm=ssm, attn=attn)

    def prefill(self, params: Params, batch: dict, max_len: int | None = None):
        """The stateful full-sequence pass: each Mamba layer's final state
        and last conv inputs, and the shared attention's rotated KV, are
        collected into a decode cache with room for ``max_len`` total
        positions (defaults to the prompt length).  Returns (logits of the
        last position, cache)."""
        cfg = self.cfg
        x = embed_tokens(params, batch["tokens"], cfg)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)
        window = cfg.window if cfg.attention == "swa" else None
        heads, dl = self._local()
        # The zero state each layer starts from; only an S = 1 prompt reads it.
        zero = ssm_lib.SSMState(
            h=torch.zeros((b, heads, cfg.d_inner_eff // cfg.ssm_heads, cfg.ssm_state),
                          dtype=torch.float32, device=x.device),
            conv=torch.zeros((b, cfg.conv_kernel - 1, dl), dtype=x.dtype, device=x.device),
        )
        shared = params["shared_attn"]
        mamba = self.mamba_layers(params)
        hs, convs, ks, vs = [], [], [], []
        for i in range(self.num_periods):
            for j in range(self.per_period):
                x, st = blocks.apply_mamba_layer(mamba[i][j], x, cfg, zero)
                hs.append(st.h)
                convs.append(st.conv)
            h, (k, v) = _attention_collect_kv(shared, x, positions, cfg, window)
            x = x + h
            f, _ = blocks.apply_ffn(shared["ffn"], rms_norm(x, shared["ln2"]), cfg)
            x = x + f
            ks.append(k)
            vs.append(v)
        pm = (self.num_periods, self.per_period)
        ssm = ssm_lib.SSMState(
            h=torch.stack(hs).reshape(pm + hs[0].shape),
            conv=torch.stack(convs).reshape(pm + convs[0].shape),
        )
        attn = _kv_to_cache((torch.stack(ks), torch.stack(vs)), s, cfg, max_len=max_len)
        return self._logits(params, x[:, -1:]), HybridCache(ssm=ssm, attn=attn)

    # ------------------------------------------------------------- decode
    def decode_step(self, params: Params, batch: dict, cache: HybridCache):
        """One-token step.  batch['tokens']: (B, 1); the position comes
        from the cache index.  Writes every Mamba layer's new state and
        conv inputs and the token's KV into ``cache`` in place and returns
        (logits, cache with index + 1)."""
        cfg = self.cfg
        x = embed_tokens(params, batch["tokens"], cfg)
        positions = cache.attn.index[:1]        # (1,), the same for every call
        ssm = cache.ssm
        mamba = self.mamba_layers(params)
        for i in range(self.num_periods):
            for j in range(self.per_period):
                st = ssm_lib.SSMState(h=ssm.h[i, j], conv=ssm.conv[i, j])
                x, st = blocks.apply_mamba_layer(mamba[i][j], x, cfg, st)
                ssm.h[i, j].copy_(st.h)
                ssm.conv[i, j].copy_(st.conv)
            a_st = attn_lib.KVCache(k=cache.attn.k[i], v=cache.attn.v[i],
                                    index=cache.attn.index[i])
            x, _, _ = blocks.apply_transformer_layer(params["shared_attn"], x, positions, cfg,
                                                     a_st)
        attn = attn_lib.KVCache(k=cache.attn.k, v=cache.attn.v, index=cache.attn.index + 1)
        return self._logits(params, x), HybridCache(ssm=ssm, attn=attn)
